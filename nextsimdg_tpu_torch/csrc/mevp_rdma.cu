// One ghost-zone round of CG1 mEVP on a rank block whose halo strips
// travel while the interior computes: the two kernels of the round.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma, which in one
// kernel stages h-wide strips, sends them to the neighbour chips by remote
// DMA, runs n_sub <= h subcycles on the whole local block with zero ghosts
// while they fly, then re-runs the subcycles on the edge bands with the
// received ghosts and patches the block's edge rows and columns (x first;
// the y strips carry the x ghosts, and so the corners, and the y bands
// patch last). On Hopper the transfer is no kernel: it is a device copy on
// the receiving rank's copy stream (parallel/exchange.py), and the interior
// pass is mevp_tiled on the block. What is left is here:
//
//   rdma_stage: packs a rank's send strips, in one launch, into a
//               (2, 5, ., .) buffer (lo, hi): along x its first and last h
//               rows; along y its first and last h columns, extended above
//               and below by the x ghosts it received (zeros at a closed
//               global wall), so that the y neighbours receive the corners
//               of their diagonal neighbours.
//   rdma_band:  n_sub subcycles on the two edge bands of one axis (blockIdx.z
//               picks lo or hi), in ghost-zone tiles along the band's long
//               axis (the window covers the band's 3h cells across whole,
//               with one cell of zero padding either side). Each block
//               assembles its window in shared memory straight from the
//               round's sources: the rank's pre-round planes (mevp_tiled
//               wrote the interior pass into fresh planes, so these are
//               intact), the received x ghosts and, for the y bands, the
//               received y ghosts; the consts are read by offset from the
//               rank's widened const planes. Nothing is copied per round. It
//               writes only the band's patch rows (x) or columns (y) into
//               the state after the interior pass.
//
// The sources are addressed in the coordinates of the rank's widened block
// E: (nx + 2hx) x (ny + 2hy), the own block at (hx, hy), hx = h when the x
// axis is split over ranks (else 0), hy likewise. An x band is E's rows
// [0, 3h) or [nx - h, nx + 2h) over the own columns; a y band is E's
// columns [0, 3h) or [ny - h, ny + 2h) over all of E's rows. A band is
// closed: a read beyond it is a zero, as in the TPU kernel's band arrays.
//
// The subcycles run window_subcycles of mevp_window.cuh, the loop and the
// bodies of mevp_tiled, so a round equals the blocked exchange's round
// (mevp_tiled on the widened block) and the single-device schedule bit for
// bit: the ring argument of the TPU kernel holds unchanged (each subcycle
// spoils one ring; n_sub <= h, nx, ny >= 2h).
//
// What bounds it on the H100: a band holds 3h x ny cells (x) or 3h x
// (nx + 2h) (y); at h = 16 and a 2048^2 block the four bands are ~9% of the
// block's cells, and rdma_band's tiles along the long axis redo
// (T + 2 n_sub) / T of them. Like mevp_tiled it is bound by the window's
// arithmetic and shared-memory traffic, not by the bytes it moves (the
// strips and the patches are ~1% of the state); rdma_stage moves
// 2 x 5 x h x (ny or nx + 2h) floats (2.6 MB for the x strips of a 2048^2
// block at h = 16), one float4 a thread along the rows, and is bound by its
// launch and its wrapper's host path (mevp_rdma_cuda.RoundSources builds
// and checks the round's pointer arrays once).
#include <cstdint>
#include <cstring>

#include "mevp_window.cuh"

namespace nst {

constexpr int kRdmaPlanes = 5;  // u, v, s11, s22, s12
constexpr int kRdmaMaxThreads = 1024;

// The round's sources in E's coordinates (see the file comment).
struct RdmaSources {
  const float* own[kRdmaPlanes];  // the pre-round (nx, ny) planes
  const float* gx_lo;             // (5, h, ny): E rows [0, hx), columns [hy, hy + ny)
  const float* gx_hi;             // (5, h, ny): E rows [hx + nx, nx + 2hx)
  const float* gy_lo;             // (5, nx + 2hx, h): E columns [0, hy), all rows
  const float* gy_hi;             // (5, nx + 2hx, h): E columns [hy + ny, ny + 2hy)
  int nx, ny, h, hx, hy;
};

// Plane k of E at (r, c), or 0 where no source covers it.
__device__ __forceinline__ float load_e(const RdmaSources& src, int k, int r, int c) {
  const int nxe = src.nx + 2 * src.hx;
  const int jc = c - src.hy;
  if (jc < 0) {
    return src.gy_lo != nullptr ? src.gy_lo[(k * nxe + r) * src.h + c] : 0.0f;
  }
  if (jc >= src.ny) {
    return src.gy_hi != nullptr ? src.gy_hi[(k * nxe + r) * src.h + jc - src.ny] : 0.0f;
  }
  const int ir = r - src.hx;
  if (ir < 0) {
    return src.gx_lo[(k * src.h + r) * src.ny + jc];
  }
  if (ir >= src.nx) {
    return src.gx_hi[(k * src.h + ir - src.nx) * src.ny + jc];
  }
  return src.own[k][ir * src.ny + jc];
}

// The band pair of one launch. Band cell (i, j), i < rows, j < cols, is E
// cell (r0[z] + i, c0[z] + j); its patch is the band cells [pr0, pr0 + prn)
// x [pc0, pc0 + pcn), written to the own cell (E row - hx, E column - hy).
struct RdmaBands {
  int rows, cols;
  int r0[2], c0[2];
  int pr0, prn, pc0, pcn;
  int long_axis;  // 0: tiles run along the rows (y bands), 1: along the columns (x bands)
};

// Row r of strip plane k on `side` (0: lo, 1: hi): the source row and the
// strip row it is copied to, `len` floats each. x: own rows [0, h) or
// [nx - h, nx); y: E's rows (the x ghosts above and below the own rows),
// own columns [0, h) or [ny - h, ny).
__device__ __forceinline__ const float* stage_source(const RdmaSources& src, int axis, int side,
                                                     int k, int r) {
  const float* own = src.own[0];
#pragma unroll
  for (int p = 1; p < kRdmaPlanes; ++p) own = k == p ? src.own[p] : own;
  if (axis == 0) return own + (r + (side ? src.nx - src.h : 0)) * src.ny;
  const int col = side ? src.ny - src.h : 0;
  const int ir = r - src.hx;
  if (ir < 0) return src.gx_lo + (k * src.h + r) * src.ny + col;
  if (ir >= src.nx) return src.gx_hi + (k * src.h + ir - src.nx) * src.ny + col;
  return own + ir * src.ny + col;
}

// A 3-D grid: z = side x plane (10), y x blockDim.y = strip rows, x x
// blockDim.x = the row's floats (kVec: float4s). No division by a run-time
// value.
template <bool kVec>
__global__ void __launch_bounds__(kRdmaMaxThreads)
rdma_stage_kernel(RdmaSources src, int axis, int rows, int len, float* __restrict__ out) {
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.z;
  const int side = z / kRdmaPlanes, k = z - side * kRdmaPlanes;
  if (r >= rows || x >= (kVec ? len / 4 : len)) return;
  const float* from = stage_source(src, axis, side, k, r);
  float* to = out + (z * rows + r) * len;
  if (kVec) {
    reinterpret_cast<float4*>(to)[x] = __ldg(reinterpret_cast<const float4*>(from) + x);
  } else {
    to[x] = from[x];
  }
}

__global__ void __launch_bounds__(kRdmaMaxThreads)
rdma_band_kernel(RdmaSources src, RdmaBands bands, MevpConsts k, int ld, int tile, int n_sub,
                 float* u, float* v, float* s11, float* s22, float* s12, MevpScalars s) {
  extern __shared__ float smem[];
  const int z = blockIdx.z;
  // The window: tiles of `tile` cells with a halo of n_sub along the long
  // axis, the whole band plus one cell of padding across it.
  Window w;
  w.nx = bands.rows;
  w.ny = bands.cols;
  if (bands.long_axis == 0) {
    w.wa = tile + 2 * n_sub;
    w.i0 = blockIdx.x * tile - n_sub;
    w.sa = 1;
    w.wb = bands.cols + 2;
    w.j0 = -1;
    w.sb = 0;
  } else {
    w.wa = bands.rows + 2;
    w.i0 = -1;
    w.sa = 0;
    w.wb = tile + 2 * n_sub;
    w.j0 = blockIdx.x * tile - n_sub;
    w.sb = 1;
  }
  const int r0 = bands.r0[z], c0 = bands.c0[z];
  const int plane = w.wa * w.wb;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const float inv_wb = 1.0f / static_cast<float>(w.wb);
  for (int idx = tid; idx < plane; idx += n_threads) {
    const int a = region_row(idx, inv_wb), b = idx - a * w.wb;
    const int i = w.i0 + a, j = w.j0 + b;
    const bool inside = i >= 0 && i < w.nx && j >= 0 && j < w.ny;
#pragma unroll
    for (int p = 0; p < kRdmaPlanes; ++p) {
      smem[p * plane + idx] = inside ? load_e(src, p, r0 + i, c0 + j) : 0.0f;
    }
  }
  __syncthreads();

  const ConstView cv = {k, ld, r0, c0};
  window_subcycles<false>(smem, w, cv, n_sub, s);

  // Write the patch cells of this tile's own stretch of the long axis.
  float* out[kRdmaPlanes] = {u, v, s11, s22, s12};
  const int own_a = bands.long_axis == 0 ? tile : w.wa - 2;
  const int own_b = bands.long_axis == 0 ? w.wb - 2 : tile;
  const int a0 = bands.long_axis == 0 ? n_sub : 1;
  const int b0 = bands.long_axis == 0 ? 1 : n_sub;
  const float inv_ob = 1.0f / static_cast<float>(own_b);
  for (int idx = tid; idx < own_a * own_b; idx += n_threads) {
    const int da = region_row(idx, inv_ob);
    const int a = a0 + da, b = b0 + idx - da * own_b;
    const int i = w.i0 + a, j = w.j0 + b;
    if (i < bands.pr0 || i >= bands.pr0 + bands.prn || j < bands.pc0 ||
        j >= bands.pc0 + bands.pcn) {
      continue;
    }
    const int own = (r0 + i - src.hx) * src.ny + (c0 + j - src.hy);
    const int c = a * w.wb + b;
#pragma unroll
    for (int p = 0; p < kRdmaPlanes; ++p) out[p][own] = smem[p * plane + c];
  }
}

}  // namespace nst

// Dynamic shared memory of one rdma_band block: 7 planes of its window.
static int rdma_band_shared_bytes(const nst::RdmaBands& bands, int tile, int n_sub) {
  const int along = tile + 2 * n_sub;
  const int across = (bands.long_axis == 0 ? bands.cols : bands.rows) + 2;
  return nst::kMevpSharedPlanes * along * across * static_cast<int>(sizeof(float));
}

extern "C" {

// sources: 9 pointers (the 5 pre-round planes, gx_lo, gx_hi, gy_lo, gy_hi;
// the ghosts of an axis that is not split are null); ints: nx, ny, h, hx, hy.
static nst::RdmaSources rdma_sources(const void* const* sources, const int* dims) {
  nst::RdmaSources src;
  std::memcpy(src.own, sources, sizeof(src.own));
  src.gx_lo = static_cast<const float*>(sources[5]);
  src.gx_hi = static_cast<const float*>(sources[6]);
  src.gy_lo = static_cast<const float*>(sources[7]);
  src.gy_hi = static_cast<const float*>(sources[8]);
  src.nx = dims[0];
  src.ny = dims[1];
  src.h = dims[2];
  src.hx = dims[3];
  src.hy = dims[4];
  return src;
}

// The send strips of `axis` into out: (2, 5, h, ny) for x, (2, 5, nx + 2hx,
// h) for y, in 16-byte vectors where every row starts 16-byte aligned.
// Returns cudaGetLastError(); does not synchronise.
int nst_rdma_stage(const void* const* sources, const int* dims, int axis, float* out,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nst::RdmaSources src = rdma_sources(sources, dims);
  if (src.h < 1 || (axis != 0 && axis != 1) || (axis == 0 && src.hx != src.h) ||
      (axis == 1 && src.hy != src.h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = axis == 0 ? src.h : src.nx + 2 * src.hx;
  const int len = axis == 0 ? src.ny : src.h;
  bool vec = src.ny % 4 == 0 && src.h % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int p = 0; p < 9; ++p) vec = vec && reinterpret_cast<uintptr_t>(sources[p]) % 16 == 0;
  const int per_row = vec ? len / 4 : len;
  // Up to 256 threads along a row (a power of two), the rest of a
  // 256-thread block over rows.
  int bx = 1;
  while (bx < per_row && bx < 256) bx *= 2;
  const dim3 block(bx, 256 / bx);
  const dim3 grid((per_row + bx - 1) / bx, (rows + block.y - 1) / block.y, 2 * nst::kRdmaPlanes);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec) {
    nst::rdma_stage_kernel<true><<<grid, block, 0, s>>>(src, axis, rows, len, out);
  } else {
    nst::rdma_stage_kernel<false><<<grid, block, 0, s>>>(src, axis, rows, len, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// n_sub subcycles on the two bands of `axis` (0: x, 1: y) and their patches
// into the 5 state planes `state` (the interior pass's output). consts: the
// 7 widened const-plane pointers in MevpConsts order, row length ld =
// ny + 2hy. Returns cudaGetLastError() (or the error of the shared-memory
// attribute); does not synchronise.
int nst_rdma_band(const void* const* sources, const int* dims, int axis,
                  const void* const* consts, int tile, int n_sub, int threads,
                  void* const* state, const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nst::RdmaSources src = rdma_sources(sources, dims);
  const int h = src.h;
  if (tile < 1 || n_sub < 1 || n_sub > h || threads < 32 || threads > nst::kRdmaMaxThreads ||
      (axis == 0 && (src.hx != h || src.nx < 2 * h)) ||
      (axis == 1 && (src.hy != h || src.ny < 2 * h)) || (axis != 0 && axis != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::RdmaBands bands;
  if (axis == 0) {  // rows [ghost h | own 2h] over the own columns
    bands.rows = 3 * h;
    bands.cols = src.ny;
    bands.r0[0] = 0;
    bands.r0[1] = src.nx - h;
    bands.c0[0] = bands.c0[1] = src.hy;
    bands.pr0 = h;
    bands.prn = h;
    bands.pc0 = 0;
    bands.pcn = src.ny;
    bands.long_axis = 1;
  } else {  // columns [ghost h | own 2h] over all of E's rows
    bands.rows = src.nx + 2 * src.hx;
    bands.cols = 3 * h;
    bands.r0[0] = bands.r0[1] = 0;
    bands.c0[0] = 0;
    bands.c0[1] = src.ny - h;
    bands.pr0 = src.hx;
    bands.prn = src.nx;
    bands.pc0 = h;
    bands.pcn = h;
    bands.long_axis = 0;
  }
  nst::MevpConsts k = {};
  std::memcpy(&k, consts, 7 * sizeof(const float*));
  nst::MevpScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  const int bytes = rdma_band_shared_bytes(bands, tile, n_sub);
  err = cudaFuncSetAttribute(nst::rdma_band_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  const int along = bands.long_axis == 0 ? bands.rows : bands.cols;
  const dim3 grid((along + tile - 1) / tile, 1, 2);
  float* const* out = reinterpret_cast<float* const*>(state);
  const int ld = src.ny + 2 * src.hy;
  nst::rdma_band_kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      src, bands, k, ld, tile, n_sub, out[0], out[1], out[2], out[3], out[4], s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
