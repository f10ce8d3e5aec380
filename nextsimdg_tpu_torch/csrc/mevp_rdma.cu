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
//               picks lo or hi), by clusters of blocks along the band's
//               long axis (cluster_window.cuh): a cluster's window spans
//               the band's 3h cells across and cluster x seg cells along
//               it, each block a seg-cell stretch with a one-cell apron
//               along the band. Each block assembles its region in shared
//               memory straight from the round's sources: the rank's
//               pre-round planes (mevp_tiled wrote the interior pass into
//               fresh planes, so these are intact), the received x ghosts
//               and, for the y bands, the received y ghosts; the consts are
//               read by offset from the rank's widened const planes.
//               Nothing is copied per round. It writes only the band's
//               patch rows (x) or columns (y) into the state after the
//               interior pass.
//
// The sources are addressed in the coordinates of the rank's widened block
// E: (nx + 2hx) x (ny + 2hy), the own block at (hx, hy), hx = h when the x
// axis is split over ranks (else 0), hy likewise. An x band is E's rows
// [0, 3h) or [nx - h, nx + 2h) over the own columns; a y band is E's
// columns [0, 3h) or [ny - h, ny + 2h) over all of E's rows. A band is
// closed: a read beyond it is a zero, as in the TPU kernel's band arrays.
//
// The cone. Only the h patch rows (or columns) of a band are written back,
// and after the subcycles that follow subcycle `sub` they depend on the
// nodes of the patch widened by r = n_sub - 1 - sub on either side and on
// the elements widened by r + 1 before it and r after it (a node reads the
// elements at -1 and 0, an element the nodes at 0 and +1). Subcycle `sub`
// computes those cells only, clipped to the band (the host works them out:
// mevp_rdma_cuda.band_cone); at h = n_sub = 16 that is 31 of the band's 48
// rows on average. Cells outside the cone never reach the patch, so the
// patch is what the whole band's subcycles give. Along the band the ring
// argument holds: each subcycle spoils one ring of the cluster's window,
// and the window's interior is exact after n_sub subcycles.
//
// Each element and node runs mevp_stress_body and mevp_velocity_body of
// mevp_body.cuh with the arguments of mevp_tiled, and each value it keeps
// is computed from the same values as there, so a round equals the blocked
// exchange's round (mevp_tiled on the widened block) and the single-device
// schedule bit for bit (n_sub <= h, nx, ny >= 2h). Like mevp_tiled, a
// thread owns fixed cells and keeps their c_w and inv_drag in registers,
// and the region holds 5 planes.
//
// What bounds it on the H100: the arithmetic of the cone (at h = 16 and a
// 2048^2 block ~1M element-subcycles a band), spread over enough blocks to
// reach every SM (the clusters of a pair of bands number ~2 x 2048 /
// (cluster x seg - 2 n_sub)), plus the ring along the band paid once a
// cluster and the 2 n_sub + 1 cluster barriers (~0.8 us each in clusters
// of 16 on the H100, mevp_large --barriers: ~40% of a launch); not the bytes it
// moves (the strips and the patches are ~1% of the state). rdma_stage moves
// 2 x 5 x h x (ny or nx + 2h) floats (2.6 MB for the x strips of a 2048^2
// block at h = 16), one float4 a thread along the rows, and is bound by its
// launch and its wrapper's host path (mevp_rdma_cuda.RoundSources builds
// and checks the round's pointer arrays once).
#include <cstdint>
#include <cstring>

#include "cluster_window.cuh"
#include "mevp_body.cuh"

namespace nst {

constexpr int kRdmaPlanes = 5;  // u, v, s11, s22, s12
constexpr int kRdmaMaxThreads = 1024;
// rdma_band's launch bound for blocks of up to 256 threads (the shipped
// launch): at least 3 such blocks an SM, so 80 registers a thread and a
// launch of a pair of bands (320 blocks) in one wave. It spills 100-132
// bytes a thread; without spills (139-144 registers) one block fits an SM
// and the launch ran 2x slower, at 128 registers 1.6x, at the 1024-thread
// bound (64 registers, 176-200 bytes of spills) 1.1x (PERF.md). Larger
// blocks get the 1024-thread bound.
constexpr int kRdmaBandThreads = 256;
constexpr int kRdmaBandMinBlocks = 3;
constexpr int kRdmaMaxSub = 64;            // subcycles of one rdma_band launch, at most
constexpr int kRdmaMaxCells = 4;           // cells a thread of rdma_band owns, at most
constexpr int kRdmaMaxClusterBlocks = 16;  // the H100's non-portable cluster size

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

// The per-step const planes of a band: band cell (i, j) reads index
// (i + off_i) * ld + (j + off_j) of each plane (the rank's widened planes,
// at the band's offset).
struct ConstView {
  MevpConsts k;
  int ld, off_i, off_j;
  __device__ __forceinline__ int at(int i, int j) const { return (i + off_i) * ld + (j + off_j); }
};

// The patch's cone, per subcycle of the launch: [lo, hi) of the band's rows
// and columns whose elements (e) and nodes (n) feed the patch after the
// subcycles that follow, clipped to the band; in the order e rows, e
// columns, n rows, n columns (mevp_rdma_cuda.band_cone computes them).
struct RdmaCone {
  int r[kRdmaMaxSub][8];
};

// n_sub subcycles on one band of a pair (blockIdx.z: lo or hi) by clusters
// of blocks along the band's long axis (kAlong 1: along the columns, the x
// bands; 0: along the rows, the y bands). A cluster's window spans the band
// across and `cluster` x `seg` cells along it, n_sub of them at either end
// the ring; block x of the cluster keeps the seg cells from x seg of it,
// with a one-cell apron on either side along the band, in 5 planes of
// shared memory. A thread owns fixed cells for the launch: one position
// along the band (consecutive threads on consecutive positions) and every
// threads / seg-th cell across it, at most 4, so that the cone, which
// narrows across the band, leaves every thread about the same work. It
// keeps their 7 consts, c_w and inv_drag in registers: a subcycle's phase
// reads shared memory and registers only, so its latency is the body's and
// the barrier's. Subcycle `sub` computes the cells of the patch's cone that
// lie inside the window's valid ring; a cell on the block's last (first)
// position along the band pushes its new stresses (velocities) into the
// apron of the next (previous) block of the cluster. kMaxThreads: the
// launch bound, kRdmaBandThreads (kRdmaBandMinBlocks an SM) or
// kRdmaMaxThreads.
template <int kAlong, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads == kRdmaBandThreads ? kRdmaBandMinBlocks : 1)
rdma_band_kernel(RdmaSources src, RdmaBands bands, MevpConsts k, int ld, int seg, int n_sub,
                 RdmaCone cone, float* u, float* v, float* s11, float* s22, float* s12,
                 MevpScalars s) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPos pos = cluster_pos(cluster);
  const int z = blockIdx.z;
  const int r0 = bands.r0[z], c0 = bands.c0[z];
  const int across = kAlong ? bands.rows : bands.cols;
  // Band cell (i, j) is stored row-major in band orientation: x bands
  // `across` rows of seg + 2 cells (the apron at either end); y bands
  // seg + 2 rows of across + 1 cells (one of padding, so that threads on
  // consecutive rows fall in different banks). Position l along the band
  // (-1 and seg: the apron), cell c across it.
  const int pitch = kAlong ? seg + 2 : across + 1;
  const int plane = (kAlong ? across : seg + 2) * pitch;
  const auto cell = [&](int l, int c) { return kAlong ? c * pitch + l + 1 : (l + 1) * pitch + c; };
  float* su = smem;
  float* sv = su + plane;
  float* t11 = sv + plane;
  float* t22 = t11 + plane;
  float* t12 = t22 + plane;
  // The cluster's window along the band: w cells; this block's positions
  // from window index wx0, band index own0.
  const int w = pos.nx * seg;
  const int wx0 = pos.x * seg;
  const int own0 = static_cast<int>(blockIdx.x) / pos.nx * (w - 2 * n_sub) - n_sub + wx0;
  const auto band_ij = [&](int l, int c) {
    return kAlong ? make_int2(c, own0 + l) : make_int2(own0 + l, c);
  };
  const auto in_band = [&](int2 ij) {
    return ij.x >= 0 && ij.x < bands.rows && ij.y >= 0 && ij.y < bands.cols;
  };

  // The load: the region and its apron from the round's sources, zeros
  // beyond the band (and in the padding).
  const int stored = kAlong ? across : seg + 2;
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int e = threadIdx.x; e < stored * pitch; e += blockDim.x) {
    const int row = region_row(e, inv_pitch), col = e - row * pitch;
    const int2 ij = kAlong ? band_ij(col - 1, row) : band_ij(row - 1, col);
    const bool in = in_band(ij) && (kAlong || col < across);
#pragma unroll
    for (int p = 0; p < kRdmaPlanes; ++p) {
      smem[p * plane + e] = in ? load_e(src, p, r0 + ij.x, c0 + ij.y) : 0.0f;
    }
  }

  // This thread owns position l along the band and cells c0 + q stride
  // across it; their consts, 0 beyond the band.
  const int l = threadIdx.x % seg;
  const int c_first = threadIdx.x / seg, stride = blockDim.x / seg;
  const int g = own0 + l;      // band index along
  const int x = wx0 + l;       // window index along
  const int c_end = c_first < stride ? across : 0;  // threads beyond stride x seg own nothing
  const auto owned = [&](auto fn) {
#pragma unroll
    for (int q = 0; q < kRdmaMaxCells; ++q) {
      const int c = c_first + q * stride;
      if (c < c_end) fn(q, c);
    }
  };
  const ConstView cv = {k, ld, r0, c0};
  float strength[kRdmaMaxCells], dt_m[kRdmaMaxCells], active[kRdmaMaxCells],
      uo[kRdmaMaxCells], vo[kRdmaMaxCells], b_u[kRdmaMaxCells], b_v[kRdmaMaxCells];
  owned([&](int q, int c) {
    const int2 ij = band_ij(l, c);
    const bool in = in_band(ij);
    const int at = in ? cv.at(ij.x, ij.y) : 0;
    strength[q] = in ? __ldg(k.strength + at) : 0.0f;
    dt_m[q] = in ? __ldg(k.dt_m + at) : 0.0f;
    active[q] = in ? __ldg(k.active + at) : 0.0f;
    uo[q] = in ? __ldg(k.u_ocean + at) : 0.0f;
    vo[q] = in ? __ldg(k.v_ocean + at) : 0.0f;
    b_u[q] = in ? __ldg(k.b_u + at) : 0.0f;
    b_v[q] = in ? __ldg(k.b_v + at) : 0.0f;
  });
  window_sync(cluster, pos);

  // The cone's ranges along the band are in cr[2 kAlong ..], across it in
  // cr[2 (1 - kAlong) ..] (rows first, then columns; elements, then nodes).
  const int along_e = 2 * kAlong, across_e = 2 * (1 - kAlong);
  float cw[kRdmaMaxCells], inv[kRdmaMaxCells];
  for (int sub = 0; sub < n_sub; ++sub) {
    const int* cr = cone.r[sub];
    // Stress phase: the cone's elements in the window's elements [sub, w - 1 - sub).
    if (g >= cr[along_e] && g < cr[along_e + 1] && x >= sub && x < w - 1 - sub) {
      owned([&](int q, int c) {
        if (c < cr[across_e] || c >= cr[across_e + 1]) return;
        const int e = cell(l, c);
        const StressOut o = mevp_stress_body(
            su[e], su[e + pitch], su[e + 1], su[e + pitch + 1], sv[e], sv[e + pitch], sv[e + 1],
            sv[e + pitch + 1], t11[e], t22[e], t12[e], strength[q], dt_m[q], active[q], uo[q],
            vo[q], s.inv_dx, s.inv_dy, s);
        t11[e] = o.s11;
        t22[e] = o.s22;
        t12[e] = o.s12;
        cw[q] = o.c_w;
        inv[q] = o.inv_drag;
        if (l == seg - 1 && pos.x + 1 < pos.nx) {  // into the next block's apron
          float* far = cluster.map_shared_rank(smem, pos.rank(pos.x + 1, 0));
          const int a = cell(-1, c);
          far[2 * plane + a] = o.s11;
          far[3 * plane + a] = o.s22;
          far[4 * plane + a] = o.s12;
        }
      });
    }
    window_sync(cluster, pos);

    // Velocity phase: the cone's nodes in the window's nodes [sub + 1, w - 1 - sub).
    if (g >= cr[4 + along_e] && g < cr[5 + along_e] && x >= sub + 1 && x < w - 1 - sub) {
      owned([&](int q, int c) {
        if (c < cr[4 + across_e] || c >= cr[5 + across_e]) return;
        const int e = cell(l, c);
        const Around a11 = {t11[e], t11[e - pitch], t11[e - 1], t11[e - pitch - 1]};
        const Around a22 = {t22[e], t22[e - pitch], t22[e - 1], t22[e - pitch - 1]};
        const Around a12 = {t12[e], t12[e - pitch], t12[e - 1], t12[e - pitch - 1]};
        const float2 uv = mevp_velocity_body(forces_uniform(a11, a22, a12, s), s.inv_w, su[e],
                                             sv[e], uo[q], vo[q], cw[q], dt_m[q], b_u[q], b_v[q],
                                             inv[q], s);
        su[e] = uv.x;
        sv[e] = uv.y;
        if (l == 0 && pos.x > 0) {  // into the previous block's apron
          float* far = cluster.map_shared_rank(smem, pos.rank(pos.x - 1, 0));
          const int a = cell(seg, c);
          far[a] = uv.x;
          far[plane + a] = uv.y;
        }
      });
    }
    window_sync(cluster, pos);  // the last one also keeps the cluster together until no block writes another
  }

  // The patch cells of the window's interior along the band, [n_sub, w -
  // n_sub), row by row (consecutive threads on consecutive cells of a row).
  float* out[kRdmaPlanes] = {u, v, s11, s22, s12};
  const int rows = kAlong ? across : seg, cols = kAlong ? seg : across;
  const float inv_cols = 1.0f / static_cast<float>(cols);
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int row = region_row(idx, inv_cols), col = idx - row * cols;
    const int pl = kAlong ? col : row, pc = kAlong ? row : col;
    const int2 ij = band_ij(pl, pc);
    if (ij.x < bands.pr0 || ij.x >= bands.pr0 + bands.prn || ij.y < bands.pc0 ||
        ij.y >= bands.pc0 + bands.pcn || wx0 + pl < n_sub || wx0 + pl >= w - n_sub) {
      continue;
    }
    const int own = (r0 + ij.x - src.hx) * src.ny + (c0 + ij.y - src.hy);
    const int e = cell(pl, pc);
#pragma unroll
    for (int p = 0; p < kRdmaPlanes; ++p) out[p][own] = smem[p * plane + e];
  }
}

using RdmaBandKernel = void (*)(RdmaSources, RdmaBands, MevpConsts, int, int, int, RdmaCone,
                                float*, float*, float*, float*, float*, MevpScalars);

// The kernel of a band axis and block size: up to kRdmaBandThreads threads
// under that launch bound, more under kRdmaMaxThreads.
RdmaBandKernel rdma_band_of(int long_axis, int threads) {
  if (threads <= kRdmaBandThreads) {
    return long_axis ? rdma_band_kernel<1, kRdmaBandThreads> : rdma_band_kernel<0, kRdmaBandThreads>;
  }
  return long_axis ? rdma_band_kernel<1, kRdmaMaxThreads> : rdma_band_kernel<0, kRdmaMaxThreads>;
}

// Whether the kernel takes clusters of `cluster` blocks of `threads`, each
// `seg` cells along a band `across` cells wide: a thread owns one position
// along the band and at most 4 cells across it.
bool rdma_band_valid(int across, int cluster, int seg, int threads) {
  if (cluster < 1 || cluster > kRdmaMaxClusterBlocks || seg < 1 || seg > 1000 || across < 2 ||
      threads < 32 || threads > kRdmaMaxThreads) {
    return false;
  }
  const int stride = threads / seg;
  return stride >= 1 && (across + stride - 1) / stride <= kRdmaMaxCells;
}

}  // namespace nst

// Dynamic shared memory of one rdma_band block: 5 planes of its region and
// its apron along the band (the y bands' rows padded by one cell).
static int rdma_band_shared_bytes(int long_axis, int across, int seg) {
  const int cells = long_axis ? across * (seg + 2) : (seg + 2) * (across + 1);
  return nst::kRdmaPlanes * cells * static_cast<int>(sizeof(float));
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

// The band pair of `axis` (0: x, 1: y) of a round's sources.
static nst::RdmaBands rdma_bands(const nst::RdmaSources& src, int axis) {
  const int h = src.h;
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
  return bands;
}

// Whether the cone's ranges lie in the band, elements before nodes, and
// across the band within the cells a block holds (elements below the last
// row or column, nodes above the first: true for n_sub <= h).
static bool rdma_cone_valid(const int* cone, int n_sub, const nst::RdmaBands& bands) {
  const int across_axis = bands.long_axis ? 0 : 1;
  for (int sub = 0; sub < n_sub; ++sub) {
    const int* r = cone + 8 * sub;
    for (int axis = 0; axis < 2; ++axis) {
      const int n = axis == 0 ? bands.rows : bands.cols;
      const int e0 = r[2 * axis], e1 = r[2 * axis + 1], n0 = r[4 + 2 * axis], n1 = r[5 + 2 * axis];
      if (e0 < 0 || e0 > e1 || e1 > n || n0 < 0 || n0 > n1 || n1 > n || n0 < e0 || n1 > e1) {
        return false;
      }
      if (axis == across_axis && (e1 > n - 1 || n0 < 1)) return false;
    }
  }
  return true;
}

// Clusters of `cluster` rdma_band blocks of `threads` threads, each `seg`
// cells along a band of `axis` (0: x, 1: y) that is `across` cells wide,
// that the card holds at once (cudaOccupancyMaxActiveClusters; 0 where the
// kernel takes no such clusters or none fits; -1 - error where the runtime
// refuses).
int nst_rdma_band_max_clusters(int axis, int across, int cluster, int seg, int threads,
                               int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const int long_axis = axis == 0 ? 1 : 0;
  if (!nst::rdma_band_valid(across, cluster, seg, threads)) return 0;
  const nst::ClusterLaunch launch(dim3(cluster, 1, 2), cluster, 1, threads,
                                  rdma_band_shared_bytes(long_axis, across, seg), nullptr);
  return nst::max_active_clusters(nst::rdma_band_of(long_axis, threads), launch);
}

// n_sub subcycles on the two bands of `axis` (0: x, 1: y) and their patches
// into the 5 state planes `state` (the interior pass's output), by
// n_clusters clusters a band of `cluster` blocks of `threads` threads, each
// `seg` cells along the band; cone: n_sub x 8 ints, the patch's cone per
// subcycle (RdmaCone). consts: the 7 widened const-plane pointers in
// MevpConsts order, row length ld = ny + 2hy. Returns the CUDA error of the
// launch or its attributes; does not synchronise.
int nst_rdma_band(const void* const* sources, const int* dims, int axis,
                  const void* const* consts, int cluster, int seg, int threads, int n_clusters,
                  const int* cone, int n_sub, void* const* state, const float* scalars,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nst::RdmaSources src = rdma_sources(sources, dims);
  const int h = src.h;
  if (n_sub < 1 || n_sub > h || n_sub > nst::kRdmaMaxSub || (axis != 0 && axis != 1) ||
      (axis == 0 && (src.hx != h || src.nx < 2 * h)) ||
      (axis == 1 && (src.hy != h || src.ny < 2 * h))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const nst::RdmaBands bands = rdma_bands(src, axis);
  const int across = bands.long_axis ? bands.rows : bands.cols;
  const int along = bands.long_axis ? bands.cols : bands.rows;
  if (!nst::rdma_band_valid(across, cluster, seg, threads) ||
      cluster * seg <= 2 * n_sub || n_clusters < 1 ||
      static_cast<long>(n_clusters) * (cluster * seg - 2 * n_sub) < along ||
      !rdma_cone_valid(cone, n_sub, bands)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::RdmaCone cn = {};
  std::memcpy(cn.r, cone, static_cast<size_t>(n_sub) * sizeof(cn.r[0]));
  nst::MevpConsts k = {};
  std::memcpy(&k, consts, 7 * sizeof(const float*));
  nst::MevpScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  const int bytes = rdma_band_shared_bytes(bands.long_axis, across, seg);
  const auto kernel = nst::rdma_band_of(bands.long_axis, threads);
  err = nst::prepare_cluster_kernel(kernel, bytes, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* const* out = reinterpret_cast<float* const*>(state);
  const int ld = src.ny + 2 * src.hy;
  const nst::ClusterLaunch launch(dim3(n_clusters * cluster, 1, 2), cluster, 1, threads, bytes,
                                  static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.config, kernel, src, bands, k, ld, seg, n_sub, cn, out[0],
                           out[1], out[2], out[3], out[4], s);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
