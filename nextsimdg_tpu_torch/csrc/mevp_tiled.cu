// CG1 mEVP subcycles on Hopper by ghost-zone tiles: H subcycles per launch.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_tiled.py::mevp_subcycles_tiled, which
// runs H subcycles per round on a halo'd block in VMEM and writes back the
// interior. Here one thread block owns a T x T tile of the grid and loads
// the w x w window (w = T + 2H) around it of the five state planes (u, v,
// s11, s22, s12) into shared memory. It runs min(H, remaining) subcycles on
// the window, each one a stress phase over the elements that are still
// valid, a barrier, a velocity phase over the nodes, and a barrier. Each
// subcycle invalidates one ring of the window on either side (elements
// [sub, w - 1 - sub), nodes [sub + 1, w - 1 - sub) along each axis), so
// after H subcycles the T x T interior is exact, and only the interior is
// written back.
//
// Fixed cell ownership. The block's threads cover the window `rows` rows at
// a time (rows = threads / w, the threads beyond rows x w idle): thread t
// owns column b = t mod w of rows a0, a0 + rows, ... (a0 = t / w), at most
// kTiledMaxCells (8) of them, for the whole launch. Its column's ring
// limits and domain test are worked out once per launch; per cell, phase
// and subcycle what remains is the row's. Consecutive threads hold
// consecutive cells of a row (coalesced loads, no bank conflicts); when w
// is a multiple of 32 a warp lies in one row, and the rows a subcycle's
// ring leaves out are whole warps that skip.
//
// c_w and inv_drag in registers. The velocity phase at node c reads only
// the c_w and inv_drag that the stress phase of the same subcycle wrote at
// element c, and the same thread owns both, so each thread keeps them in
// two arrays of 8 registers (the loop over its cells unrolled): the
// window holds 5 planes, not 7. A window 64 wide then takes 80 KB, and two
// blocks of 512 threads share an SM (at most 64 registers a thread).
// The momentum form is a template argument (mevp_body.cuh): the adaptive
// form keeps each cell's beta in a third array of registers, the weighted
// one reads a_node, a const plane like the others (the window stays at 5
// planes in every form).
//
// The per-step constant planes (7 on a uniform mesh, 12 with the metric
// planes of a graded or spherical one) are read-only for the launch and
// are read through the read-only path where they are used, from L1/L2;
// staging the 7 uniform ones in shared memory once per launch was measured
// slower (it leaves two blocks an SM only windows 48 wide; PERF.md).
//
// Blocks run in parallel and in no order, so a launch reads one set of
// state planes and writes another (ping-pong on the host): nothing is
// updated in place, and there is no cross-round prefetch or deferred
// write-back as in the TPU kernel's sequential grid.
//
// Walls: a load outside the domain is a zero, in every plane, exactly as
// at() in common.cuh. Cells outside the domain are never updated, so they
// stay zero, which is what the grid-wide kernels of mevp.cu read there;
// nx and ny need not be multiples of T, nor N of H.
//
// Each element and node runs mevp_stress_body and mevp_velocity_body of
// mevp_body.cuh, the bodies of mevp.cu's two kernels, with the same
// arguments in the same order under --fmad=false, so this schedule equals
// K1's bit for bit. rdma_band (mevp_rdma.cu) runs the same bodies with the
// same arguments on fewer cells (the cone of its patch, not the whole
// window), and the cells it keeps equal this schedule's bit for bit too.
//
// What bounds it on the H100: the grid-wide schedule moves ~116 bytes per
// element per subcycle (mevp.cu); at 1024^2 its ~56 MB working set is more
// than the 50 MB L2, so 200 launches per step stream from HBM. Here a
// launch reads the state once per H subcycles (5 planes in, 5 out, plus
// the consts), so the bound moves to the arithmetic of the window,
// ((T + 2H)/T)^2 times the interior's work in the first subcycle of a
// round, shrinking ring by ring, and to how well the SM hides the latency
// of its barriers, const loads, divides and square roots. The tile, halo
// and threads are launch parameters (shared memory is sized at launch),
// chosen per grid size by measurement (mevp_tiled_cuda.py). The 80-wide
// window of the smaller grids has a kernel of its own with the width a
// compile-time constant, 2-7% faster on the H100 than the generic width;
// the 64-wide one of the large grids gained 0-2% and runs the generic one
// (PERF.md).
#include <cstring>

#include "mevp_body.cuh"

namespace nst {

constexpr int kTiledMaxThreads = 1024;  // the block size is a launch parameter
constexpr int kTiledStatePlanes = 5;    // u, v, s11, s22, s12
constexpr int kTiledMaxCells = 8;       // window rows a thread owns, at most

// kW: the window width where it is known at compile time (shared-memory
// offsets become immediates), 0 where it is read from tile and halo.
// kForm: the momentum form.
template <bool kMetric, int kW, int kForm>
__global__ void __launch_bounds__(kTiledMaxThreads)
mevp_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                  const float* __restrict__ s11_in, const float* __restrict__ s22_in,
                  const float* __restrict__ s12_in, float* __restrict__ u_out,
                  float* __restrict__ v_out, float* __restrict__ s11_out,
                  float* __restrict__ s22_out, float* __restrict__ s12_out,
                  MevpConsts k, int nx, int ny, int tile, int halo, int n_sub,
                  MevpScalars s) {
  extern __shared__ float smem[];
  const int w = kW ? kW : tile + 2 * halo;  // window width, both axes
  const int plane = w * w;
  float* su = smem;
  float* sv = su + plane;
  float* s11 = sv + plane;
  float* s22 = s11 + plane;
  float* s12 = s22 + plane;

  // Window cell (a, b) is grid cell (i0 + a, j0 + b). This thread owns
  // column b of rows a0, a0 + rows, ... < w.
  const int i0 = blockIdx.y * tile - halo;
  const int j0 = blockIdx.x * tile - halo;
  const int rows = blockDim.x / w;
  const int a0 = threadIdx.x / w;
  const int b = threadIdx.x - a0 * w;
  const int j = j0 + b;
  // Ring limits along the columns: this thread's cells are elements while
  // sub <= eb and nodes while sub <= nb (-1: never, beyond the domain).
  const bool in_j = a0 < rows && j >= 0 && j < ny;
  const int eb = in_j ? min(b, w - 2 - b) : -1;
  const int nb = in_j ? min(b - 1, w - 2 - b) : -1;
  const int a_end = in_j ? w : 0;  // rows past it: none of this thread's

  // fn(q, a) over the owned rows a; q is the cell's register slot.
  const auto owned = [&](auto fn) {
#pragma unroll
    for (int q = 0; q < kTiledMaxCells; ++q) {
      int a = a0 + q * rows;
      // Opaque to the compiler, so that the cells' addresses are not all
      // hoisted out of the subcycle loop into registers (they spill).
      asm volatile("" : "+r"(a));
      if (a < a_end) fn(q, a);
    }
  };
  const auto cst = [&](int p, int ij) { return __ldg(mevp_const_plane(k, p) + ij); };

  // The load: the window's state, zeros beyond the domain. Threads beyond
  // rows x w own nothing.
#pragma unroll 1
  for (int a = a0; a < (a0 < rows ? w : 0); a += rows) {
    const int c = a * w + b, i = i0 + a, ij = i * ny + j;
    if (in_j && i >= 0 && i < nx) {
      su[c] = u_in[ij];
      sv[c] = v_in[ij];
      s11[c] = s11_in[ij];
      s22[c] = s22_in[ij];
      s12[c] = s12_in[ij];
    } else {
      su[c] = sv[c] = s11[c] = s22[c] = s12[c] = 0.0f;
    }
  }
  __syncthreads();

  float cw[kTiledMaxCells], inv[kTiledMaxCells], bt[kTiledMaxCells];
  for (int sub = 0; sub < n_sub; ++sub) {
    // Stress phase: element (a, b), elements [sub, w - 1 - sub) along each
    // axis, reads nodes a..a+1, b..b+1.
    owned([&](int q, int a) {
      const int i = i0 + a;
      if (i < 0 || i >= nx || sub > min(eb, min(a, w - 2 - a))) return;
      const int c = a * w + b, ij = i * ny + j;
      const StressOut o = mevp_stress_body<kForm>(
          su[c], su[c + w], su[c + 1], su[c + w + 1], sv[c], sv[c + w], sv[c + 1],
          sv[c + w + 1], s11[c], s22[c], s12[c], cst(kStrength, ij), cst(kDtM, ij),
          cst(kActive, ij), cst(kUo, ij), cst(kVo, ij),
          kMetric ? __ldg(k.inv_dx + ij) : s.inv_dx, kMetric ? __ldg(k.inv_dy + ij) : s.inv_dy,
          s, form_a_node<kForm>(k, ij), form_inv_area<kMetric, kForm>(k, ij, s));
      s11[c] = o.s11;
      s22[c] = o.s22;
      s12[c] = o.s12;
      cw[q] = o.c_w;
      inv[q] = o.inv_drag;
      if constexpr ((kForm & kFormAdaptive) != 0) bt[q] = o.beta;
    });
    __syncthreads();

    // Velocity phase: node (a, b), nodes [sub + 1, w - 1 - sub), reads
    // elements a-1..a, b-1..b and the c_w and inv_drag that this thread
    // computed at element (a, b) above.
    owned([&](int q, int a) {
      const int i = i0 + a;
      if (i < 0 || i >= nx || sub > min(nb, min(a - 1, w - 2 - a))) return;
      const int c = a * w + b, ij = i * ny + j;
      float2 f;
      float inv_node_w;
      if (kMetric) {
        f = forces_metric(weighted_tile(s11, k.half_dy, c, w, ij, i, j, nx, ny),
                          weighted_tile(s12, k.half_dx, c, w, ij, i, j, nx, ny),
                          weighted_tile(s12, k.half_dy, c, w, ij, i, j, nx, ny),
                          weighted_tile(s22, k.half_dx, c, w, ij, i, j, nx, ny));
        inv_node_w = __ldg(k.inv_w + ij);
      } else {
        const Around a11 = {s11[c], s11[c - w], s11[c - 1], s11[c - w - 1]};
        const Around a22 = {s22[c], s22[c - w], s22[c - 1], s22[c - w - 1]};
        const Around a12 = {s12[c], s12[c - w], s12[c - 1], s12[c - w - 1]};
        f = forces_uniform(a11, a22, a12, s);
        inv_node_w = s.inv_w;
      }
      const float2 uv = mevp_velocity_body(
          f, inv_node_w, su[c], sv[c], cst(kUo, ij), cst(kVo, ij), cw[q], cst(kDtM, ij),
          cst(kBu, ij), cst(kBv, ij), inv[q], (kForm & kFormAdaptive) != 0 ? bt[q] : s.beta, s);
      su[c] = uv.x;
      sv[c] = uv.y;
    });
    __syncthreads();
  }

  // The T x T interior (window cells [halo, halo + tile)) is exact.
  if (b < halo || b >= halo + tile || j >= ny || a0 >= rows) return;
#pragma unroll 1
  for (int a = a0; a < halo + tile; a += rows) {
    const int i = i0 + a;
    if (a < halo || i >= nx) continue;
    const int c = a * w + b, ij = i * ny + j;
    u_out[ij] = su[c];
    v_out[ij] = sv[c];
    s11_out[ij] = s11[c];
    s22_out[ij] = s22[c];
    s12_out[ij] = s12[c];
  }
}

using TiledKernel = void (*)(const float*, const float*, const float*, const float*,
                             const float*, float*, float*, float*, float*, float*, MevpConsts,
                             int, int, int, int, int, MevpScalars);

template <bool kMetric, int kForm>
TiledKernel tiled_kernel_of(int w) {
  return w == 80 ? mevp_tiled_kernel<kMetric, 80, kForm> : mevp_tiled_kernel<kMetric, 0, kForm>;
}

template <int kForm>
TiledKernel tiled_kernel_of(bool metric, int w) {
  return metric ? tiled_kernel_of<true, kForm>(w) : tiled_kernel_of<false, kForm>(w);
}

// The kernel of a launch configuration and momentum form, or null where it
// has none: fewer threads than a window row, more than 8 window rows a
// thread, or an unknown form.
TiledKernel tiled_kernel(bool metric, int form, int tile, int halo, int threads) {
  const int w = tile + 2 * halo;
  if (tile < 1 || halo < 1 || threads < 32 || threads > kTiledMaxThreads || w > threads) {
    return nullptr;
  }
  const int rows = threads / w;
  if ((w + rows - 1) / rows > kTiledMaxCells) return nullptr;
  switch (form) {
    case 0: return tiled_kernel_of<0>(metric, w);
    case kFormWeighted: return tiled_kernel_of<kFormWeighted>(metric, w);
    case kFormAdaptive: return tiled_kernel_of<kFormAdaptive>(metric, w);
    case kFormWeighted | kFormAdaptive: return tiled_kernel_of<kFormWeighted | kFormAdaptive>(metric, w);
    default: return nullptr;
  }
}

}  // namespace nst

extern "C" {

int nst_mevp_tiled_shared_bytes(int tile, int halo) {
  const int w = tile + 2 * halo;
  return nst::kTiledStatePlanes * w * w * static_cast<int>(sizeof(float));
}

// Resident blocks per SM of a launch configuration (0 where it has no
// kernel or does not fit), from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// -1 - error where the runtime refuses.
int nst_mevp_tiled_max_blocks(int tile, int halo, int threads, int metric, int form, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const auto kernel = nst::tiled_kernel(metric != 0, form, tile, halo, threads);
  if (kernel == nullptr) return 0;
  const int bytes = nst_mevp_tiled_shared_bytes(tile, halo);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err == cudaErrorInvalidValue ? 0 : -1 - static_cast<int>(err);
  }
  return blocks;
}

// One round: n_sub (<= halo) subcycles, by blocks of `threads` threads (at
// most 1024, at least one window row, at most 8 window rows each), from the
// *_in planes into the *_out planes, which must not alias them. consts
// points to the 13 const-plane pointers in the order of MevpConsts, the
// metric ones null on a uniform mesh, a_node null outside the weighted
// form; form: the momentum form's bits. Launches on `stream`, returns
// cudaGetLastError() (or the error of the shared-memory attribute); does
// not synchronise.
int nst_mevp_tiled(const float* u_in, const float* v_in, const float* s11_in,
                   const float* s22_in, const float* s12_in, float* u_out,
                   float* v_out, float* s11_out, float* s22_out, float* s12_out,
                   const void* const* consts, int nx, int ny, int tile, int halo,
                   int n_sub, int threads, int form, const float* scalars, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::MevpConsts k;
  std::memcpy(&k, consts, sizeof(k));
  const auto kernel = nst::tiled_kernel(k.inv_dx != nullptr, form, tile, halo, threads);
  if (kernel == nullptr || halo < n_sub || n_sub < 1 ||
      ((form & nst::kFormWeighted) != 0) != (k.a_node != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = nst_mevp_tiled_shared_bytes(tile, halo);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  nst::MevpScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  const dim3 grid((ny + tile - 1) / tile, (nx + tile - 1) / tile);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      u_in, v_in, s11_in, s22_in, s12_in, u_out, v_out, s11_out, s22_out, s12_out,
      k, nx, ny, tile, halo, n_sub, s);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
