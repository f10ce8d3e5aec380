// CG1 mEVP subcycles on Hopper by ghost-zone tiles: H subcycles per launch.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_tiled.py::mevp_subcycles_tiled, which
// runs H subcycles per round on a halo'd block in VMEM and writes back the
// interior. Here one thread block owns a T x T tile of the grid and loads
// the (T + 2H)^2 window around it of the five state planes (u, v, s11, s22,
// s12) into shared memory. It runs min(H, remaining) subcycles on the
// window, each one a stress phase over the elements that are still valid,
// a barrier, a velocity phase over the nodes, and a barrier. Each subcycle
// invalidates one ring of the window on either side, so after H subcycles
// the T x T interior is exact, and only the interior is written back.
// c_w and inv_drag, the per-subcycle node planes of the shared divide, live
// in shared memory and never reach global memory. The per-step constant
// planes (7 on a uniform mesh, 12 with the metric planes of a graded or
// spherical one) are read from global memory where they are needed (they
// are read-only for the whole launch and stay in L1/L2), so the metric
// does not grow the shared memory of a block.
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
// mevp_body.cuh (through window_subcycles of mevp_window.cuh), the bodies of
// mevp.cu's two kernels, with the same --fmad=false, so this schedule
// equals that one bit for bit.
//
// What bounds it on the H100: the grid-wide schedule moves ~116 bytes per
// element per subcycle (mevp.cu); at 1024^2 its ~56 MB working set is more
// than the 50 MB L2, so 200 launches per step stream from HBM. Here a
// launch reads the state once per H subcycles (5 planes in, 5 out, plus
// the consts through L1/L2), so the bound moves to the arithmetic and the
// shared-memory traffic of the window, ((T + 2H)/T)^2 times the interior's
// work in the first subcycle of a round, shrinking ring by ring. The tile
// and halo are launch parameters (shared memory is sized at launch), chosen
// by measurement in coupled_cuda.py.
#include <cstring>

#include "mevp_window.cuh"

namespace nst {

constexpr int kTiledMaxThreads = 1024;  // the block size is a launch parameter

template <bool kMetric>
__global__ void __launch_bounds__(kTiledMaxThreads)
mevp_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                  const float* __restrict__ s11_in, const float* __restrict__ s22_in,
                  const float* __restrict__ s12_in, float* __restrict__ u_out,
                  float* __restrict__ v_out, float* __restrict__ s11_out,
                  float* __restrict__ s22_out, float* __restrict__ s12_out,
                  MevpConsts k, int nx, int ny, int tile, int halo, int n_sub,
                  MevpScalars s) {
  extern __shared__ float smem[];
  const int w = tile + 2 * halo;  // window width, both axes
  const int plane = w * w;
  float* su = smem;
  float* sv = su + plane;
  float* s11 = sv + plane;
  float* s22 = s11 + plane;
  float* s12 = s22 + plane;

  // Window cell (a, b) is grid cell (i0 + a, j0 + b). Each loop below
  // spreads the cells of a square region over the block's threads, row by
  // row, consecutive threads on consecutive cells of a row.
  const int i0 = blockIdx.y * tile - halo;
  const int j0 = blockIdx.x * tile - halo;
  const int tid = threadIdx.x, n_threads = blockDim.x;

  const float inv_w = 1.0f / static_cast<float>(w);
  for (int idx = tid; idx < plane; idx += n_threads) {
    const int a = region_row(idx, inv_w), b = idx - a * w;
    const int i = i0 + a, j = j0 + b;
    if (i >= 0 && i < nx && j >= 0 && j < ny) {
      const int ij = i * ny + j;
      su[idx] = u_in[ij];
      sv[idx] = v_in[ij];
      s11[idx] = s11_in[ij];
      s22[idx] = s22_in[ij];
      s12[idx] = s12_in[ij];
    } else {
      su[idx] = sv[idx] = s11[idx] = s22[idx] = s12[idx] = 0.0f;
    }
  }
  __syncthreads();

  const Window win = {w, w, i0, j0, nx, ny, 1, 1};
  const ConstView cv = {k, ny, 0, 0};
  window_subcycles<kMetric>(smem, win, cv, n_sub, s);

  // The T x T interior (window cells [halo, halo + tile)) is exact.
  const float inv_t = 1.0f / static_cast<float>(tile);
  for (int idx = tid; idx < tile * tile; idx += n_threads) {
    const int da = region_row(idx, inv_t);
    const int a = halo + da, b = halo + idx - da * tile;
    const int i = i0 + a, j = j0 + b;
    if (i >= nx || j >= ny) continue;
    const int c = a * w + b, ij = i * ny + j;
    u_out[ij] = su[c];
    v_out[ij] = sv[c];
    s11_out[ij] = s11[c];
    s22_out[ij] = s22[c];
    s12_out[ij] = s12[c];
  }
}

}  // namespace nst

extern "C" {

int nst_mevp_tiled_shared_bytes(int tile, int halo) {
  const int w = tile + 2 * halo;
  return nst::kMevpSharedPlanes * w * w * static_cast<int>(sizeof(float));
}

// One round: n_sub (<= halo) subcycles, by blocks of `threads` threads (at
// most 1024), from the *_in planes into the *_out
// planes, which must not alias them. consts points to the 12 const-plane
// pointers in the order of MevpConsts, the last five null on a uniform
// mesh. Launches on `stream`, returns cudaGetLastError() (or the error of
// the shared-memory attribute); does not synchronise.
int nst_mevp_tiled(const float* u_in, const float* v_in, const float* s11_in,
                   const float* s22_in, const float* s12_in, float* u_out,
                   float* v_out, float* s11_out, float* s22_out, float* s12_out,
                   const void* const* consts, int nx, int ny, int tile, int halo,
                   int n_sub, int threads, const float* scalars, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile < 1 || halo < n_sub || n_sub < 1 || threads < 32 ||
      threads > nst::kTiledMaxThreads || tile + 2 * halo > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::MevpConsts k;
  std::memcpy(&k, consts, sizeof(k));
  const auto kernel =
      k.inv_dx != nullptr ? nst::mevp_tiled_kernel<true> : nst::mevp_tiled_kernel<false>;
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
