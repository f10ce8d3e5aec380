// Higher-order (CG2/dG1) mEVP subcycles on Hopper by ghost-zone tiles: H
// subcycles per launch.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py::ho_subcycles_tiled,
// which runs halo_x HO subcycles per round on full-row halo'd blocks of the
// 17 state planes (4 + 4 CG2 velocity, 3 x 3 dG1 stress coefficients) and
// the 29 const planes in VMEM, ping-ponging the padded state between two
// HBM slots and writing back only the interiors. Here one thread block owns
// a T x T tile of the grid and loads the (T + 2H)^2 window around it of the
// 17 state planes into shared memory. It runs min(H, remaining) subcycles on
// the window, each one a stress phase over the elements that are still
// valid, a barrier, a velocity phase over the node indices, and a barrier.
// The element gather reaches +1 and the node scatter -1 node index, so each
// subcycle invalidates one ring of the window on either side (the argument
// of the JAX kernel), and after H subcycles the T x T interior is exact;
// only the interior is written back. The 29 const planes are read from
// global memory where they are needed (read-only for the launch, through
// __ldg), as mevp_tiled.cu reads its consts.
//
// In place in shared memory is safe: the stress phase writes only its
// element's coefficients and reads, besides them, only velocities; the
// velocity phase writes only its node index's velocities and reads,
// besides them, only stresses. Blocks run in parallel and in no order, so a
// launch reads one state buffer and writes another (ping-pong on the host).
//
// Walls: a load outside the domain is a zero, in every plane, and cells
// outside the domain are never updated, so they stay zero: that is the
// closed wall (the i = nx and j = ny nodes are implicit zeros, and a missing
// element contributes no force). nx and ny need not be multiples of T, nor
// N of H.
//
// Each element and node index runs ho_stress_body and ho_velocity_body of
// ho_body.cuh, as ho_single.cu does, with the same --fmad=false, so the two
// schedules agree bit for bit.
//
// What bounds it on the H100: the ~900 float32 operations per element and
// subcycle, times ((T + 2H - 1)/T)^2 in the first subcycle of a round
// (shrinking ring by ring), and the shared-memory and L1/L2 traffic of the
// window and the consts. HBM sees the 17 state planes in and out once per
// round. Shared memory limits the window: 17 planes of (T + 2H)^2 floats
// must fit the 227 KB of a block, so T + 2H <= 58; T = 32, H = 8 takes 156 KB.
#include <cstring>

#include "ho_body.cuh"

namespace nst {

constexpr int kHoTiledMaxThreads = 512;  // the body's registers (up to 128) at 1 block per SM

__global__ void __launch_bounds__(kHoTiledMaxThreads)
ho_tiled_kernel(const float* __restrict__ state_in, float* __restrict__ state_out, HoConsts k,
                int nx, int ny, int tile, int halo, int n_sub, HoScalars s, HoTables t) {
  extern __shared__ float smem[];
  const int w = tile + 2 * halo;  // window width, both axes
  const int wp = w * w;           // one window plane
  const long gplane = static_cast<long>(nx) * ny;

  // Window cell (a, b) is grid cell (i0 + a, j0 + b). Each loop below
  // spreads the cells of a square region over the block's threads, row by
  // row, consecutive threads on consecutive cells of a row.
  const int i0 = blockIdx.y * tile - halo;
  const int j0 = blockIdx.x * tile - halo;
  const int tid = threadIdx.x, n_threads = blockDim.x;

  const float inv_w = 1.0f / static_cast<float>(w);
  for (int c = tid; c < wp; c += n_threads) {
    const int a = region_row(c, inv_w), b = c - a * w;
    const int i = i0 + a, j = j0 + b;
    const bool inside = i >= 0 && i < nx && j >= 0 && j < ny;
    const long ij = static_cast<long>(i) * ny + j;
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) smem[p * wp + c] = inside ? state_in[p * gplane + ij] : 0.0f;
  }
  __syncthreads();

  for (int sub = 0; sub < n_sub; ++sub) {
    // Stress phase: element (a, b) reads node indices a..a+1, b..b+1, which
    // are valid on [sub, w - sub), so elements [sub, w - 1 - sub) are computed.
    int lo = sub;
    int r = w - 1 - 2 * sub;
    float inv_r = 1.0f / static_cast<float>(r);
    for (int idx = tid; idx < r * r; idx += n_threads) {
      const int da = region_row(idx, inv_r);
      const int a = lo + da, b = lo + idx - da * r;
      const int i = i0 + a, j = j0 + b;
      if (i < 0 || i >= nx || j < 0 || j >= ny) continue;
      const int c = a * w + b;
      float u[kHoNodes], v[kHoNodes];
      ho_gather([&](int p, int di, int dj) { return smem[p * wp + c + di * w + dj]; }, u);
      ho_gather([&](int p, int di, int dj) { return smem[(kHoPlanes + p) * wp + c + di * w + dj]; },
                v);
      float s11[kHoCoeffs], s22[kHoCoeffs], s12[kHoCoeffs];
#pragma unroll
      for (int q = 0; q < kHoCoeffs; ++q) {
        s11[q] = smem[(kHoS11 + q) * wp + c];
        s22[q] = smem[(kHoS22 + q) * wp + c];
        s12[q] = smem[(kHoS12 + q) * wp + c];
      }
      ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + static_cast<long>(i) * ny + j));
#pragma unroll
      for (int q = 0; q < kHoCoeffs; ++q) {
        smem[(kHoS11 + q) * wp + c] = s11[q];
        smem[(kHoS22 + q) * wp + c] = s22[q];
        smem[(kHoS12 + q) * wp + c] = s12[q];
      }
    }
    __syncthreads();

    // Velocity phase: node index (a, b) reads elements a-1..a, b-1..b, valid
    // on [sub, w - 1 - sub): node indices [sub + 1, w - 1 - sub) are computed.
    lo = sub + 1;
    r = w - 2 - 2 * sub;
    inv_r = 1.0f / static_cast<float>(r);
    for (int idx = tid; idx < r * r; idx += n_threads) {
      const int da = region_row(idx, inv_r);
      const int a = lo + da, b = lo + idx - da * r;
      const int i = i0 + a, j = j0 + b;
      if (i < 0 || i >= nx || j < 0 || j >= ny) continue;
      const int c = a * w + b;
      float uv[2 * kHoPlanes];
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) uv[p] = smem[p * wp + c];
      // Elements beyond the domain read the window's zeros.
      ho_velocity_body(t, s, k, static_cast<long>(i) * ny + j,
                       [&](int di, int dj, float* s11, float* s22, float* s12) {
                         const int e = c + di * w + dj;
#pragma unroll
                         for (int q = 0; q < kHoCoeffs; ++q) {
                           s11[q] = smem[(kHoS11 + q) * wp + e];
                           s22[q] = smem[(kHoS22 + q) * wp + e];
                           s12[q] = smem[(kHoS12 + q) * wp + e];
                         }
                       },
                       uv);
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) smem[p * wp + c] = uv[p];
    }
    __syncthreads();
  }

  // The T x T interior (window cells [halo, halo + tile)) is exact.
  const float inv_t = 1.0f / static_cast<float>(tile);
  for (int idx = tid; idx < tile * tile; idx += n_threads) {
    const int da = region_row(idx, inv_t);
    const int a = halo + da, b = halo + idx - da * tile;
    const int i = i0 + a, j = j0 + b;
    if (i >= nx || j >= ny) continue;
    const int c = a * w + b;
    const long ij = static_cast<long>(i) * ny + j;
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) state_out[p * gplane + ij] = smem[p * wp + c];
  }
}

}  // namespace nst

extern "C" {

int nst_ho_tiled_shared_bytes(int tile, int halo) {
  const int w = tile + 2 * halo;
  return nst::kHoStatePlanes * w * w * static_cast<int>(sizeof(float));
}

// One round: n_sub (<= halo) subcycles, by blocks of `threads` threads (at
// most 512), from the (17, nx, ny) state_in into state_out, which must not
// alias it. consts points to the 29 const-plane pointers in the order of
// HoConsts; scalars and tables to HoScalars and HoTables. Launches on
// `stream`, returns cudaGetLastError() (or the error of the shared-memory
// attribute); does not synchronise.
int nst_ho_tiled(const float* state_in, float* state_out, const void* const* consts, int nx,
                 int ny, int tile, int halo, int n_sub, int threads, const float* scalars,
                 const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || tile < 1 || halo < n_sub || n_sub < 1 || threads < 32 ||
      threads > nst::kHoTiledMaxThreads || tile + 2 * halo > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::HoConsts k;
  std::memcpy(&k, consts, sizeof(k));
  nst::HoScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  nst::HoTables t;
  std::memcpy(&t, tables, sizeof(t));
  const int bytes = nst_ho_tiled_shared_bytes(tile, halo);
  err = cudaFuncSetAttribute(nst::ho_tiled_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  const dim3 grid((ny + tile - 1) / tile, (nx + tile - 1) / tile);
  nst::ho_tiled_kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      state_in, state_out, k, nx, ny, tile, halo, n_sub, s, t);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
