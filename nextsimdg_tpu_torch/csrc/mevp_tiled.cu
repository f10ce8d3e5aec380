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
// mevp_body.cuh, the bodies of mevp.cu's two kernels, with the same
// --fmad=false, so this schedule equals that one bit for bit.
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

#include "mevp_body.cuh"

namespace nst {

constexpr int kTiledMaxThreads = 1024;  // the block size is a launch parameter
constexpr int kMevpSharedPlanes = 7;  // u, v, s11, s22, s12, c_w, inv_drag

// The window's stresses around node (a, b) (window index c), each times
// the metric plane w of its own element (grid (i, j)); beyond the domain
// the stress is zero and so is the weight.
__device__ __forceinline__ Around weighted_window(const float* f, const float* w, int c,
                                                 int ww, int i, int j, int nx, int ny) {
  return {f[c] * __ldg(w + i * ny + j), f[c - ww] * ldg_at(w, i - 1, j, nx, ny),
          f[c - 1] * ldg_at(w, i, j - 1, nx, ny),
          f[c - ww - 1] * ldg_at(w, i - 1, j - 1, nx, ny)};
}

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
  float* scw = s12 + plane;
  float* sinv = scw + plane;

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

  for (int sub = 0; sub < n_sub; ++sub) {
    // Stress phase: element (a, b) reads nodes a..a+1, b..b+1, which are
    // valid on [sub, w - sub), so elements [sub, w - 1 - sub) are computed.
    int lo = sub;
    int r = w - 1 - 2 * sub;
    float inv_r = 1.0f / static_cast<float>(r);
    for (int idx = tid; idx < r * r; idx += n_threads) {
      const int da = region_row(idx, inv_r);
      const int a = lo + da, b = lo + idx - da * r;
      const int i = i0 + a, j = j0 + b;
      if (i < 0 || i >= nx || j < 0 || j >= ny) continue;
      const int c = a * w + b, ij = i * ny + j;
      const StressOut o = mevp_stress_body(
          su[c], su[c + w], su[c + 1], su[c + w + 1], sv[c], sv[c + w], sv[c + 1],
          sv[c + w + 1], s11[c], s22[c], s12[c], __ldg(k.strength + ij),
          __ldg(k.dt_m + ij), __ldg(k.active + ij), __ldg(k.u_ocean + ij),
          __ldg(k.v_ocean + ij), kMetric ? __ldg(k.inv_dx + ij) : s.inv_dx,
          kMetric ? __ldg(k.inv_dy + ij) : s.inv_dy, s);
      s11[c] = o.s11;
      s22[c] = o.s22;
      s12[c] = o.s12;
      scw[c] = o.c_w;
      sinv[c] = o.inv_drag;
    }
    __syncthreads();

    // Velocity phase: node (a, b) reads elements a-1..a, b-1..b and its own
    // c_w and inv_drag, valid on [sub, w - 1 - sub): nodes
    // [sub + 1, w - 1 - sub) are computed.
    lo = sub + 1;
    r = w - 2 - 2 * sub;
    inv_r = 1.0f / static_cast<float>(r);
    for (int idx = tid; idx < r * r; idx += n_threads) {
      const int da = region_row(idx, inv_r);
      const int a = lo + da, b = lo + idx - da * r;
      const int i = i0 + a, j = j0 + b;
      if (i < 0 || i >= nx || j < 0 || j >= ny) continue;
      const int c = a * w + b, ij = i * ny + j;
      float2 f;
      float inv_node_w;
      if (kMetric) {
        f = forces_metric(weighted_window(s11, k.half_dy, c, w, i, j, nx, ny),
                          weighted_window(s12, k.half_dx, c, w, i, j, nx, ny),
                          weighted_window(s12, k.half_dy, c, w, i, j, nx, ny),
                          weighted_window(s22, k.half_dx, c, w, i, j, nx, ny));
        inv_node_w = __ldg(k.inv_w + ij);
      } else {
        const Around a11 = {s11[c], s11[c - w], s11[c - 1], s11[c - w - 1]};
        const Around a22 = {s22[c], s22[c - w], s22[c - 1], s22[c - w - 1]};
        const Around a12 = {s12[c], s12[c - w], s12[c - 1], s12[c - w - 1]};
        f = forces_uniform(a11, a22, a12, s);
        inv_node_w = s.inv_w;
      }
      const float2 uv = mevp_velocity_body(
          f, inv_node_w, su[c], sv[c], __ldg(k.u_ocean + ij), __ldg(k.v_ocean + ij), scw[c],
          __ldg(k.dt_m + ij), __ldg(k.b_u + ij), __ldg(k.b_v + ij), sinv[c], s);
      su[c] = uv.x;
      sv[c] = uv.y;
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
