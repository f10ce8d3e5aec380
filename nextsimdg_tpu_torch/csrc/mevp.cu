// CG1 mEVP subcycle on Hopper: two kernels per subcycle.
//
// Replaces the mEVP part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas,
// which keeps the whole grid resident on one core for all N subcycles. One
// 256^2 float32 plane (256 KiB) is already more than the shared memory of
// one SM, so here each subcycle is two grid-wide launches, one thread per
// element or node, with every plane in global memory:
//
//   mevp_stress    (elements): strain, Delta, the shared rheology/drag divide
//                  and the alpha-relaxed stress; writes s11, s22, s12 in place
//                  plus the node planes c_w and inv_drag.
//   mevp_velocity  (nodes):    stress divergence from elements (i-1..i,
//                  j-1..j) and the beta-relaxed velocity; writes u, v in place.
//
// In-place updates are safe: mevp_stress reads only its own stresses and
// mevp_velocity only its own velocity; the neighbour reads are of planes the
// kernel does not write.
//
// What bounds it on the H100: each subcycle moves about 116 bytes per
// element (mevp_stress reads 10 planes and writes 5, mevp_velocity reads 12
// and writes 2). At 256^2 that is 7.6 MB, 2.3 us at 3.35 TB/s, but the
// ~25-plane working set (~6 MB) stays in the 50 MB L2, so the launch
// latency of 2 launches per subcycle is the expected bound. Fusing the two
// launches (recomputing the neighbours' stresses), a persistent kernel or a
// CUDA graph over the subcycle loop is left for later.
//
// The element and node bodies live in mevp_body.cuh, shared with the tiled
// schedule of mevp_tiled.cu.
#include <cstring>

#include "mevp_body.cuh"

namespace nst {

__global__ void mevp_stress_kernel(
    const float* __restrict__ u, const float* __restrict__ v,
    float* __restrict__ s11, float* __restrict__ s22, float* __restrict__ s12,
    const float* __restrict__ strength, const float* __restrict__ dt_m,
    const float* __restrict__ active, const float* __restrict__ u_ocean,
    const float* __restrict__ v_ocean, float* __restrict__ c_w_out,
    float* __restrict__ inv_drag_out, int nx, int ny, MevpScalars s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ij = i * ny + j;
  const StressOut o = mevp_stress_body(
      u[ij], at(u, i + 1, j, nx, ny), at(u, i, j + 1, nx, ny),
      at(u, i + 1, j + 1, nx, ny), v[ij], at(v, i + 1, j, nx, ny),
      at(v, i, j + 1, nx, ny), at(v, i + 1, j + 1, nx, ny), s11[ij], s22[ij],
      s12[ij], strength[ij], dt_m[ij], active[ij], u_ocean[ij], v_ocean[ij], s);
  s11[ij] = o.s11;
  s22[ij] = o.s22;
  s12[ij] = o.s12;
  c_w_out[ij] = o.c_w;
  inv_drag_out[ij] = o.inv_drag;
}

__device__ __forceinline__ Around around(const float* f, int i, int j, int nx, int ny) {
  Around a;
  a.c = f[i * ny + j];
  a.x = at(f, i - 1, j, nx, ny);
  a.y = at(f, i, j - 1, nx, ny);
  a.xy = at(f, i - 1, j - 1, nx, ny);
  return a;
}

__global__ void mevp_velocity_kernel(
    float* __restrict__ u, float* __restrict__ v,
    const float* __restrict__ s11, const float* __restrict__ s22,
    const float* __restrict__ s12, const float* __restrict__ dt_m,
    const float* __restrict__ b_u, const float* __restrict__ b_v,
    const float* __restrict__ u_ocean, const float* __restrict__ v_ocean,
    const float* __restrict__ c_w, const float* __restrict__ inv_drag,
    int nx, int ny, MevpScalars s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ij = i * ny + j;
  const float2 uv = mevp_velocity_body(
      around(s11, i, j, nx, ny), around(s22, i, j, nx, ny), around(s12, i, j, nx, ny),
      u[ij], v[ij], u_ocean[ij], v_ocean[ij], c_w[ij], dt_m[ij], b_u[ij], b_v[ij],
      inv_drag[ij], s);
  u[ij] = uv.x;
  v[ij] = uv.y;
}

}  // namespace nst

extern "C" {

int nst_mevp_n_scalars() { return sizeof(nst::MevpScalars) / sizeof(float); }

// Each entry point launches one kernel on `stream` (the caller's PyTorch
// stream) and returns cudaGetLastError(); it does not synchronise.
int nst_mevp_stress(const float* u, const float* v, float* s11, float* s22,
                    float* s12, const float* strength, const float* dt_m,
                    const float* active, const float* u_ocean,
                    const float* v_ocean, float* c_w, float* inv_drag, int nx,
                    int ny, const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::MevpScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  nst::mevp_stress_kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
                            static_cast<cudaStream_t>(stream)>>>(
      u, v, s11, s22, s12, strength, dt_m, active, u_ocean, v_ocean, c_w,
      inv_drag, nx, ny, s);
  return static_cast<int>(cudaGetLastError());
}

int nst_mevp_velocity(float* u, float* v, const float* s11, const float* s22,
                      const float* s12, const float* dt_m, const float* b_u,
                      const float* b_v, const float* u_ocean,
                      const float* v_ocean, const float* c_w,
                      const float* inv_drag, int nx, int ny,
                      const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::MevpScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  nst::mevp_velocity_kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
                              static_cast<cudaStream_t>(stream)>>>(
      u, v, s11, s22, s12, dt_m, b_u, b_v, u_ocean, v_ocean, c_w, inv_drag,
      nx, ny, s);
  return static_cast<int>(cudaGetLastError());
}

const char* nst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
