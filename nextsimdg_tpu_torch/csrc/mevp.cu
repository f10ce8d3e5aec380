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
// The expression order is that of MEVPSolver.stress_update and
// MEVPSolver.velocity_update in nextsimdg_tpu_torch/dynamics/mevp.py.
#include <cstring>

#include "common.cuh"

namespace nst {

// Scalars of one subcycle, in the order that coupled_cuda.py packs them.
struct MevpScalars {
  float dx, dy;            // element widths [m]
  float c_delta1;          // 1 + 1/e^2
  float c_delta2;          // 1 - 1/e^2
  float c_delta3;          // 4/e^2
  float rho_cd_ocean;      // rho_ocean * cd_ocean
  float delta_min;
  float one_plus_beta;     // 1 + beta
  float inv_e2;            // 1/e^2
  float inv_alpha;         // 1/alpha
  float half_dx, half_dy;  // 0.5 dx, 0.5 dy
  float inv_w;             // 1/(dx dy)
  float beta;
  float f_cor;             // Coriolis parameter (0 without Coriolis)
  float neg_f_cor;         // -f_cor
  float dt;                // outer time step [s]
};

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

  // Strain rates from the element's four corner nodes.
  const float u00 = u[ij], v00 = v[ij];
  const float u10 = at(u, i + 1, j, nx, ny), v10 = at(v, i + 1, j, nx, ny);
  const float u01 = at(u, i, j + 1, nx, ny), v01 = at(v, i, j + 1, nx, ny);
  const float u11 = at(u, i + 1, j + 1, nx, ny), v11 = at(v, i + 1, j + 1, nx, ny);
  const float e11 = 0.5f * ((u10 - u00) + (u11 - u01)) / s.dx;
  const float e22 = 0.5f * ((v01 - v00) + (v11 - v10)) / s.dy;
  const float du_dy = 0.5f * ((u01 - u00) + (u11 - u10)) / s.dy;
  const float dv_dx = 0.5f * ((v10 - v00) + (v11 - v01)) / s.dx;
  const float e12 = 0.5f * (du_dy + dv_dx);
  const float delta = sqrtf((e11 * e11 + e22 * e22) * s.c_delta1 +
                            2.0f * e11 * e22 * s.c_delta2 +
                            s.c_delta3 * e12 * e12);

  // The shared divide: element (i, j)'s Delta + Delta_min and node (i, j)'s
  // 1 + beta + dt_m c_w.
  const float rel_u = u_ocean[ij] - u00;
  const float rel_v = v_ocean[ij] - v00;
  const float c_w = s.rho_cd_ocean * sqrtf(rel_u * rel_u + rel_v * rel_v);
  const float denom_rheo = delta + s.delta_min;
  const float denom_drag = s.one_plus_beta + dt_m[ij] * c_w;
  const float inv_both = 1.0f / (denom_rheo * denom_drag);
  const float inv_denom = inv_both * denom_drag;
  const float inv_drag = active[ij] * (inv_both * denom_rheo);
  const float p = strength[ij];
  const float zeta = 0.5f * p * inv_denom;
  const float eta = zeta * s.inv_e2;
  const float p_rep = p * delta * inv_denom;

  const float div = e11 + e22;
  const float s11_vp = 2.0f * eta * e11 + (zeta - eta) * div - 0.5f * p_rep;
  const float s22_vp = 2.0f * eta * e22 + (zeta - eta) * div - 0.5f * p_rep;
  const float s12_vp = 2.0f * eta * e12;
  const float a11 = s11[ij], a22 = s22[ij], a12 = s12[ij];
  s11[ij] = a11 + (s11_vp - a11) * s.inv_alpha;
  s22[ij] = a22 + (s22_vp - a22) * s.inv_alpha;
  s12[ij] = a12 + (s12_vp - a12) * s.inv_alpha;
  c_w_out[ij] = c_w;
  inv_drag_out[ij] = inv_drag;
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

  // Stress divergence: node (i, j) reads elements (i-1..i, j-1..j). The
  // single-component scatters go through t = cell + shift, as the plain
  // version's 13-shift factoring does.
  const float t11 = s11[ij] + at(s11, i, j - 1, nx, ny);
  const float t11_m = at(s11, i - 1, j, nx, ny) + at(s11, i - 1, j - 1, nx, ny);
  const float t22 = s22[ij] + at(s22, i - 1, j, nx, ny);
  const float t22_m = at(s22, i, j - 1, nx, ny) + at(s22, i - 1, j - 1, nx, ny);
  const float c12 = s12[ij];
  const float c12_x = at(s12, i - 1, j, nx, ny);
  const float c12_y = at(s12, i, j - 1, nx, ny);
  const float c12_xy = at(s12, i - 1, j - 1, nx, ny);
  float fu = s.half_dy * (t11 - t11_m) + s.half_dx * ((c12_x + c12) - (c12_xy + c12_y));
  float fv = s.half_dy * ((c12_y + c12) - (c12_xy + c12_x)) + s.half_dx * (t22 - t22_m);
  fu = fu * s.inv_w;
  fv = fv * s.inv_w;

  const float u0 = u[ij], v0 = v[ij];
  const float uo = u_ocean[ij], vo = v_ocean[ij];
  const float cw = c_w[ij], dtm = dt_m[ij];
  const float cor_u = s.f_cor * (v0 - vo);
  const float cor_v = s.neg_f_cor * (u0 - uo);
  u[ij] = (s.beta * u0 + b_u[ij] + dtm * (fu + cw * uo) + s.dt * cor_u) * inv_drag[ij];
  v[ij] = (s.beta * v0 + b_v[ij] + dtm * (fv + cw * vo) + s.dt * cor_v) * inv_drag[ij];
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
