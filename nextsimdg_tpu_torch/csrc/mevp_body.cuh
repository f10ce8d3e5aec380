// The CG1 mEVP subcycle, one element or one node at a time.
//
// Both schedules of the mEVP phase call these two bodies: mevp.cu (two
// grid-wide launches per subcycle) and mevp_tiled.cu (H subcycles per launch
// on a shared-memory window). With --fmad=false they run the same float32
// operations in the same order, so the two schedules agree bit for bit.
// The expression order is that of MEVPSolver.stress_update and
// MEVPSolver.velocity_update in nextsimdg_tpu_torch/dynamics/mevp.py. A
// division by the element width is a multiply by its float32 reciprocal,
// which is what PyTorch on CUDA does for a tensor divided by a Python
// scalar (and it keeps the kernels off the division's slow path for the
// zero strain rates of a fluid at rest).
#pragma once

#include "common.cuh"

namespace nst {

// Scalars of one subcycle, in the order that coupled_cuda.py packs them.
struct MevpScalars {
  float inv_dx, inv_dy;    // float32 reciprocals of the element widths
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

// Element (i, j): velocities at its corner nodes (i, j), (i+1, j), (i, j+1),
// (i+1, j+1) and its stresses in; the alpha-relaxed stresses out, plus node
// (i, j)'s c_w and inv_drag (the two share one divide with the element).
struct StressOut {
  float s11, s22, s12, c_w, inv_drag;
};

__device__ __forceinline__ StressOut mevp_stress_body(
    float u00, float u10, float u01, float u11, float v00, float v10, float v01,
    float v11, float a11, float a22, float a12, float strength, float dt_m,
    float active, float u_ocean, float v_ocean, const MevpScalars& s) {
  // Strain rates from the element's four corner nodes.
  const float e11 = 0.5f * ((u10 - u00) + (u11 - u01)) * s.inv_dx;
  const float e22 = 0.5f * ((v01 - v00) + (v11 - v10)) * s.inv_dy;
  const float du_dy = 0.5f * ((u01 - u00) + (u11 - u10)) * s.inv_dy;
  const float dv_dx = 0.5f * ((v10 - v00) + (v11 - v01)) * s.inv_dx;
  const float e12 = 0.5f * (du_dy + dv_dx);
  const float delta = sqrtf((e11 * e11 + e22 * e22) * s.c_delta1 +
                            2.0f * e11 * e22 * s.c_delta2 +
                            s.c_delta3 * e12 * e12);

  // The shared divide: element (i, j)'s Delta + Delta_min and node (i, j)'s
  // 1 + beta + dt_m c_w.
  const float rel_u = u_ocean - u00;
  const float rel_v = v_ocean - v00;
  const float c_w = s.rho_cd_ocean * sqrtf(rel_u * rel_u + rel_v * rel_v);
  const float denom_rheo = delta + s.delta_min;
  const float denom_drag = s.one_plus_beta + dt_m * c_w;
  const float inv_both = 1.0f / (denom_rheo * denom_drag);
  const float inv_denom = inv_both * denom_drag;
  const float inv_drag = active * (inv_both * denom_rheo);
  const float zeta = 0.5f * strength * inv_denom;
  const float eta = zeta * s.inv_e2;
  const float p_rep = strength * delta * inv_denom;

  const float div = e11 + e22;
  const float s11_vp = 2.0f * eta * e11 + (zeta - eta) * div - 0.5f * p_rep;
  const float s22_vp = 2.0f * eta * e22 + (zeta - eta) * div - 0.5f * p_rep;
  const float s12_vp = 2.0f * eta * e12;
  StressOut out;
  out.s11 = a11 + (s11_vp - a11) * s.inv_alpha;
  out.s22 = a22 + (s22_vp - a22) * s.inv_alpha;
  out.s12 = a12 + (s12_vp - a12) * s.inv_alpha;
  out.c_w = c_w;
  out.inv_drag = inv_drag;
  return out;
}

// One stress plane around node (i, j): elements (i, j), (i-1, j), (i, j-1)
// and (i-1, j-1); a missing element (a wall) is a zero.
struct Around {
  float c, x, y, xy;
};

// Node (i, j): the new (u, v) from the stress divergence of its four
// elements and the beta-relaxed update with semi-implicit ocean drag. The
// single-component scatters go through t = cell + shift, as the plain
// version's 13-shift factoring does.
__device__ __forceinline__ float2 mevp_velocity_body(
    const Around& s11, const Around& s22, const Around& s12, float u0, float v0,
    float u_ocean, float v_ocean, float c_w, float dt_m, float b_u, float b_v,
    float inv_drag, const MevpScalars& s) {
  const float t11 = s11.c + s11.y;
  const float t11_m = s11.x + s11.xy;
  const float t22 = s22.c + s22.x;
  const float t22_m = s22.y + s22.xy;
  float fu = s.half_dy * (t11 - t11_m) + s.half_dx * ((s12.x + s12.c) - (s12.xy + s12.y));
  float fv = s.half_dy * ((s12.y + s12.c) - (s12.xy + s12.x)) + s.half_dx * (t22 - t22_m);
  fu = fu * s.inv_w;
  fv = fv * s.inv_w;

  const float cor_u = s.f_cor * (v0 - v_ocean);
  const float cor_v = s.neg_f_cor * (u0 - u_ocean);
  float2 uv;
  uv.x = (s.beta * u0 + b_u + dt_m * (fu + c_w * u_ocean) + s.dt * cor_u) * inv_drag;
  uv.y = (s.beta * v0 + b_v + dt_m * (fv + c_w * v_ocean) + s.dt * cor_v) * inv_drag;
  return uv;
}

}  // namespace nst
