// The CG1 mEVP subcycle, one element or one node at a time.
//
// The three schedules of the mEVP phase call these bodies: mevp.cu (two
// grid-wide launches per subcycle), mevp_tiled.cu (H subcycles per launch
// on a shared-memory window) and mevp_single.cu (all N subcycles in one
// cooperative launch, on tiles resident in shared memory). With --fmad=false they run the same float32
// operations in the same order, so the schedules agree bit for bit.
// The expression order is that of MEVPSolver.stress_update and
// MEVPSolver.velocity_update in nextsimdg_tpu_torch/dynamics/mevp.py. On a
// uniform mesh a division by the element width is a multiply by its
// float32 reciprocal, which is what PyTorch on CUDA does for a tensor
// divided by a Python scalar (and it keeps the kernels off the division's
// slow path for the zero strain rates of a fluid at rest). On a graded or
// spherical mesh the widths arrive as the metric const planes instead.
//
// The momentum forms of MEVPParams are a template argument of the bodies
// and of every kernel that calls them (kForm, bits of the host's `form`):
// kFormWeighted (a_weighted_stress) multiplies c_w by the a_node const
// plane; kFormAdaptive (adaptive_alpha) gives up the shared divide for two
// divides and a square root, and hands each node's alpha = beta from the
// stress half to the velocity half. Form 0 is the unweighted fixed-alpha
// subcycle, the same operations as before the forms existed. Divides and
// square roots are IEEE-rounded (nvcc's defaults, as PyTorch's CUDA
// kernels compute 1 / tensor and torch.sqrt), so each form equals its
// plain version on the card too.
#pragma once

#include "common.cuh"

namespace nst {

// Scalars of one subcycle, in the order that coupled_cuda.py packs them.
// The geometric ones (inv_dx, inv_dy, half_dx, half_dy, inv_w) are NaN on a
// non-uniform mesh, whose kernels read the metric planes instead.
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
  float alpha_min;         // the adaptive form's floor of alpha = beta
  float c_stab;            // the adaptive form's factor of sqrt(zeta dt_m / area)
};

// The momentum forms (MEVPParams): bits of a kernel's kForm.
constexpr int kFormWeighted = 1;  // a_weighted_stress: c_w times a_node
constexpr int kFormAdaptive = 2;  // adaptive_alpha: per-node alpha = beta
constexpr int kForms = 4;

// The per-step constant planes, read-only for a whole launch (so they may
// be read through the read-only data path). Then the five metric planes of
// a graded or spherical mesh, null on a uniform one, and the nodal
// concentration of the A-weighted form, null without it; the host packs
// them in this order (mevp.MEVP_CONSTS).
struct MevpConsts {
  const float* strength;
  const float* dt_m;
  const float* active;
  const float* b_u;
  const float* b_v;
  const float* u_ocean;
  const float* v_ocean;
  const float* inv_dx;   // per element
  const float* inv_dy;
  const float* half_dx;  // per element
  const float* half_dy;
  const float* inv_w;    // per node: 1 / (the node's lumped area)
  const float* a_node;   // per node: the lumped concentration in [0, 1]
};
constexpr int kMevpConstPlanes = 13;
// The planes by number, in that order.
constexpr int kStrength = 0, kDtM = 1, kActive = 2, kBu = 3, kBv = 4, kUo = 5, kVo = 6,
              kInvDx = 7, kInvDy = 8, kHalfDx = 9, kHalfDy = 10, kInvW = 11, kANode = 12;

// Const plane p of MevpConsts, read from the kernel's parameters where it is
// used (p is a constant at every call, so the switch folds away).
__device__ __forceinline__ const float* mevp_const_plane(const MevpConsts& k, int p) {
  switch (p) {
    case kStrength: return k.strength;
    case kDtM: return k.dt_m;
    case kActive: return k.active;
    case kBu: return k.b_u;
    case kBv: return k.b_v;
    case kUo: return k.u_ocean;
    case kVo: return k.v_ocean;
    case kInvDx: return k.inv_dx;
    case kInvDy: return k.inv_dy;
    case kHalfDx: return k.half_dx;
    case kHalfDy: return k.half_dy;
    case kInvW: return k.inv_w;
    default: return k.a_node;
  }
}

// Element (i, j): velocities at its corner nodes (i, j), (i+1, j), (i, j+1),
// (i+1, j+1), its stresses and its inverse widths in; the alpha-relaxed
// stresses out, plus node (i, j)'s c_w and inv_drag (the two share one
// divide with the element) and its beta (s.beta, or in the adaptive form
// the node's own). Element (i, j)'s zeta and node (i, j)'s dt_m share an
// index. a_node: node (i, j)'s concentration (read in the weighted form);
// inv_area: its 1/(lumped area) (read in the adaptive form: the inv_w
// plane, or s.inv_w on a uniform mesh).
struct StressOut {
  float s11, s22, s12, c_w, inv_drag, beta;
};

template <int kForm = 0>
__device__ __forceinline__ StressOut mevp_stress_body(
    float u00, float u10, float u01, float u11, float v00, float v10, float v01,
    float v11, float a11, float a22, float a12, float strength, float dt_m,
    float active, float u_ocean, float v_ocean, float inv_dx, float inv_dy,
    const MevpScalars& s, float a_node = 1.0f, float inv_area = 0.0f) {
  // Strain rates from the element's four corner nodes.
  const float e11 = 0.5f * ((u10 - u00) + (u11 - u01)) * inv_dx;
  const float e22 = 0.5f * ((v01 - v00) + (v11 - v10)) * inv_dy;
  const float du_dy = 0.5f * ((u01 - u00) + (u11 - u10)) * inv_dy;
  const float dv_dx = 0.5f * ((v10 - v00) + (v11 - v01)) * inv_dx;
  const float e12 = 0.5f * (du_dy + dv_dx);
  const float delta = sqrtf((e11 * e11 + e22 * e22) * s.c_delta1 +
                            2.0f * e11 * e22 * s.c_delta2 +
                            s.c_delta3 * e12 * e12);

  const float rel_u = u_ocean - u00;
  const float rel_v = v_ocean - v00;
  float c_w = s.rho_cd_ocean * sqrtf(rel_u * rel_u + rel_v * rel_v);
  if constexpr ((kForm & kFormWeighted) != 0) c_w = c_w * a_node;  // the A-weighted drag
  const float denom_rheo = delta + s.delta_min;
  float inv_denom, inv_drag, zeta, inv_alpha, beta;
  if constexpr ((kForm & kFormAdaptive) != 0) {
    // alpha depends on zeta: two divides, and the square root of the
    // stability bound (max as torch.clamp: a NaN stays NaN).
    inv_denom = 1.0f / denom_rheo;
    zeta = 0.5f * strength * inv_denom;
    const float bound = s.c_stab * sqrtf(zeta * dt_m * inv_area);
    const float alpha = bound < s.alpha_min ? s.alpha_min : bound;
    beta = alpha;
    inv_drag = active / (1.0f + beta + dt_m * c_w);
    inv_alpha = 1.0f / alpha;
  } else {
    // The shared divide: element (i, j)'s Delta + Delta_min and node
    // (i, j)'s 1 + beta + dt_m c_w.
    const float denom_drag = s.one_plus_beta + dt_m * c_w;
    const float inv_both = 1.0f / (denom_rheo * denom_drag);
    inv_denom = inv_both * denom_drag;
    inv_drag = active * (inv_both * denom_rheo);
    zeta = 0.5f * strength * inv_denom;
    inv_alpha = s.inv_alpha;
    beta = s.beta;
  }
  const float eta = zeta * s.inv_e2;
  const float p_rep = strength * delta * inv_denom;

  const float div = e11 + e22;
  const float s11_vp = 2.0f * eta * e11 + (zeta - eta) * div - 0.5f * p_rep;
  const float s22_vp = 2.0f * eta * e22 + (zeta - eta) * div - 0.5f * p_rep;
  const float s12_vp = 2.0f * eta * e12;
  StressOut out;
  out.s11 = a11 + (s11_vp - a11) * inv_alpha;
  out.s22 = a22 + (s22_vp - a22) * inv_alpha;
  out.s12 = a12 + (s12_vp - a12) * inv_alpha;
  out.c_w = c_w;
  out.inv_drag = inv_drag;
  out.beta = beta;
  return out;
}

// One element plane around node (i, j): elements (i, j), (i-1, j), (i, j-1)
// and (i-1, j-1); a missing element (a wall) is a zero.
struct Around {
  float c, x, y, xy;
};

// Node (i, j)'s stress divergence (before the 1/W normalisation) on a
// uniform mesh: the single-component scatters go through t = cell + shift,
// as the plain version's 13-shift factoring does.
__device__ __forceinline__ float2 forces_uniform(const Around& s11, const Around& s22,
                                                 const Around& s12, const MevpScalars& s) {
  const float t11 = s11.c + s11.y;
  const float t11_m = s11.x + s11.xy;
  const float t22 = s22.c + s22.x;
  const float t22_m = s22.y + s22.xy;
  float2 f;
  f.x = s.half_dy * (t11 - t11_m) + s.half_dx * ((s12.x + s12.c) - (s12.xy + s12.y));
  f.y = s.half_dy * ((s12.y + s12.c) - (s12.xy + s12.x)) + s.half_dx * (t22 - t22_m);
  return f;
}

// The same on a graded or spherical mesh, from stresses already weighted by
// their own element's half face length: w11 = s11 half_dy,
// w12_dx = s12 half_dx, w12_dy = s12 half_dy, w22 = s22 half_dx (the plain
// version's scatter_x_m and scatter_y_m).
__device__ __forceinline__ float2 forces_metric(const Around& w11, const Around& w12_dx,
                                                const Around& w12_dy, const Around& w22) {
  float2 f;
  f.x = ((w11.y + w11.c) - (w11.xy + w11.x)) + ((w12_dx.x + w12_dx.c) - (w12_dx.xy + w12_dx.y));
  f.y = ((w12_dy.y + w12_dy.c) - (w12_dy.xy + w12_dy.x)) + ((w22.x + w22.c) - (w22.xy + w22.y));
  return f;
}

// Node (i, j): the new (u, v) from its forces f (normalised here by inv_w)
// and the beta-relaxed update with semi-implicit ocean drag; beta is
// s.beta, or in the adaptive form the node's own from the stress half.
__device__ __forceinline__ float2 mevp_velocity_body(
    float2 f, float inv_w, float u0, float v0, float u_ocean, float v_ocean, float c_w,
    float dt_m, float b_u, float b_v, float inv_drag, float beta, const MevpScalars& s) {
  const float fu = f.x * inv_w;
  const float fv = f.y * inv_w;
  const float cor_u = s.f_cor * (v0 - v_ocean);
  const float cor_v = s.neg_f_cor * (u0 - u_ocean);
  float2 uv;
  uv.x = (beta * u0 + b_u + dt_m * (fu + c_w * u_ocean) + s.dt * cor_u) * inv_drag;
  uv.y = (beta * v0 + b_v + dt_m * (fv + c_w * v_ocean) + s.dt * cor_v) * inv_drag;
  return uv;
}

// The fixed-beta form (every schedule's form 0).
__device__ __forceinline__ float2 mevp_velocity_body(
    float2 f, float inv_w, float u0, float v0, float u_ocean, float v_ocean, float c_w,
    float dt_m, float b_u, float b_v, float inv_drag, const MevpScalars& s) {
  return mevp_velocity_body(f, inv_w, u0, v0, u_ocean, v_ocean, c_w, dt_m, b_u, b_v, inv_drag,
                            s.beta, s);
}

// The form's extra operands of the stress body at element/node ij: a_node
// (weighted) and 1/area (adaptive: the inv_w plane on a metric mesh, else
// s.inv_w); 1 and 0 where the form does not read them.
template <int kForm>
__device__ __forceinline__ float form_a_node(const MevpConsts& k, int ij) {
  return (kForm & kFormWeighted) != 0 ? __ldg(k.a_node + ij) : 1.0f;
}
template <bool kMetric, int kForm>
__device__ __forceinline__ float form_inv_area(const MevpConsts& k, int ij, const MevpScalars& s) {
  return (kForm & kFormAdaptive) == 0 ? 0.0f : kMetric ? __ldg(k.inv_w + ij) : s.inv_w;
}

// A read-only const plane at (i, j), or 0 beyond the owned range.
__device__ __forceinline__ float ldg_at(const float* f, int i, int j, int nx, int ny) {
  return (i >= 0 && i < nx && j >= 0 && j < ny) ? __ldg(f + i * ny + j) : 0.0f;
}

// The state planes of the grid-wide schedules, updated in place. They are
// written during the launch (by this or another block), so they are never
// read through the read-only data path. beta: the adaptive form's node
// plane (null in the others).
struct MevpState {
  float *u, *v, *s11, *s22, *s12, *c_w, *inv_drag, *beta;
};

// A neighbour's value for the grid-wide kernels: at() on a closed domain
// (kWrap false: the closed instances), at_wrap() on the axes of `wrap`.
template <bool kWrap>
__device__ __forceinline__ float neighbour_at(const float* f, int i, int j, int nx, int ny,
                                              int wrap) {
  return kWrap ? at_wrap(f, i, j, nx, ny, wrap) : at(f, i, j, nx, ny);
}

// The stress half of a subcycle at element (i, j), from and into global
// memory: reads u, v at the element's four nodes and its own stresses;
// writes its stresses and node (i, j)'s c_w and inv_drag (and beta).
// kWrap: the periodic form (the axes of `wrap` wrap node nx to node 0).
template <bool kMetric, int kForm, bool kWrap = false>
__device__ __forceinline__ void stress_cell(const MevpState& p, const MevpConsts& k, int i,
                                            int j, int nx, int ny, const MevpScalars& s,
                                            int wrap = 0) {
  const int ij = i * ny + j;
  const float inv_dx = kMetric ? __ldg(k.inv_dx + ij) : s.inv_dx;
  const float inv_dy = kMetric ? __ldg(k.inv_dy + ij) : s.inv_dy;
  const auto at = [&](const float* f, int a, int b, int, int) {
    return neighbour_at<kWrap>(f, a, b, nx, ny, wrap);
  };
  const StressOut o = mevp_stress_body<kForm>(
      p.u[ij], at(p.u, i + 1, j, nx, ny), at(p.u, i, j + 1, nx, ny),
      at(p.u, i + 1, j + 1, nx, ny), p.v[ij], at(p.v, i + 1, j, nx, ny),
      at(p.v, i, j + 1, nx, ny), at(p.v, i + 1, j + 1, nx, ny), p.s11[ij], p.s22[ij],
      p.s12[ij], __ldg(k.strength + ij), __ldg(k.dt_m + ij), __ldg(k.active + ij),
      __ldg(k.u_ocean + ij), __ldg(k.v_ocean + ij), inv_dx, inv_dy, s,
      form_a_node<kForm>(k, ij), form_inv_area<kMetric, kForm>(k, ij, s));
  p.s11[ij] = o.s11;
  p.s22[ij] = o.s22;
  p.s12[ij] = o.s12;
  p.c_w[ij] = o.c_w;
  p.inv_drag[ij] = o.inv_drag;
  if constexpr ((kForm & kFormAdaptive) != 0) p.beta[ij] = o.beta;
}

__device__ __forceinline__ Around around(const float* f, int i, int j, int nx, int ny) {
  return {f[i * ny + j], at(f, i - 1, j, nx, ny), at(f, i, j - 1, nx, ny),
          at(f, i - 1, j - 1, nx, ny)};
}

// f times the metric plane w around node (i, j), element by element.
__device__ __forceinline__ Around weighted(const float* f, const float* w, int i, int j,
                                          int nx, int ny) {
  return {f[i * ny + j] * __ldg(w + i * ny + j), at(f, i - 1, j, nx, ny) * ldg_at(w, i - 1, j, nx, ny),
          at(f, i, j - 1, nx, ny) * ldg_at(w, i, j - 1, nx, ny),
          at(f, i - 1, j - 1, nx, ny) * ldg_at(w, i - 1, j - 1, nx, ny)};
}

// The periodic forms of around() and weighted(): the elements before node
// (i, j) wrap on the axes of `wrap`.
__device__ __forceinline__ Around around_wrap(const float* f, int i, int j, int nx, int ny,
                                              int wrap) {
  return {f[i * ny + j], at_wrap(f, i - 1, j, nx, ny, wrap), at_wrap(f, i, j - 1, nx, ny, wrap),
          at_wrap(f, i - 1, j - 1, nx, ny, wrap)};
}

__device__ __forceinline__ float ldg_at_wrap(const float* f, int i, int j, int nx, int ny,
                                             int wrap) {
  wrap_near_ij(i, j, nx, ny, wrap);
  return ldg_at(f, i, j, nx, ny);
}

__device__ __forceinline__ Around weighted_wrap(const float* f, const float* w, int i, int j,
                                                int nx, int ny, int wrap) {
  return {f[i * ny + j] * __ldg(w + i * ny + j),
          at_wrap(f, i - 1, j, nx, ny, wrap) * ldg_at_wrap(w, i - 1, j, nx, ny, wrap),
          at_wrap(f, i, j - 1, nx, ny, wrap) * ldg_at_wrap(w, i, j - 1, nx, ny, wrap),
          at_wrap(f, i - 1, j - 1, nx, ny, wrap) * ldg_at_wrap(w, i - 1, j - 1, nx, ny, wrap)};
}

// weighted_tile() where (i, j) is the node's domain index (already wrapped)
// and the elements before it wrap on the axes of `wrap` (the metric plane
// f read at their wrapped indices); 0 beyond a closed wall.
__device__ __forceinline__ Around weighted_tile_wrap(const float* s, const float* f, int c, int w,
                                                    int i, int j, int nx, int ny, int wrap) {
  const int iu = i > 0 ? i - 1 : ((wrap & kWrapX) ? nx - 1 : -1);
  const int jl = j > 0 ? j - 1 : ((wrap & kWrapY) ? ny - 1 : -1);
  return {s[c] * __ldg(f + i * ny + j), s[c - w] * (iu >= 0 ? __ldg(f + iu * ny + j) : 0.0f),
          s[c - 1] * (jl >= 0 ? __ldg(f + i * ny + jl) : 0.0f),
          s[c - w - 1] * (iu >= 0 && jl >= 0 ? __ldg(f + iu * ny + jl) : 0.0f)};
}

// The stresses s around node (i, j) of the domain, at index c of a
// shared-memory window whose rows are w wide (the stresses of the elements
// before it at c - w, c - 1 and c - w - 1), times the metric plane f of
// their own element, read through the read-only path; 0 beyond the domain.
__device__ __forceinline__ Around weighted_tile(const float* s, const float* f, int c, int w,
                                               int ij, int i, int j, int nx, int ny) {
  const bool up = i > 0, left = j > 0;
  return {s[c] * __ldg(f + ij), s[c - w] * (up ? __ldg(f + ij - ny) : 0.0f),
          s[c - 1] * (left ? __ldg(f + ij - 1) : 0.0f),
          s[c - w - 1] * (up && left ? __ldg(f + ij - ny - 1) : 0.0f)};
}

// The velocity half of a subcycle at node (i, j), from and into global
// memory: reads the stresses of its four elements and its own u, v, c_w and
// inv_drag (and beta); writes u and v. kWrap: the periodic form.
template <bool kMetric, int kForm, bool kWrap = false>
__device__ __forceinline__ void velocity_cell(const MevpState& p, const MevpConsts& k, int i,
                                              int j, int nx, int ny, const MevpScalars& s,
                                              int wrap = 0) {
  const int ij = i * ny + j;
  const auto weighted = [&](const float* f, const float* w, int a, int b, int, int) {
    return kWrap ? weighted_wrap(f, w, a, b, nx, ny, wrap) : nst::weighted(f, w, a, b, nx, ny);
  };
  const auto around = [&](const float* f, int a, int b, int, int) {
    return kWrap ? around_wrap(f, a, b, nx, ny, wrap) : nst::around(f, a, b, nx, ny);
  };
  float2 f;
  float inv_w;
  if (kMetric) {
    f = forces_metric(weighted(p.s11, k.half_dy, i, j, nx, ny),
                      weighted(p.s12, k.half_dx, i, j, nx, ny),
                      weighted(p.s12, k.half_dy, i, j, nx, ny),
                      weighted(p.s22, k.half_dx, i, j, nx, ny));
    inv_w = __ldg(k.inv_w + ij);
  } else {
    f = forces_uniform(around(p.s11, i, j, nx, ny), around(p.s22, i, j, nx, ny),
                       around(p.s12, i, j, nx, ny), s);
    inv_w = s.inv_w;
  }
  const float2 uv = mevp_velocity_body(
      f, inv_w, p.u[ij], p.v[ij], __ldg(k.u_ocean + ij), __ldg(k.v_ocean + ij), p.c_w[ij],
      __ldg(k.dt_m + ij), __ldg(k.b_u + ij), __ldg(k.b_v + ij), p.inv_drag[ij],
      (kForm & kFormAdaptive) != 0 ? p.beta[ij] : s.beta, s);
  p.u[ij] = uv.x;
  p.v[ij] = uv.y;
}

}  // namespace nst
