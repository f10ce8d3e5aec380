// The higher-order (CG2 velocity, dG1 stress) mEVP subcycle, one element or
// one node index at a time.
//
// Both schedules of the HO mEVP phase call these bodies: ho_single.cu (all
// N subcycles in one cooperative launch, each block's tile resident in its
// shared memory) and ho_tiled.cu (H subcycles per launch on a shared-memory
// window). With --fmad=false they run the same float32 operations in the same order, so
// the two agree bit for bit. The expression order is that of
// MEVPSolverHO.stress_update and MEVPSolverHO.velocity_update in
// nextsimdg_tpu_torch/dynamics/mevp_ho.py.
//
// The table contractions (transport.apply_table in the plain version) run
// densely over every table entry in ascending order: with --fmad=false a
// zero entry adds an exact zero and a unit entry multiplies exactly, which
// is what the plain version's skipped terms amount to. The CG2 tables carry
// entries of ~1e-17 from their quadrature, which the plain version does
// multiply, so they are packed as they are (HoTables). A width divides
// through its float32 reciprocal, as PyTorch on CUDA divides a tensor by a
// Python scalar.
//
// State layout: 17 planes of (nx, ny) float32, in the order of
// coupled_cuda.ho_flatten: u on the owned planes v, b, l, c (0-3), v on them
// (4-7), then the three dG1 coefficients of s11 (8-10), s22 (11-13) and s12
// (14-16). The owned plane of local node n = 3a + b of element (i, j) is
// that of cg2basis.LOCAL_NODE_SOURCE, at (i + a/2, j + b/2) rounded down.
//
// The form of a kernel instance (kForm, a template argument): kHoWeighted,
// the A-weighted stress of MEVPParams.a_weighted_stress, whose ocean drag
// c_w is weighted by the nodal concentration a_{k} of the node's plane (four
// more const planes); kHoMetric, a graded or spherical mesh, whose element
// widths are four more const planes (dx, dy and their float32 reciprocals,
// as MEVPSolverHO.step_consts makes them): the strain multiplies by the
// element's reciprocals, and each of the four elements that share a node
// weights its force contribution by its own widths before the sum. Without
// a bit the code is that of the form without it.
#pragma once

#include "common.cuh"

namespace nst {

constexpr int kHoNodes = 9;          // CG2 nodes of an element
constexpr int kHoCoeffs = 3;         // dG1 coefficients of a stress component
constexpr int kHoGauss = 4;          // 2x2 Gauss points
constexpr int kHoPlanes = 4;         // owned planes of a CG2 field: v, b, l, c
constexpr int kHoStatePlanes = 17;   // 4 + 4 velocity, 3 x 3 stress
constexpr int kHoS11 = 8, kHoS22 = 11, kHoS12 = 14;  // first plane of each stress

// Table entries, in the order that coupled_cuda.py packs them.
struct HoTables {
  float grad_x[kHoCoeffs][kHoNodes];  // grad_x_to_dg1 (c, n)
  float grad_y[kHoCoeffs][kHoNodes];
  float phi[kHoCoeffs][kHoGauss];     // phi_dg1 (c, q)
  float proj[kHoCoeffs][kHoGauss];    // the projection, weights and mass folded in
  float div_x[kHoCoeffs][kHoNodes];   // weak divergence (c, n)
  float div_y[kHoCoeffs][kHoNodes];
};

// Scalars of one subcycle, in the order that coupled_cuda.py packs them.
struct HoScalars {
  float inv_dx, inv_dy;  // float32 reciprocals of the element widths (strain)
  float dx, dy;          // the widths (divergence)
  float c_delta1;        // 1 + 1/e^2
  float c_delta2;        // 1 - 1/e^2
  float c_delta3;        // 4/e^2
  float delta_min;
  float inv_e2;          // 1/e^2
  float inv_alpha;       // 1/alpha
  float rho_cd_ocean;    // rho_ocean * cd_ocean
  float one_plus_beta;   // 1 + beta
  float beta;
  float f_cor;           // Coriolis parameter (0 without Coriolis)
  float neg_f_cor;       // -f_cor
  float dt;              // outer time step [s]
};

// The per-step constant planes of MEVPSolverHO.step_consts, read-only for a
// whole launch: the element strength, then per quantity its four owned
// planes v, b, l, c; the A-weighted form's a_{k} last (null in the
// unweighted form). The host packs them in this order (mevp_ho.HO_WEIGHTED_CONSTS).
struct HoConsts {
  const float* strength;
  const float* dt_m[kHoPlanes];
  const float* active[kHoPlanes];
  const float* b_u[kHoPlanes];
  const float* b_v[kHoPlanes];
  const float* inv_w[kHoPlanes];
  const float* u_ocean[kHoPlanes];
  const float* v_ocean[kHoPlanes];
  const float* a[kHoPlanes];
  const float* dx;      // the metric form's element widths (null in the others)
  const float* dy;
  const float* inv_dx;  // their float32 reciprocals
  const float* inv_dy;
};
constexpr int kHoWeighted = 1;  // the form bit of the A-weighted stress
constexpr int kHoMetric = 2;    // the form bit of a graded or spherical mesh

// The const planes of a form: 29, the four a_{k} in the weighted form and
// the four widths in the metric form.
__host__ __device__ constexpr int ho_const_planes(int form) {
  return 29 + ((form & kHoWeighted) != 0 ? 4 : 0) + ((form & kHoMetric) != 0 ? 4 : 0);
}

// Where the metric form's widths sit among the const planes of a form, in
// the order of HoConsts: dx, dy, inv_dx, inv_dy after the a_{k}.
enum HoWidth { kHoDx, kHoDy, kHoInvDx, kHoInvDy };
__host__ __device__ constexpr int ho_width_plane(int form, int w) {
  return 29 + ((form & kHoWeighted) != 0 ? 4 : 0) + w;
}
__device__ __forceinline__ const float* ho_width(const HoConsts& k, int w) {
  return w == kHoDx ? k.dx : w == kHoDy ? k.dy : w == kHoInvDx ? k.inv_dx : k.inv_dy;
}

// The 9 local node values of element (i, j) of one CG2 field, n = 3a + b
// (gather_local): at(p, di, dj) is owned plane p (0 v, 1 b, 2 l, 3 c) at
// node index (i + di, j + dj), zero beyond the domain.
template <class At>
__device__ __forceinline__ void ho_gather(const At& at, float out[kHoNodes]) {
  out[0] = at(0, 0, 0);  // (0, 0)     vertex (i, j)
  out[1] = at(2, 0, 0);  // (0, 1/2)   left mid (i, j)
  out[2] = at(0, 0, 1);  // (0, 1)     vertex (i, j+1)
  out[3] = at(1, 0, 0);  // (1/2, 0)   bottom mid (i, j)
  out[4] = at(3, 0, 0);  // (1/2, 1/2) centre (i, j)
  out[5] = at(1, 0, 1);  // (1/2, 1)   bottom mid (i, j+1)
  out[6] = at(0, 1, 0);  // (1, 0)     vertex (i+1, j)
  out[7] = at(2, 1, 0);  // (1, 1/2)   left mid (i+1, j)
  out[8] = at(0, 1, 1);  // (1, 1)     vertex (i+1, j+1)
}

// sum_n table[c][n] x[n], ascending n.
__device__ __forceinline__ float ho_row9(const float row[kHoNodes], const float x[kHoNodes]) {
  float acc = row[0] * x[0];
#pragma unroll
  for (int n = 1; n < kHoNodes; ++n) acc = acc + row[n] * x[n];
  return acc;
}

// The stress half of a subcycle at one element: u, v its 9 node velocities,
// s11, s22, s12 its dG1 coefficients (updated in place), strength its ice
// strength, inv_dx and inv_dy the reciprocals of its widths (the scalars'
// on a uniform mesh). Strain, the VP law at the 4 Gauss points, projection
// to dG1 and alpha relaxation.
__device__ __forceinline__ void ho_stress_body(const HoTables& t, const HoScalars& s,
                                               const float u[kHoNodes], const float v[kHoNodes],
                                               float s11[kHoCoeffs], float s22[kHoCoeffs],
                                               float s12[kHoCoeffs], float strength,
                                               float inv_dx, float inv_dy) {
  float e11[kHoCoeffs], e22[kHoCoeffs], e12[kHoCoeffs];
#pragma unroll
  for (int c = 0; c < kHoCoeffs; ++c) {
    const float du_dx = ho_row9(t.grad_x[c], u) * inv_dx;
    const float du_dy = ho_row9(t.grad_y[c], u) * inv_dy;
    const float dv_dx = ho_row9(t.grad_x[c], v) * inv_dx;
    const float dv_dy = ho_row9(t.grad_y[c], v) * inv_dy;
    e11[c] = du_dx;
    e22[c] = dv_dy;
    e12[c] = 0.5f * (du_dy + dv_dx);
  }
  float vp11[kHoGauss], vp22[kHoGauss], vp12[kHoGauss];
#pragma unroll
  for (int q = 0; q < kHoGauss; ++q) {
    float e11q = t.phi[0][q] * e11[0];
    float e22q = t.phi[0][q] * e22[0];
    float e12q = t.phi[0][q] * e12[0];
#pragma unroll
    for (int c = 1; c < kHoCoeffs; ++c) {
      e11q = e11q + t.phi[c][q] * e11[c];
      e22q = e22q + t.phi[c][q] * e22[c];
      e12q = e12q + t.phi[c][q] * e12[c];
    }
    const float delta = sqrtf((e11q * e11q + e22q * e22q) * s.c_delta1 +
                              2.0f * e11q * e22q * s.c_delta2 + s.c_delta3 * e12q * e12q);
    const float inv_denom = 1.0f / (delta + s.delta_min);
    const float zeta = 0.5f * strength * inv_denom;
    const float eta = zeta * s.inv_e2;
    const float p_rep = strength * delta * inv_denom;
    const float div = e11q + e22q;
    vp11[q] = 2.0f * eta * e11q + (zeta - eta) * div - 0.5f * p_rep;
    vp22[q] = 2.0f * eta * e22q + (zeta - eta) * div - 0.5f * p_rep;
    vp12[q] = 2.0f * eta * e12q;
  }
#pragma unroll
  for (int c = 0; c < kHoCoeffs; ++c) {
    float p11 = t.proj[c][0] * vp11[0];
    float p22 = t.proj[c][0] * vp22[0];
    float p12 = t.proj[c][0] * vp12[0];
#pragma unroll
    for (int q = 1; q < kHoGauss; ++q) {
      p11 = p11 + t.proj[c][q] * vp11[q];
      p22 = p22 + t.proj[c][q] * vp22[q];
      p12 = p12 + t.proj[c][q] * vp12[q];
    }
    s11[c] = s11[c] + (p11 - s11[c]) * s.inv_alpha;
    s22[c] = s22[c] + (p22 - s22[c]) * s.inv_alpha;
    s12[c] = s12[c] + (p12 - s12[c]) * s.inv_alpha;
  }
}

// One element's raw force contribution to its local node n:
// -(int sigma . grad phi_n), as (fu, fv) (stress_divergence); w its widths
// (dx, dy).
__device__ __forceinline__ float2 ho_contrib(const HoTables& t, float2 w, int n,
                                             const float s11[kHoCoeffs],
                                             const float s22[kHoCoeffs],
                                             const float s12[kHoCoeffs]) {
  float dx11 = t.div_x[0][n] * s11[0], dy12 = t.div_y[0][n] * s12[0];
  float dx12 = t.div_x[0][n] * s12[0], dy22 = t.div_y[0][n] * s22[0];
#pragma unroll
  for (int c = 1; c < kHoCoeffs; ++c) {
    dx11 = dx11 + t.div_x[c][n] * s11[c];
    dy12 = dy12 + t.div_y[c][n] * s12[c];
    dx12 = dx12 + t.div_x[c][n] * s12[c];
    dy22 = dy22 + t.div_y[c][n] * s22[c];
  }
  return make_float2(-(dx11 * w.y + dy12 * w.x), -(dx12 * w.y + dy22 * w.x));
}

// The raw forces (fu, fv) on the four owned planes of node index (i, j):
// the contributions of the elements that share its nodes, summed in the
// plain version's order (scatter_local, ascending local node n).
// load(di, dj, s11, s22, s12) fills element (i + di, j + dj)'s coefficients,
// zeros beyond the domain; widths(di, dj) gives its (dx, dy).
template <class Load, class Widths>
__device__ __forceinline__ void ho_node_forces(const HoTables& t, const Load& load,
                                               const Widths& widths, float fu[kHoPlanes],
                                               float fv[kHoPlanes]) {
  float a11[kHoCoeffs], a22[kHoCoeffs], a12[kHoCoeffs];
  load(0, 0, a11, a22, a12);  // element (i, j): its nodes 0 (v), 1 (l), 3 (b), 4 (c)
  float2 w = widths(0, 0);
  const float2 c0 = ho_contrib(t, w, 0, a11, a22, a12);
  const float2 c1 = ho_contrib(t, w, 1, a11, a22, a12);
  const float2 c3 = ho_contrib(t, w, 3, a11, a22, a12);
  const float2 c4 = ho_contrib(t, w, 4, a11, a22, a12);
  load(0, -1, a11, a22, a12);  // element (i, j-1): nodes 2 (v), 5 (b)
  w = widths(0, -1);
  const float2 c2 = ho_contrib(t, w, 2, a11, a22, a12);
  const float2 c5 = ho_contrib(t, w, 5, a11, a22, a12);
  load(-1, 0, a11, a22, a12);  // element (i-1, j): nodes 6 (v), 7 (l)
  w = widths(-1, 0);
  const float2 c6 = ho_contrib(t, w, 6, a11, a22, a12);
  const float2 c7 = ho_contrib(t, w, 7, a11, a22, a12);
  load(-1, -1, a11, a22, a12);  // element (i-1, j-1): node 8 (v)
  w = widths(-1, -1);
  const float2 c8 = ho_contrib(t, w, 8, a11, a22, a12);
  fu[0] = c0.x + c2.x + c6.x + c8.x;
  fv[0] = c0.y + c2.y + c6.y + c8.y;
  fu[1] = c3.x + c5.x;
  fv[1] = c3.y + c5.y;
  fu[2] = c1.x + c7.x;
  fv[2] = c1.y + c7.y;
  fu[3] = c4.x;
  fv[3] = c4.y;
}

// The velocity half of a subcycle on one owned plane k of node index (i, j):
// fu, fv its raw forces, uk, vk its velocity; the rest are plane k's consts
// at (i, j) (a_k: read in the weighted form only). One c_w and one shared
// reciprocal per plane.
template <int kForm>
__device__ __forceinline__ float2 ho_velocity_plane(const HoScalars& s, float fu, float fv,
                                                    float uk, float vk, float uo, float vo,
                                                    float dm, float active, float b_u,
                                                    float b_v, float inv_w, float a_k) {
  const float rel_u = uo - uk;
  const float rel_v = vo - vk;
  float c_w = s.rho_cd_ocean * sqrtf(rel_u * rel_u + rel_v * rel_v);
  if constexpr ((kForm & kHoWeighted) != 0) c_w = c_w * a_k;  // tau_w = A c_w (v_w - v)
  const float cor_u = s.f_cor * (vk - vo);
  const float cor_v = s.neg_f_cor * (uk - uo);
  const float inv_drag = active / (s.one_plus_beta + dm * c_w);
  float2 uv;
  uv.x = (s.beta * uk + b_u + dm * (fu * inv_w + c_w * uo) + s.dt * cor_u) * inv_drag;
  uv.y = (s.beta * vk + b_v + dm * (fv * inv_w + c_w * vo) + s.dt * cor_v) * inv_drag;
  return uv;
}

// The per-plane consts of the velocity half, in the order of HoConsts after
// strength: const q of owned plane p is HoConsts plane 1 + 4 q + p (kHoA:
// the weighted form's).
enum HoPlaneConst { kHoDtM, kHoActive, kHoBU, kHoBV, kHoInvW, kHoUOcean, kHoVOcean, kHoA };

// The per-plane consts of a form: 7, and a_{k} in the weighted form.
__host__ __device__ constexpr int ho_plane_consts(int form) {
  return (form & kHoWeighted) != 0 ? 8 : 7;
}

__device__ __forceinline__ const float* ho_const_plane(const HoConsts& k, int q, int p) {
  switch (q) {
    case kHoDtM: return k.dt_m[p];
    case kHoActive: return k.active[p];
    case kHoBU: return k.b_u[p];
    case kHoBV: return k.b_v[p];
    case kHoInvW: return k.inv_w[p];
    case kHoUOcean: return k.u_ocean[p];
    case kHoVOcean: return k.v_ocean[p];
    default: return k.a[p];
  }
}

// The velocity half at one node index, all four planes: forces from
// `load` and `widths` (ho_node_forces), then each plane's update from `uv`
// (the 8 velocity values, u planes then v planes, updated in place) and its
// consts, konst(q, p) for const q (HoPlaneConst) of plane p.
template <int kForm, class Load, class Widths, class Konst>
__device__ __forceinline__ void ho_velocity_update(const HoTables& t, const HoScalars& s,
                                                   const Konst& konst, const Load& load,
                                                   const Widths& widths,
                                                   float uv[2 * kHoPlanes]) {
  float fu[kHoPlanes], fv[kHoPlanes];
  ho_node_forces(t, load, widths, fu, fv);
#pragma unroll
  for (int p = 0; p < kHoPlanes; ++p) {
    const float2 out = ho_velocity_plane<kForm>(
        s, fu[p], fv[p], uv[p], uv[kHoPlanes + p], konst(kHoUOcean, p), konst(kHoVOcean, p),
        konst(kHoDtM, p), konst(kHoActive, p), konst(kHoBU, p), konst(kHoBV, p),
        konst(kHoInvW, p), (kForm & kHoWeighted) != 0 ? konst(kHoA, p) : 1.0f);
    uv[p] = out.x;
    uv[kHoPlanes + p] = out.y;
  }
}

// The same at node index (i, j) (flat index ij), its consts read from the
// const planes in global memory.
template <int kForm, class Load, class Widths>
__device__ __forceinline__ void ho_velocity_body(const HoTables& t, const HoScalars& s,
                                                 const HoConsts& k, long ij, const Load& load,
                                                 const Widths& widths, float uv[2 * kHoPlanes]) {
  ho_velocity_update<kForm>(t, s,
                            [&](int q, int p) { return __ldg(ho_const_plane(k, q, p) + ij); },
                            load, widths, uv);
}

// The widths of every element on a uniform mesh: the scalars'.
__device__ __forceinline__ float2 ho_uniform_widths(const HoScalars& s) {
  return make_float2(s.dx, s.dy);
}

}  // namespace nst
