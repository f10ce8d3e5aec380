// One SSP-RK stage of the DG transport (dG0, dG1 or dG2): the face fluxes,
// the element update and the positivity limiter, templated on the degree.
//
// Both schedules of the transport phase run these bodies: transport.cu
// (dg1_rk_stage, one launch per RK stage: each face's flux computed once by
// dg1_face_flux and shared by its two elements' dg1_stage_update) and
// transport_tiled.cu (whole substeps per launch on a shared-memory window:
// dg1_stage_cell, an element's four fluxes and its update in one body).
// With --fmad=false they run the same float32 operations on the same
// values, so they agree bit for bit at every degree. dg1_stage_cell keeps
// the operations of dg1_face_flux and dg1_stage_update written out:
// composed from them, transport_tiled compiled to other registers and ran
// 2% slower on the H100 (PERF.md). Both schedules take the velocity sampled
// from the CG1 nodes (sample_velocity, bilinear, along_face) or the HO
// path's precomputed quadrature velocity (DgQvPlanes).
//
// Each degree's basis and Gauss table entries arrive in DgTables<kDeg>,
// packed by coupled_cuda.py from the port's DGTransport, so the kernels and
// the plain version share one source:
//
//   degree  K (dofs)  volume points  face points  limiter
//   dG0     1         2x2            2            none
//   dG1     3         2x2            2            corner formula
//   dG2     6         3x3            3            min over the 9 + 4x3 points
//
// The sums run densely over every table entry in the plain version's
// ascending order: with --fmad=false a zero entry adds an exact zero and a
// unit entry multiplies exactly, which is what the plain version's skipped
// terms amount to. On a uniform mesh the edge terms' division by the
// element width is a multiply by its float32 reciprocal, as PyTorch on CUDA
// divides a tensor by a Python scalar. On a graded or spherical mesh
// (kMetric) the widths are per-element planes: the volume term multiplies
// by inv_dx and inv_dy, each face flux is weighted by its face's length
// after the coastline mask, and the edge terms multiply by the element's
// inverse area, in the plain version's order.
#pragma once

#include "common.cuh"

namespace nst {

// The sizes of one DG degree.
template <int kDeg>
struct DgShape {
  static_assert(kDeg >= 0 && kDeg <= 2, "the transport runs dG0, dG1 and dG2");
  static constexpr int kDofs = kDeg == 0 ? 1 : (kDeg == 1 ? 3 : 6);
  static constexpr int kVol = kDeg == 2 ? 9 : 4;   // 2x2 or 3x3 Gauss volume points
  static constexpr int kEdge = kDeg == 2 ? 3 : 2;  // Gauss points per face
};

// Table entries, in the order that coupled_cuda.py packs them. The first
// two fields are the velocity sampling's (SamplePoints).
template <int kDeg>
struct DgTables {
  static constexpr int kDofs = DgShape<kDeg>::kDofs, kVol = DgShape<kDeg>::kVol,
                       kEdge = DgShape<kDeg>::kEdge;
  float w_vol[kVol][4];          // bilinear weights of nodes 00, 10, 01, 11
  float w_edge[kEdge][2];        // (1 - s, s) along a face
  float psi_vol[kDofs][kVol];    // basis at volume points
  float wgx[kVol][kDofs];        // w_q dphi_k/dx at volume points (q, k)
  float wgy[kVol][kDofs];
  float psi_x0[kDofs][kEdge];    // traces on the left, right, bottom, top faces
  float psi_x1[kDofs][kEdge];
  float psi_y0[kDofs][kEdge];
  float psi_y1[kDofs][kEdge];
  float wa_x0[kDofs][kEdge];     // traces times edge weights
  float wa_x1[kDofs][kEdge];
  float wa_y0[kDofs][kEdge];
  float wa_y1[kDofs][kEdge];
  float inv_mass[kDofs];
  float inv_dx, inv_dy;          // volume term
  float edge_inv_dx, edge_inv_dy; // float32 reciprocals of the widths (edge terms)
};

// The sampling weights alone: the leading fields of DgTables.
template <int kVol, int kEdge>
struct SamplePoints {
  float w_vol[kVol][4];
  float w_edge[kEdge][2];
};

// The CG1 velocity at an element's nodes (i, j), (i+1, j), (i, j+1), (i+1, j+1).
struct Corners {
  float u00, u10, u01, u11, v00, v10, v01, v11;
};

__device__ __forceinline__ float bilinear(const float w[4], float f00, float f10,
                                          float f01, float f11) {
  return f00 * w[0] + f10 * w[1] + f01 * w[2] + f11 * w[3];
}

__device__ __forceinline__ float along_face(const float w[2], float f0, float f1) {
  return f0 * w[0] + f1 * w[1];
}

// sum_k table[k][e] * c[k], ascending k: a face trace, or (with psi_vol)
// the value at a volume point.
template <int K, int E>
__device__ __forceinline__ float trace(const float (&table)[K][E], int e, const float (&c)[K]) {
  float acc = table[0][e] * c[0];
#pragma unroll
  for (int k = 1; k < K; ++k) acc = acc + table[k][e] * c[k];
  return acc;
}

// The velocity at an element's quadrature points and on its four faces (the
// right face is element (i+1, j)'s left face, the top face element
// (i, j+1)'s bottom face).
template <int kDeg>
struct DgVelocity {
  static constexpr int kVol = DgShape<kDeg>::kVol, kEdge = DgShape<kDeg>::kEdge;
  float vx[kVol], vy[kVol];
  float vn_left[kEdge], vn_right[kEdge], vn_bottom[kEdge], vn_top[kEdge];
};

template <int kDeg>
__device__ __forceinline__ DgVelocity<kDeg> sample_velocity(const DgTables<kDeg>& tb,
                                                            const Corners& c) {
  DgVelocity<kDeg> q;
#pragma unroll
  for (int k = 0; k < DgShape<kDeg>::kVol; ++k) {
    q.vx[k] = bilinear(tb.w_vol[k], c.u00, c.u10, c.u01, c.u11);
    q.vy[k] = bilinear(tb.w_vol[k], c.v00, c.v10, c.v01, c.v11);
  }
#pragma unroll
  for (int e = 0; e < DgShape<kDeg>::kEdge; ++e) {
    q.vn_left[e] = along_face(tb.w_edge[e], c.u00, c.u01);
    q.vn_right[e] = along_face(tb.w_edge[e], c.u10, c.u11);
    q.vn_bottom[e] = along_face(tb.w_edge[e], c.v00, c.v10);
    q.vn_top[e] = along_face(tb.w_edge[e], c.v01, c.v11);
  }
  return q;
}

// The precomputed quadrature velocity of the HO path and of the advection
// run (QuadVelocity), each a read-only (nx, ny) plane; the host packs them
// in this order: 12 planes at dG0 and dG1, 24 at dG2.
template <int kDeg>
struct DgQvPlanes {
  static constexpr int kVol = DgShape<kDeg>::kVol, kEdge = DgShape<kDeg>::kEdge,
                       kCount = 2 * kVol + 2 * kEdge;
  const float* vx[kVol];
  const float* vy[kVol];
  const float* vn_x[kEdge];  // the left face of element (i, j)
  const float* vn_y[kEdge];  // its bottom face
};

// Element (i, j)'s velocity from the precomputed planes; its right and top
// faces are those of elements (i+1, j) and (i, j+1) (zero beyond the domain,
// where there is no flux).
// ij_right, ij_top: the indices of elements (i+1, j) and (i, j+1), wrapped
// on a periodic axis.
template <int kDeg>
__device__ __forceinline__ DgVelocity<kDeg> load_qv(const DgQvPlanes<kDeg>& qv, long ij,
                                                    long ij_right, long ij_top, bool has_right,
                                                    bool has_top) {
  DgVelocity<kDeg> q;
#pragma unroll
  for (int k = 0; k < DgShape<kDeg>::kVol; ++k) {
    q.vx[k] = __ldg(qv.vx[k] + ij);
    q.vy[k] = __ldg(qv.vy[k] + ij);
  }
#pragma unroll
  for (int e = 0; e < DgShape<kDeg>::kEdge; ++e) {
    q.vn_left[e] = __ldg(qv.vn_x[e] + ij);
    q.vn_right[e] = has_right ? __ldg(qv.vn_x[e] + ij_right) : 0.0f;
    q.vn_bottom[e] = __ldg(qv.vn_y[e] + ij);
    q.vn_top[e] = has_top ? __ldg(qv.vn_y[e] + ij_top) : 0.0f;
  }
  return q;
}

// Where an element sits against the domain, and its face masks: on a
// closed axis the global x = 0 and y = 0 faces are walls (zero flux), and
// beyond nx or ny there is no right or top neighbour; a periodic axis has
// neither.
struct Dg1Faces {
  bool left_wall, has_right, bottom_wall, has_top;
  float fx_left, fx_right, fy_bottom, fy_top;
};

// The transport's metric planes (inv_dx, inv_dy, face_x, face_y, inv_area
// of DGTransport.metric_planes), read-only for a launch; all null on a
// uniform mesh. The host packs them in this order.
struct Dg1MetricPlanes {
  const float* inv_dx;
  const float* inv_dy;
  const float* len_x;  // length of the left face of element (i, j)
  const float* len_y;  // length of the bottom face
  const float* inv_area;
};

// One element's metric: its inverse widths and area and the lengths of
// its four faces (the right face is element (i+1, j)'s left face, the top
// face element (i, j+1)'s bottom face; zero beyond the domain).
struct Dg1Metric {
  float inv_dx, inv_dy, inv_area, len_left, len_right, len_bottom, len_top;
};

__device__ __forceinline__ Dg1Metric load_metric(const Dg1MetricPlanes& m, long ij, long ij_right,
                                                 long ij_top, bool has_right, bool has_top) {
  Dg1Metric g;
  g.inv_dx = __ldg(m.inv_dx + ij);
  g.inv_dy = __ldg(m.inv_dy + ij);
  g.inv_area = __ldg(m.inv_area + ij);
  g.len_left = __ldg(m.len_x + ij);
  g.len_right = has_right ? __ldg(m.len_x + ij_right) : 0.0f;
  g.len_bottom = __ldg(m.len_y + ij);
  g.len_top = has_top ? __ldg(m.len_y + ij_top) : 0.0f;
  return g;
}

// The upwind normal flux at point e of one face, between the element `lo`
// below it (left or bottom) and the element `hi` above it (right or top):
// vn times the trace of the upwind side, 0 where the face is closed (a
// global x = 0 or y = 0 wall, or beyond the domain), times the face's
// coastline mask and, with kMetric, its length. The two elements of a face
// would run the same operations on the same values, so the flux is the
// same float32 number whichever of them computes it. lo_table, hi_table:
// psi_x1, psi_x0 on an x face, psi_y1, psi_y0 on a y face. The upwind
// side's table entries and coefficients are picked first and one trace runs
// on them: the operations of dg1_stage_cell's trace on the same values,
// with no branch (written as a choice between two traces, it compiles to a
// divergent branch on the sign of vn, which cost the kernel 2-4%).
template <bool kMetric, int K, int E>
__device__ __forceinline__ float dg1_face_flux(const float (&lo_table)[K][E],
                                               const float (&hi_table)[K][E], int e, float vn,
                                               const float (&lo)[K], const float (&hi)[K],
                                               bool open, float mask, float len) {
  const bool from_lo = vn >= 0.0f;
  float up = (from_lo ? lo_table[0][e] : hi_table[0][e]) * (from_lo ? lo[0] : hi[0]);
#pragma unroll
  for (int k = 1; k < K; ++k)
    up = up + (from_lo ? lo_table[k][e] : hi_table[k][e]) * (from_lo ? lo[k] : hi[k]);
  float g = open ? vn * up : 0.0f;
  g = g * mask;
  if (kMetric) g = g * len;
  return g;
}

// An element's four face fluxes at the points of each face.
template <int kEdge>
struct DgFluxes {
  float left[kEdge], right[kEdge], bottom[kEdge], top[kEdge];
};

// out = the positivity-limited val (DGTransport.limit_positivity), or val
// without kLimit. dG0: no higher moment. dG1: the linear polynomial's
// minimum is at a corner, mean - (|s1| + |s2|)/2. dG2: the minimum over the
// 9 volume points and the 3 points of each face, each value an
// ascending-k sum; the higher moments scale by
// theta = min(1, mean / (mean - min)) where the minimum is negative.
template <int kDeg, bool kLimit>
__device__ __forceinline__ void dg_limit(const DgTables<kDeg>& tb,
                                         const float (&val)[DgShape<kDeg>::kDofs],
                                         float (&out)[DgShape<kDeg>::kDofs]) {
  constexpr int K = DgShape<kDeg>::kDofs;
  if constexpr (kDeg == 0 || !kLimit) {
#pragma unroll
    for (int d = 0; d < K; ++d) out[d] = val[d];
  } else {
    const float mean = val[0];
    float mins;
    if constexpr (kDeg == 1) {
      mins = mean - 0.5f * (fabsf(val[1]) + fabsf(val[2]));
    } else {
      mins = trace(tb.psi_vol, 0, val);
#pragma unroll
      for (int q = 1; q < DgShape<kDeg>::kVol; ++q) mins = fminf(mins, trace(tb.psi_vol, q, val));
#pragma unroll
      for (int e = 0; e < DgShape<kDeg>::kEdge; ++e) mins = fminf(mins, trace(tb.psi_x0, e, val));
#pragma unroll
      for (int e = 0; e < DgShape<kDeg>::kEdge; ++e) mins = fminf(mins, trace(tb.psi_x1, e, val));
#pragma unroll
      for (int e = 0; e < DgShape<kDeg>::kEdge; ++e) mins = fminf(mins, trace(tb.psi_y0, e, val));
#pragma unroll
      for (int e = 0; e < DgShape<kDeg>::kEdge; ++e) mins = fminf(mins, trace(tb.psi_y1, e, val));
    }
    const float deficit = mean - mins;
    const float theta =
        mins < 0.0f ? fminf(fmaxf(mean / (deficit > 0.0f ? deficit : 1.0f), 0.0f), 1.0f)
                    : 1.0f;
    out[0] = mean;
#pragma unroll
    for (int d = 1; d < K; ++d) out[d] = val[d] * theta;
  }
}

// out = lim(a*base + b*(p + dt*rhs(p))), or lim(p + dt*rhs(p)) when a == 0
// or without kBlend, for one tracer of one element: p its coefficients, vx
// and vy its volume velocity, fl its face fluxes (dg1_face_flux); lim is the
// identity without kLimit. `base` is read only with kBlend and a != 0; `g`
// only with kMetric.
template <int kDeg, bool kMetric, bool kBlend = true, bool kLimit = true>
__device__ __forceinline__ void dg1_stage_update(
    const DgTables<kDeg>& tb, const float (&vx)[DgShape<kDeg>::kVol],
    const float (&vy)[DgShape<kDeg>::kVol], const Dg1Metric& g,
    const float (&p)[DgShape<kDeg>::kDofs], const DgFluxes<DgShape<kDeg>::kEdge>& fl,
    const float (&base)[DgShape<kDeg>::kDofs], float a, float b, float dt,
    float (&out)[DgShape<kDeg>::kDofs]) {
  constexpr int kDofs = DgShape<kDeg>::kDofs, kVol = DgShape<kDeg>::kVol,
                kEdge = DgShape<kDeg>::kEdge;
  // Volume term, streamed over the quadrature points.
  float acc_x[kDofs], acc_y[kDofs];
#pragma unroll
  for (int k = 0; k < kVol; ++k) {
    const float pq = trace(tb.psi_vol, k, p);
    const float fx = vx[k] * pq;
    const float fy = vy[k] * pq;
#pragma unroll
    for (int d = 0; d < kDofs; ++d) {
      acc_x[d] = k == 0 ? tb.wgx[k][d] * fx : acc_x[d] + tb.wgx[k][d] * fx;
      acc_y[d] = k == 0 ? tb.wgy[k][d] * fy : acc_y[d] + tb.wgy[k][d] * fy;
    }
  }

  float val[kDofs];
#pragma unroll
  for (int d = 0; d < kDofs; ++d) {
    const float volume = kMetric ? acc_x[d] * g.inv_dx + acc_y[d] * g.inv_dy
                                 : acc_x[d] * tb.inv_dx + acc_y[d] * tb.inv_dy;
    float in_x = tb.wa_x1[d][0] * fl.right[0];
    float out_x = tb.wa_x0[d][0] * fl.left[0];
    float in_y = tb.wa_y1[d][0] * fl.top[0];
    float out_y = tb.wa_y0[d][0] * fl.bottom[0];
#pragma unroll
    for (int e = 1; e < kEdge; ++e) {
      in_x = in_x + tb.wa_x1[d][e] * fl.right[e];
      out_x = out_x + tb.wa_x0[d][e] * fl.left[e];
      in_y = in_y + tb.wa_y1[d][e] * fl.top[e];
      out_y = out_y + tb.wa_y0[d][e] * fl.bottom[e];
    }
    const float edge_x = (in_x - out_x) * (kMetric ? g.inv_area : tb.edge_inv_dx);
    const float edge_y = (in_y - out_y) * (kMetric ? g.inv_area : tb.edge_inv_dy);
    const float rhs = tb.inv_mass[d] * (volume - edge_x - edge_y);
    val[d] = p[d] + dt * rhs;
    if (kBlend && a != 0.0f) val[d] = a * base[d] + b * val[d];
  }
  dg_limit<kDeg, kLimit>(tb, val, out);
}

// out = lim(a*base + b*(p + dt*rhs(p))), or lim(p + dt*rhs(p)) when a == 0
// or without kBlend, for one tracer of one element: p its coefficients,
// p_l/p_r/p_b/p_t those of its left, right, bottom and top neighbours
// (zeros beyond the domain): dg1_face_flux on its four faces, then
// dg1_stage_update, written out in one body. `base` is read only with
// kBlend and a != 0; `g` only with kMetric. lim: the positivity limiter, or
// without kLimit the identity (the TVB form, whose limiter pass follows).
template <int kDeg, bool kMetric, bool kBlend = true, bool kLimit = true>
__device__ __forceinline__ void dg1_stage_cell(
    const DgTables<kDeg>& tb, const DgVelocity<kDeg>& q, const Dg1Faces& f, const Dg1Metric& g,
    const float (&p)[DgShape<kDeg>::kDofs], const float (&p_l)[DgShape<kDeg>::kDofs],
    const float (&p_r)[DgShape<kDeg>::kDofs], const float (&p_b)[DgShape<kDeg>::kDofs],
    const float (&p_t)[DgShape<kDeg>::kDofs], const float (&base)[DgShape<kDeg>::kDofs],
    float a, float b, float dt, float (&out)[DgShape<kDeg>::kDofs]) {
  constexpr int kDofs = DgShape<kDeg>::kDofs, kVol = DgShape<kDeg>::kVol,
                kEdge = DgShape<kDeg>::kEdge;
  // Volume term, streamed over the quadrature points.
  float acc_x[kDofs], acc_y[kDofs];
#pragma unroll
  for (int k = 0; k < kVol; ++k) {
    const float pq = trace(tb.psi_vol, k, p);
    const float fx = q.vx[k] * pq;
    const float fy = q.vy[k] * pq;
#pragma unroll
    for (int d = 0; d < kDofs; ++d) {
      acc_x[d] = k == 0 ? tb.wgx[k][d] * fx : acc_x[d] + tb.wgx[k][d] * fx;
      acc_y[d] = k == 0 ? tb.wgy[k][d] * fy : acc_y[d] + tb.wgy[k][d] * fy;
    }
  }

  // Upwind normal fluxes on the four faces.
  float g_left[kEdge], g_right[kEdge], g_bottom[kEdge], g_top[kEdge];
#pragma unroll
  for (int e = 0; e < kEdge; ++e) {
    // Left face (i): upwind between element (i-1, j) and this one.
    float up = q.vn_left[e] >= 0.0f ? trace(tb.psi_x1, e, p_l) : trace(tb.psi_x0, e, p);
    g_left[e] = f.left_wall ? 0.0f : q.vn_left[e] * up;
    g_left[e] = g_left[e] * f.fx_left;
    if (kMetric) g_left[e] = g_left[e] * g.len_left;
    // Right face (i+1): this element against element (i+1, j).
    up = q.vn_right[e] >= 0.0f ? trace(tb.psi_x1, e, p) : trace(tb.psi_x0, e, p_r);
    g_right[e] = f.has_right ? (q.vn_right[e] * up) * f.fx_right : 0.0f;
    if (kMetric) g_right[e] = g_right[e] * g.len_right;
    // Bottom face (j).
    up = q.vn_bottom[e] >= 0.0f ? trace(tb.psi_y1, e, p_b) : trace(tb.psi_y0, e, p);
    g_bottom[e] = f.bottom_wall ? 0.0f : q.vn_bottom[e] * up;
    g_bottom[e] = g_bottom[e] * f.fy_bottom;
    if (kMetric) g_bottom[e] = g_bottom[e] * g.len_bottom;
    // Top face (j+1).
    up = q.vn_top[e] >= 0.0f ? trace(tb.psi_y1, e, p) : trace(tb.psi_y0, e, p_t);
    g_top[e] = f.has_top ? (q.vn_top[e] * up) * f.fy_top : 0.0f;
    if (kMetric) g_top[e] = g_top[e] * g.len_top;
  }

  float val[kDofs];
#pragma unroll
  for (int d = 0; d < kDofs; ++d) {
    const float volume = kMetric ? acc_x[d] * g.inv_dx + acc_y[d] * g.inv_dy
                                 : acc_x[d] * tb.inv_dx + acc_y[d] * tb.inv_dy;
    float in_x = tb.wa_x1[d][0] * g_right[0];
    float out_x = tb.wa_x0[d][0] * g_left[0];
    float in_y = tb.wa_y1[d][0] * g_top[0];
    float out_y = tb.wa_y0[d][0] * g_bottom[0];
#pragma unroll
    for (int e = 1; e < kEdge; ++e) {
      in_x = in_x + tb.wa_x1[d][e] * g_right[e];
      out_x = out_x + tb.wa_x0[d][e] * g_left[e];
      in_y = in_y + tb.wa_y1[d][e] * g_top[e];
      out_y = out_y + tb.wa_y0[d][e] * g_bottom[e];
    }
    const float edge_x = (in_x - out_x) * (kMetric ? g.inv_area : tb.edge_inv_dx);
    const float edge_y = (in_y - out_y) * (kMetric ? g.inv_area : tb.edge_inv_dy);
    const float rhs = tb.inv_mass[d] * (volume - edge_x - edge_y);
    val[d] = p[d] + dt * rhs;
    if (kBlend && a != 0.0f) val[d] = a * base[d] + b * val[d];
  }
  dg_limit<kDeg, kLimit>(tb, val, out);
}

// torch.sign: -1, 0 or 1.
__device__ __forceinline__ float sign_of(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// minmod(a, b, c) of DGTransport.limit_slopes: sign(a) min(|a|, |b|, |c|)
// where the three signs agree, else 0.
__device__ __forceinline__ float minmod3(float a, float b, float c) {
  const float sa = sign_of(a);
  const bool same = sa == sign_of(b) && sa == sign_of(c);
  const float m = sa * fminf(fabsf(a), fminf(fabsf(b), fabsf(c)));
  return same ? m : 0.0f;
}

// An element's neighbourhood for the TVB limiter: the cell means of its
// left, right, bottom and top neighbours (after the stage), whether a
// closed wall stands on that side (a zero-gradient ghost: that difference
// is 0), and the tolerances M dx^2, M dy^2.
struct TvbNeighbours {
  float m_l, m_r, m_b, m_t;
  bool wall_l, wall_r, wall_b, wall_t;
  float tol_x, tol_y;
};

// out = limit_positivity(limit_slopes(val)) of DGTransport for one element
// (dG1 and dG2): each linear moment minmod-limited against the forward and
// backward mean differences (shift_p(mean) - mean, then mean -
// shift_m(mean), as the plain version computes them) unless within its
// tolerance; at dG2, where a linear moment moved by more than 1e-12, the
// quadratic moments are zeroed; then the positivity limiter. The mean is
// never changed.
template <int kDeg>
__device__ __forceinline__ void dg_tvb_limit(const DgTables<kDeg>& tb,
                                             const float (&val)[DgShape<kDeg>::kDofs],
                                             const TvbNeighbours& n,
                                             float (&out)[DgShape<kDeg>::kDofs]) {
  static_assert(kDeg > 0, "dG0 has no slopes");
  constexpr int K = DgShape<kDeg>::kDofs;
  const float mean = val[0];
  const float dpx = n.wall_r ? 0.0f : n.m_r - mean;
  const float dmx = n.wall_l ? 0.0f : mean - n.m_l;
  const float dpy = n.wall_t ? 0.0f : n.m_t - mean;
  const float dmy = n.wall_b ? 0.0f : mean - n.m_b;
  float lim[K];
  lim[0] = mean;
  lim[1] = fabsf(val[1]) <= n.tol_x ? val[1] : minmod3(val[1], dpx, dmx);
  lim[2] = fabsf(val[2]) <= n.tol_y ? val[2] : minmod3(val[2], dpy, dmy);
  if constexpr (kDeg == 2) {
    const bool cut = fabsf(lim[1] - val[1]) > 1e-12f || fabsf(lim[2] - val[2]) > 1e-12f;
    const float keep = cut ? 0.0f : 1.0f;
#pragma unroll
    for (int d = 3; d < K; ++d) lim[d] = val[d] * keep;
  }
  dg_limit<kDeg, true>(tb, lim, out);
}

}  // namespace nst
