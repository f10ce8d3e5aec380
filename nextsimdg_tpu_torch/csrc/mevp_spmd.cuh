// The halo forms of the CG1 mEVP halves (mevp.cu's mevp_stress and
// mevp_velocity) as templates on the mesh's metric and the momentum form,
// shared by the two sources that instantiate them: mevp_spmd.cu (the closed
// uniform form 0, and the entry points; the design is described there) and
// mevp_spmd_forms.cu (the metric, A-weighted and adaptive instances).
#pragma once

#include "mevp_body.cuh"

namespace nst {

// The neighbour ranks' strips of a halo launch, each plane's strip after the
// other's. x: one row of ny cells a plane: the stress half's the +1
// neighbour's first row of u and v, the velocity half's the -1 neighbour's
// last row of s11, s22 and s12. y: one column of nx + 1 cells a plane, taken
// by the neighbour from its block extended by the x strip it received, so
// that its extra cell is the diagonal rank's corner: the stress half's the
// +1 neighbour's first column, rows 0..nx (nx the corner), the velocity
// half's the -1 neighbour's last column, rows -1..nx-1 (cell 0 the corner).
// metric_x, metric_y: the velocity half's strips of half_dx and half_dy on a
// graded or spherical mesh, in the same layout (null in the other forms and
// the stress half). A closed global wall's strips are zeros.
struct MevpHalo {
  const float* x;
  const float* y;
  const float* metric_x;
  const float* metric_y;
};

// Node (a, b) of a plane whose own block is f, a in [0, nx] and b in [0, ny]:
// at a = nx or b = ny the +1 strips xs (ny cells) and ys (nx + 1 cells).
__device__ __forceinline__ float plus_at(const float* f, const float* xs, const float* ys, int a,
                                         int b, int nx, int ny) {
  if (b == ny) return __ldg(ys + a);
  if (a == nx) return __ldg(xs + b);
  return f[a * ny + b];
}

// Element (a, b) of a plane whose own block is f, a in [-1, nx) and b in
// [-1, ny): at a = -1 or b = -1 the -1 strips xs (ny cells) and ys (nx + 1
// cells, cell 0 at a = -1).
template <bool kReadOnly>
__device__ __forceinline__ float minus_at(const float* f, const float* xs, const float* ys, int a,
                                          int b, int ny) {
  if (b < 0) return __ldg(ys + a + 1);
  if (a < 0) return __ldg(xs + b);
  return kReadOnly ? __ldg(f + a * ny + b) : f[a * ny + b];
}

// The stress half at element (i, j) of the rank's block, in place: the
// body of stress_cell (mevp_body.cuh), with the nodes i + 1 and j + 1
// beyond the block read from the strips.
template <bool kMetric, int kForm>
__global__ void mevp_stress_halo_kernel(MevpState p, MevpConsts k, MevpHalo h, int nx, int ny,
                                        MevpScalars s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ij = i * ny + j;
  const float inv_dx = kMetric ? __ldg(k.inv_dx + ij) : s.inv_dx;
  const float inv_dy = kMetric ? __ldg(k.inv_dy + ij) : s.inv_dy;
  const float* xu = h.x;
  const float* xv = h.x + ny;
  const float* yu = h.y;
  const float* yv = h.y + (nx + 1);
  const auto u_at = [&](int a, int b) { return plus_at(p.u, xu, yu, a, b, nx, ny); };
  const auto v_at = [&](int a, int b) { return plus_at(p.v, xv, yv, a, b, nx, ny); };
  const StressOut o = mevp_stress_body<kForm>(
      p.u[ij], u_at(i + 1, j), u_at(i, j + 1), u_at(i + 1, j + 1), p.v[ij], v_at(i + 1, j),
      v_at(i, j + 1), v_at(i + 1, j + 1), p.s11[ij], p.s22[ij], p.s12[ij], __ldg(k.strength + ij),
      __ldg(k.dt_m + ij), __ldg(k.active + ij), __ldg(k.u_ocean + ij), __ldg(k.v_ocean + ij), inv_dx,
      inv_dy, s, form_a_node<kForm>(k, ij), form_inv_area<kMetric, kForm>(k, ij, s));
  p.s11[ij] = o.s11;
  p.s22[ij] = o.s22;
  p.s12[ij] = o.s12;
  p.c_w[ij] = o.c_w;
  p.inv_drag[ij] = o.inv_drag;
  if constexpr ((kForm & kFormAdaptive) != 0) p.beta[ij] = o.beta;
}

// The velocity half at node (i, j) of the rank's block, in place: the body
// of velocity_cell (mevp_body.cuh), with the elements i - 1 and j - 1 beyond
// the block (and on a metric mesh their half face lengths) read from the
// strips.
template <bool kMetric, int kForm>
__global__ void mevp_velocity_halo_kernel(MevpState p, MevpConsts k, MevpHalo h, int nx, int ny,
                                          MevpScalars s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ij = i * ny + j;
  const int row = ny, col = nx + 1;  // the strips of one plane
  // Plane q of the stress strips (0 s11, 1 s22, 2 s12) around node (i, j).
  const auto around = [&](const float* f, int q) {
    const float* xs = h.x + q * row;
    const float* ys = h.y + q * col;
    return Around{f[ij], minus_at<false>(f, xs, ys, i - 1, j, ny),
                  minus_at<false>(f, xs, ys, i, j - 1, ny),
                  minus_at<false>(f, xs, ys, i - 1, j - 1, ny)};
  };
  float2 f;
  float inv_w;
  if constexpr (kMetric) {
    // Each stress times its own element's half face length (w: 0 half_dx,
    // 1 half_dy), as weighted() does.
    const auto weighted = [&](const float* f, int q, const float* plane, int w) {
      const Around a = around(f, q);
      const float* xs = h.metric_x + w * row;
      const float* ys = h.metric_y + w * col;
      return Around{a.c * __ldg(plane + ij), a.x * minus_at<true>(plane, xs, ys, i - 1, j, ny),
                    a.y * minus_at<true>(plane, xs, ys, i, j - 1, ny),
                    a.xy * minus_at<true>(plane, xs, ys, i - 1, j - 1, ny)};
    };
    f = forces_metric(weighted(p.s11, 0, k.half_dy, 1), weighted(p.s12, 2, k.half_dx, 0),
                      weighted(p.s12, 2, k.half_dy, 1), weighted(p.s22, 1, k.half_dx, 0));
    inv_w = __ldg(k.inv_w + ij);
  } else {
    f = forces_uniform(around(p.s11, 0), around(p.s22, 1), around(p.s12, 2), s);
    inv_w = s.inv_w;
  }
  const float2 uv = mevp_velocity_body(
      f, inv_w, p.u[ij], p.v[ij], __ldg(k.u_ocean + ij), __ldg(k.v_ocean + ij), p.c_w[ij],
      __ldg(k.dt_m + ij), __ldg(k.b_u + ij), __ldg(k.b_v + ij), p.inv_drag[ij],
      (kForm & kFormAdaptive) != 0 ? p.beta[ij] : s.beta, s);
  p.u[ij] = uv.x;
  p.v[ij] = uv.y;
}

using HaloKernel = void (*)(MevpState, MevpConsts, MevpHalo, int, int, MevpScalars);

// The instance of a half (0: stress, 1: velocity) for a mesh and momentum
// form.
template <bool kMetric, int kForm>
HaloKernel halo_kernel_of(int half) {
  return half == 0 ? mevp_stress_halo_kernel<kMetric, kForm>
                   : mevp_velocity_halo_kernel<kMetric, kForm>;
}

// The instances other than the closed uniform form 0 (mevp_spmd_forms.cu);
// null for an unknown form.
HaloKernel mevp_halo_forms_of(int half, bool metric, int form);

}  // namespace nst
