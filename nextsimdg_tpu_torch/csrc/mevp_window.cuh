// CG1 mEVP subcycles on a window of the state held in shared memory.
//
// rdma_band (mevp_rdma.cu) runs its subcycles here, on a tile of an edge
// band of a rank block; mevp_tiled.cu runs the same cells of a square window
// in a loop of its own (threads that own fixed cells, c_w and inv_drag in
// registers). A window is
// wa x wb cells of 7 planes (u, v, s11, s22, s12, and the per-subcycle node
// planes c_w and inv_drag); window cell (a, b) is
// domain cell (i0 + a, j0 + b). Cells outside the domain [0, nx) x [0, ny)
// are zero and are never updated, as at() in common.cuh reads them.
//
// Along an axis whose window edge lies inside the domain (sa or sb = 1),
// each subcycle spoils one ring of the window, so subcycle `sub` computes
// elements [sub, w - 1 - sub) and nodes [sub + 1, w - 1 - sub), and after n
// subcycles the cells n or more from that edge are exact. Along an axis
// that the window covers whole, with one cell of padding beyond the domain
// on either side (sa or sb = 0), nothing is spoiled: elements [0, w - 1)
// and nodes [1, w - 1) are computed every subcycle.
//
// Each element and node runs mevp_stress_body and mevp_velocity_body of
// mevp_body.cuh, so every schedule that calls them agrees bit for bit.
#pragma once

#include "mevp_body.cuh"

namespace nst {

constexpr int kMevpSharedPlanes = 7;  // u, v, s11, s22, s12, c_w, inv_drag

// The per-step const planes of a window's domain: domain cell (i, j) reads
// index (i + off_i) * ld + (j + off_j) of each plane (a block's own planes:
// ld = ny and no offset; an edge band of a rank block: the rank's widened
// planes, at the band's offset).
struct ConstView {
  MevpConsts k;
  int ld, off_i, off_j;
  __device__ __forceinline__ int at(int i, int j) const { return (i + off_i) * ld + (j + off_j); }
};

struct Window {
  int wa, wb;  // extent (rows, columns)
  int i0, j0;  // domain cell of window cell (0, 0)
  int nx, ny;  // domain extent
  int sa, sb;  // 1: the edge along rows (columns) spoils a ring per subcycle
};

// A metric const plane at domain cell (i, j), or 0 beyond the domain.
__device__ __forceinline__ float ldg_view(const float* f, const ConstView& v, int i, int j,
                                          int nx, int ny) {
  return (i >= 0 && i < nx && j >= 0 && j < ny) ? __ldg(f + v.at(i, j)) : 0.0f;
}

// The window's stresses around node (a, b) (window index c, row width ww),
// each times the metric plane f of its own element (domain (i, j)); beyond
// the domain the stress is zero and so is the weight.
__device__ __forceinline__ Around weighted_window(const float* s, const float* f, int c, int ww,
                                                 const ConstView& v, int i, int j, int nx,
                                                 int ny) {
  return {s[c] * __ldg(f + v.at(i, j)), s[c - ww] * ldg_view(f, v, i - 1, j, nx, ny),
          s[c - 1] * ldg_view(f, v, i, j - 1, nx, ny),
          s[c - ww - 1] * ldg_view(f, v, i - 1, j - 1, nx, ny)};
}

// n_sub subcycles on the window in smem (7 planes of wa * wb floats, the
// first five loaded by the caller, which synchronised the block after the
// load). The cells of a region are spread over the block's threads row by
// row, consecutive threads on consecutive cells of a row.
template <bool kMetric>
__device__ __forceinline__ void window_subcycles(float* smem, const Window& w,
                                                 const ConstView& cv, int n_sub,
                                                 const MevpScalars& s) {
  const int plane = w.wa * w.wb;
  float* su = smem;
  float* sv = su + plane;
  float* s11 = sv + plane;
  float* s22 = s11 + plane;
  float* s12 = s22 + plane;
  float* scw = s12 + plane;
  float* sinv = scw + plane;
  const MevpConsts& k = cv.k;
  const int ww = w.wb;
  const int tid = threadIdx.x, n_threads = blockDim.x;

  for (int sub = 0; sub < n_sub; ++sub) {
    // Stress phase: element (a, b) reads nodes a..a+1, b..b+1.
    int lo_a = w.sa * sub, lo_b = w.sb * sub;
    int ra = w.wa - 1 - 2 * lo_a, rb = w.wb - 1 - 2 * lo_b;
    float inv_r = 1.0f / static_cast<float>(rb);
    for (int idx = tid; idx < ra * rb; idx += n_threads) {
      const int da = region_row(idx, inv_r);
      const int a = lo_a + da, b = lo_b + idx - da * rb;
      const int i = w.i0 + a, j = w.j0 + b;
      if (i < 0 || i >= w.nx || j < 0 || j >= w.ny) continue;
      const int c = a * ww + b, ij = cv.at(i, j);
      const StressOut o = mevp_stress_body(
          su[c], su[c + ww], su[c + 1], su[c + ww + 1], sv[c], sv[c + ww], sv[c + 1],
          sv[c + ww + 1], s11[c], s22[c], s12[c], __ldg(k.strength + ij), __ldg(k.dt_m + ij),
          __ldg(k.active + ij), __ldg(k.u_ocean + ij), __ldg(k.v_ocean + ij),
          kMetric ? __ldg(k.inv_dx + ij) : s.inv_dx, kMetric ? __ldg(k.inv_dy + ij) : s.inv_dy,
          s);
      s11[c] = o.s11;
      s22[c] = o.s22;
      s12[c] = o.s12;
      scw[c] = o.c_w;
      sinv[c] = o.inv_drag;
    }
    __syncthreads();

    // Velocity phase: node (a, b) reads elements a-1..a, b-1..b and its own
    // c_w and inv_drag.
    lo_a += 1;
    lo_b += 1;
    ra -= 1;
    rb -= 1;
    inv_r = 1.0f / static_cast<float>(rb);
    for (int idx = tid; idx < ra * rb; idx += n_threads) {
      const int da = region_row(idx, inv_r);
      const int a = lo_a + da, b = lo_b + idx - da * rb;
      const int i = w.i0 + a, j = w.j0 + b;
      if (i < 0 || i >= w.nx || j < 0 || j >= w.ny) continue;
      const int c = a * ww + b, ij = cv.at(i, j);
      float2 f;
      float inv_node_w;
      if (kMetric) {
        f = forces_metric(weighted_window(s11, k.half_dy, c, ww, cv, i, j, w.nx, w.ny),
                          weighted_window(s12, k.half_dx, c, ww, cv, i, j, w.nx, w.ny),
                          weighted_window(s12, k.half_dy, c, ww, cv, i, j, w.nx, w.ny),
                          weighted_window(s22, k.half_dx, c, ww, cv, i, j, w.nx, w.ny));
        inv_node_w = __ldg(k.inv_w + ij);
      } else {
        const Around a11 = {s11[c], s11[c - ww], s11[c - 1], s11[c - ww - 1]};
        const Around a22 = {s22[c], s22[c - ww], s22[c - 1], s22[c - ww - 1]};
        const Around a12 = {s12[c], s12[c - ww], s12[c - 1], s12[c - ww - 1]};
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
}

}  // namespace nst
