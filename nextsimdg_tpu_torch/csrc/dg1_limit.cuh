// The TVB limiter pass of the staged transport's TVB form as a grid-wide
// launch: the dg1_limit kernel template, shared by the sources that
// instantiate it: transport_tvb.cu (the single domain's instances, and the
// entry point; the design is described there) and transport_tvb_spmd.cu
// (the halo form of a rank block, whose neighbours' means come from the
// block widened by one ring).
#pragma once

#include "dg1_body.cuh"

namespace nst {

// Everything a dg1_limit launch takes.
template <int kDeg>
struct LimitArgs {
  float* psi;            // (K, n_tracers, nx, ny), limited in place
  const float* tol_x;    // (nx, ny) with kMetric, else null
  const float* tol_y;
  int nx, ny, n_tracers, wrap;
  float tol_x0, tol_y0;  // the uniform mesh's tolerances
  DgTables<kDeg> tb;
  // The halo form's (kHalo; last, so that the single domain's instances
  // read their parameters at the offsets they always had): the means of
  // the block widened by one ring, (n_tracers, nx + 2, ny + 2), and the
  // global walls in the widened block's indices: the row of the last x
  // wall's elements, the row of the first's, then the columns of y's, -1
  // for none (dg1_rk_stage's halo form's wall[4]).
  const float* means;
  int wall[4];
};

// One thread an element, walking the tracers.
template <int kDeg, bool kMetric>
__global__ void __launch_bounds__(kBlockX * kBlockY) dg1_limit_kernel(const LimitArgs<kDeg> g) {
  constexpr int K = DgShape<kDeg>::kDofs;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = g.nx, ny = g.ny;
  if (i >= nx || j >= ny) return;
  const bool wx = (g.wrap & kWrapX) != 0, wy = (g.wrap & kWrapY) != 0;
  // The neighbours' indices: wrapped on a periodic axis, -1 beyond a wall.
  const int il = i > 0 ? i - 1 : (wx ? nx - 1 : -1);
  const int ir = i + 1 < nx ? i + 1 : (wx ? 0 : -1);
  const int jb = j > 0 ? j - 1 : (wy ? ny - 1 : -1);
  const int jt = j + 1 < ny ? j + 1 : (wy ? 0 : -1);
  const long plane = static_cast<long>(nx) * ny;
  const long ij = static_cast<long>(i) * ny + j;
  TvbNeighbours n;
  n.wall_l = il < 0;
  n.wall_r = ir < 0;
  n.wall_b = jb < 0;
  n.wall_t = jt < 0;
  n.tol_x = kMetric ? __ldg(g.tol_x + ij) : g.tol_x0;
  n.tol_y = kMetric ? __ldg(g.tol_y + ij) : g.tol_y0;
  for (int t = 0; t < g.n_tracers; ++t) {
    const float* mean = g.psi + t * plane;  // coefficient 0 of tracer t
    n.m_l = n.wall_l ? 0.0f : mean[static_cast<long>(il) * ny + j];
    n.m_r = n.wall_r ? 0.0f : mean[static_cast<long>(ir) * ny + j];
    n.m_b = n.wall_b ? 0.0f : mean[static_cast<long>(i) * ny + jb];
    n.m_t = n.wall_t ? 0.0f : mean[static_cast<long>(i) * ny + jt];
    float val[K], out[K];
#pragma unroll
    for (int d = 0; d < K; ++d) val[d] = g.psi[(d * g.n_tracers + t) * plane + ij];
    dg_tvb_limit<kDeg>(g.tb, val, n, out);
#pragma unroll
    for (int d = 1; d < K; ++d) g.psi[(d * g.n_tracers + t) * plane + ij] = out[d];
  }
}

// The halo form (transport_tvb_spmd.cu): one thread an element of a rank
// block's own nx x ny elements (psi, limited in place), walking the
// tracers. The neighbours' means are read from g.means, the block widened
// by one ring (its row i + 1, column j + 1 the element's own), whose ring
// holds the neighbour ranks' means (round the ring of ranks on a periodic
// axis, so no axis wraps here); a difference is zeroed only at a global
// wall of g.wall, as dg1_limit_kernel zeroes it at the domain's edges.
template <int kDeg, bool kMetric>
__global__ void __launch_bounds__(kBlockX * kBlockY) dg1_limit_halo_kernel(const LimitArgs<kDeg> g) {
  constexpr int K = DgShape<kDeg>::kDofs;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = g.nx, ny = g.ny;
  if (i >= nx || j >= ny) return;
  const long plane = static_cast<long>(nx) * ny;
  const long ij = static_cast<long>(i) * ny + j;
  const int ld = ny + 2;  // a widened row
  const long wplane = static_cast<long>(nx + 2) * ld;
  const long wij = static_cast<long>(i + 1) * ld + (j + 1);
  TvbNeighbours n;
  n.wall_l = i + 1 == g.wall[1];
  n.wall_r = i + 1 == g.wall[0];
  n.wall_b = j + 1 == g.wall[3];
  n.wall_t = j + 1 == g.wall[2];
  n.tol_x = kMetric ? __ldg(g.tol_x + ij) : g.tol_x0;
  n.tol_y = kMetric ? __ldg(g.tol_y + ij) : g.tol_y0;
  for (int t = 0; t < g.n_tracers; ++t) {
    const float* mean = g.means + t * wplane + wij;  // the element's own mean
    n.m_l = n.wall_l ? 0.0f : mean[-ld];
    n.m_r = n.wall_r ? 0.0f : mean[ld];
    n.m_b = n.wall_b ? 0.0f : mean[-1];
    n.m_t = n.wall_t ? 0.0f : mean[1];
    float val[K], out[K];
#pragma unroll
    for (int d = 0; d < K; ++d) val[d] = g.psi[(d * g.n_tracers + t) * plane + ij];
    dg_tvb_limit<kDeg>(g.tb, val, n, out);
#pragma unroll
    for (int d = 1; d < K; ++d) g.psi[(d * g.n_tracers + t) * plane + ij] = out[d];
  }
}

}  // namespace nst
