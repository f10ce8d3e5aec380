// The higher-order (CG2/dG1) mEVP ghost-zone kernel (ho_tiled.cu) as a
// template on the sub-window width, the form (momentum, metric) and the
// periodic form, shared by the three sources that instantiate it:
// ho_tiled.cu (the closed unweighted instances of a uniform mesh, and the
// entry points), ho_tiled_forms.cu (the A-weighted and periodic forms) and
// ho_tiled_metric.cu (the metric forms of a graded or spherical mesh),
// which nvcc compiles in parallel. The design is described in ho_tiled.cu.
#pragma once

#include "cluster_window.cuh"
#include "ho_body.cuh"

namespace nst {

constexpr int kHoTiledMaxThreads = 512;  // the body's registers (up to 128) at 1 block per SM
constexpr int kHoTiledMaxClusterBlocks = 16;  // the H100's non-portable cluster size

// The 9 stress coefficients at shared-memory cell `from` (plane stride
// `plane`) into cell `to` of `dst`.
__device__ __forceinline__ void copy_stress(float* dst, int to, const float* src, int from,
                                            int plane) {
#pragma unroll
  for (int p = kHoS11; p < kHoStatePlanes; ++p) dst[p * plane + to] = src[p * plane + from];
}

// The 8 velocity values at cell `from` of `src` into cell `to` of `dst`.
__device__ __forceinline__ void copy_velocity(float* dst, int to, const float* src, int from,
                                              int plane) {
#pragma unroll
  for (int p = 0; p < 2 * kHoPlanes; ++p) dst[p * plane + to] = src[p * plane + from];
}

// kS: the sub-window width where it is known at compile time (shared-memory
// offsets become immediates), 0 where it is read from sub_w. kForm: the
// momentum form (kHoWeighted) and the metric form (kHoMetric: each element's
// widths read from global memory at its (wrapped) index, the apron's
// elements too). kWrap: the periodic form, whose windows wrap on the axes of
// `wrap` (read only there; last, so that the closed instances read their
// parameters at the offsets they always had).
template <int kS, int kForm, bool kWrap>
__global__ void __launch_bounds__(kHoTiledMaxThreads)
ho_tiled_kernel(const float* __restrict__ state_in, float* __restrict__ state_out, HoConsts k,
                int nx, int ny, int sub_w, int halo, int n_sub, HoScalars s, HoTables t,
                int wrap) {
  constexpr bool kMetric = (kForm & kHoMetric) != 0;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPos pos = cluster_pos(cluster);
  const int S = kS ? kS : sub_w;
  // Local cell (a, b), a, b in [0, S) and -1, S on the apron, at cell(a, b)
  // of each plane.
  const int pitch = S + 2;
  const int plane = pitch * pitch;
  const auto cell = [&](int a, int b) { return (a + 1) * pitch + (b + 1); };

  // The cluster's window is (wa, wb) cells; local cell (a, b) is window
  // cell (A0 + a, B0 + b) and grid cell (i0 + a, j0 + b).
  const int wa = pos.ny * S, wb = pos.nx * S;
  const int A0 = pos.y * S, B0 = pos.x * S;
  const int i0 = static_cast<int>(blockIdx.y) / pos.ny * (wa - 2 * halo) - halo + A0;
  const int j0 = static_cast<int>(blockIdx.x) / pos.nx * (wb - 2 * halo) - halo + B0;
  const long gplane = static_cast<long>(nx) * ny;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  // A domain cell: on a periodic axis every cell is one, at its wrapped
  // index (index()); the closed instances run the closed expressions.
  const bool wx = kWrap && (wrap & kWrapX) != 0, wy = kWrap && (wrap & kWrapY) != 0;
  const auto inside = [&](int i, int j) {
    if constexpr (kWrap) {
      return (wx || (i >= 0 && i < nx)) && (wy || (j >= 0 && j < ny));
    } else {
      return i >= 0 && i < nx && j >= 0 && j < ny;
    }
  };
  const auto index = [&](int i, int j) {
    if constexpr (kWrap) wrap_ij(i, j, nx, ny, wrap);
    return static_cast<long>(i) * ny + j;
  };

  // The load: the sub-window and its apron, zeros beyond the domain (on a
  // periodic axis: from the opposite side), row by row, consecutive threads
  // on consecutive cells of a row.
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int c = tid; c < plane; c += n_threads) {
    const int da = region_row(c, inv_pitch);
    const int i = i0 + da - 1, j = j0 + c - da * pitch - 1;
    const bool in = inside(i, j);
    const long ij = kWrap ? (in ? index(i, j) : 0) : static_cast<long>(i) * ny + j;
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) smem[p * plane + c] = in ? state_in[p * gplane + ij] : 0.0f;
  }
  window_sync(cluster, pos);

  // One phase: fn(a, b) on the cells [la, la + ra) x [lb, lb + rb) of the
  // sub-window, row by row; then, in a cluster of more than one block, the
  // block's barrier and push(): the edge row and column into the
  // neighbours' aprons (all S cells of each: a cell the phase left alone
  // holds what the apron holds already); then the cluster's barrier. The
  // pushes stay out of the loop over the cells, whose code is then the
  // single-window kernel's.
  const bool alone = pos.nx * pos.ny == 1;
  const auto phase = [&](int la, int ra, int lb, int rb, auto fn, auto push) {
    const float inv_rb = 1.0f / static_cast<float>(max(rb, 1));
    for (int idx = tid; idx < (ra > 0 && rb > 0 ? ra * rb : 0); idx += n_threads) {
      const int da = region_row(idx, inv_rb);
      fn(la + da, lb + idx - da * rb);
    }
    if (!alone) {
      __syncthreads();
      for (int e = tid; e < 2 * S + 1; e += n_threads) push(e);
    }
    window_sync(cluster, pos);
  };
  // Edge cell e of a push: e < S along the row at `line`, S <= e < 2S down
  // the column at `line`, 2S the corner; the neighbour that reads it is
  // (dx, dy) blocks away, and takes it at `to` of its apron (dx, dy = +1:
  // the stress phase's last row and column, down and right; -1: the
  // velocity phase's first ones, up and left).
  const auto push_edge = [&](int e, int line, int dir, int apron, auto copy) {
    const int a = e < S ? line : e < 2 * S ? e - S : line;
    const int b = e < S ? e : line;
    const int dy = e == 2 * S || e < S ? dir : 0, dx = e >= S ? dir : 0;
    const int x = pos.x + dx, y = pos.y + dy;
    if (x < 0 || x >= pos.nx || y < 0 || y >= pos.ny) return;
    copy(cluster.map_shared_rank(smem, pos.rank(x, y)), cell(dy ? apron : a, dx ? apron : b),
         smem, cell(a, b), plane);
  };

  for (int sub = 0; sub < n_sub; ++sub) {
    // Stress phase: element (A, B) reads node indices A..A+1, B..B+1, which
    // are valid on [sub, w - sub), so elements [sub, w - 1 - sub) of the
    // window are computed: of this sub-window, [la, la + ra) x [lb, lb + rb).
    int la = max(sub - A0, 0), lb = max(sub - B0, 0);
    phase(la, min(wa - 1 - sub - A0, S) - la, lb, min(wb - 1 - sub - B0, S) - lb, [&](int a, int b) {
      const int i = i0 + a, j = j0 + b;
      if (!inside(i, j)) return;
      const int c = cell(a, b);
      // Node indices a..a+1, b..b+1: beyond the last row or column, the
      // apron, which the next block pushed in its velocity phase.
      float u[kHoNodes], v[kHoNodes];
      ho_gather([&](int p, int di, int dj) { return smem[p * plane + c + di * pitch + dj]; }, u);
      ho_gather([&](int p, int di, int dj) { return smem[(kHoPlanes + p) * plane + c + di * pitch + dj]; },
                v);
      float s11[kHoCoeffs], s22[kHoCoeffs], s12[kHoCoeffs];
#pragma unroll
      for (int q = 0; q < kHoCoeffs; ++q) {
        s11[q] = smem[(kHoS11 + q) * plane + c];
        s22[q] = smem[(kHoS22 + q) * plane + c];
        s12[q] = smem[(kHoS12 + q) * plane + c];
      }
      const long ij = index(i, j);
      if constexpr (kMetric) {
        ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + ij), __ldg(k.inv_dx + ij),
                       __ldg(k.inv_dy + ij));
      } else {
        ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + ij), s.inv_dx, s.inv_dy);
      }
#pragma unroll
      for (int q = 0; q < kHoCoeffs; ++q) {
        smem[(kHoS11 + q) * plane + c] = s11[q];
        smem[(kHoS22 + q) * plane + c] = s22[q];
        smem[(kHoS12 + q) * plane + c] = s12[q];
      }
    }, [&](int e) { push_edge(e, S - 1, 1, -1, copy_stress); });  // last row and column: down, right

    // Velocity phase: node index (A, B) reads elements A-1..A, B-1..B, valid
    // on [sub, w - 1 - sub): node indices [sub + 1, w - 1 - sub) are computed.
    la = max(sub + 1 - A0, 0);
    lb = max(sub + 1 - B0, 0);
    phase(la, min(wa - 1 - sub - A0, S) - la, lb, min(wb - 1 - sub - B0, S) - lb, [&](int a, int b) {
      const int i = i0 + a, j = j0 + b;
      if (!inside(i, j)) return;
      const int c = cell(a, b);
      float uv[2 * kHoPlanes];
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) uv[p] = smem[p * plane + c];
      // Elements beyond the domain read the window's zeros; before the
      // first row or column, the apron, which the previous block pushed in
      // its stress phase.
      ho_velocity_body<kForm>(t, s, k, index(i, j),
                       [&](int di, int dj, float* s11, float* s22, float* s12) {
                         const int e = c + di * pitch + dj;
#pragma unroll
                         for (int q = 0; q < kHoCoeffs; ++q) {
                           s11[q] = smem[(kHoS11 + q) * plane + e];
                           s22[q] = smem[(kHoS22 + q) * plane + e];
                           s12[q] = smem[(kHoS12 + q) * plane + e];
                         }
                       },
                       // The widths of element (i + di, j + dj): in the
                       // metric form at its (wrapped) index, zeros beyond a
                       // closed domain (whose stresses are zeros).
                       [&](int di, int dj) {
                         if constexpr (kMetric) {
                           if (!inside(i + di, j + dj)) return make_float2(0.0f, 0.0f);
                           const long e = index(i + di, j + dj);
                           return make_float2(__ldg(k.dx + e), __ldg(k.dy + e));
                         } else {
                           return ho_uniform_widths(s);
                         }
                       },
                       uv);
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) smem[p * plane + c] = uv[p];
    }, [&](int e) { push_edge(e, 0, -1, S, copy_velocity); });  // first row and column: up, left
  }

  // The window's interior (window cells [halo, w - halo)) is exact. The
  // last barrier above keeps every block until no neighbour writes its apron.
  const int la = max(halo - A0, 0), lb = max(halo - B0, 0);
  const int ra = min(wa - halo - A0, S) - la, rb = min(wb - halo - B0, S) - lb;
  const float inv_r = 1.0f / static_cast<float>(max(rb, 1));
  for (int idx = tid; idx < (ra > 0 && rb > 0 ? ra * rb : 0); idx += n_threads) {
    const int da = region_row(idx, inv_r);
    const int a = la + da, b = lb + idx - da * rb;
    const int i = i0 + a, j = j0 + b;
    if (i >= nx || j >= ny) continue;
    const int c = cell(a, b);
    const long ij = static_cast<long>(i) * ny + j;
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) state_out[p * gplane + ij] = smem[p * plane + c];
  }
}

using HoTiledKernel = void (*)(const float*, float*, HoConsts, int, int, int, int, int,
                               HoScalars, HoTables, int);

// The kernel of a sub-window width (the shipped width 48 has its own) and a
// form (kHoWeighted, kHoMetric, and the periodic axes' bits shifted by
// kFormWrapShift); null for an unknown form. The closed unweighted instances
// of a uniform mesh are compiled in ho_tiled.cu, the metric forms in
// ho_tiled_metric.cu, the others in ho_tiled_forms.cu.
HoTiledKernel ho_tiled_of(int sub, int form);
HoTiledKernel ho_tiled_forms_of(int sub, int form);
HoTiledKernel ho_tiled_metric_of(int sub, int form);

}  // namespace nst
