// The higher-order (CG2/dG1) mEVP single-launch kernel (ho_single.cu) as a
// template on the resident const planes, the form (momentum, metric) and the
// periodic form, shared by the three sources that instantiate it:
// ho_single.cu (the closed unweighted instances of a uniform mesh, and the
// entry points), ho_single_forms.cu (the A-weighted and periodic forms) and
// ho_single_metric.cu (the metric forms of a graded or spherical mesh),
// which nvcc compiles in parallel. The design is described in ho_single.cu.
#pragma once

#include <cooperative_groups.h>

#include <cstring>

#include "ho_body.cuh"
#include "tile_exchange.cuh"

namespace cg = cooperative_groups;

namespace nst {

// 512 threads at one block an SM leave the bodies 128 registers.
constexpr int kHoSingleMaxThreads = 512;

struct HoSingleArgs {
  float* state;                  // (17, nx, ny), updated in place
  unsigned long long* exchange;  // (tiles, 17, TR + TC): each tile's edges, zero at launch
  HoConsts k;
  int nx, ny, n_sub;
  int tile_r, tile_c, tiles_j;  // TR x TC tiles, tiles_j of them along j
  HoScalars s;
  HoTables t;
  int wrap;  // the periodic instances' axes (kWrapX, kWrapY), tiled exactly; last, so that
             // the closed instances read their parameters at the offsets they always had
};

// kConstsShared: the const planes of the form (ho_const_planes) in shared
// memory beside the state. kForm: the momentum form (kHoWeighted) and the
// metric form (kHoMetric: the strain reads the element's reciprocal widths,
// the forces each neighbour element's widths, from shared memory for the
// tile's own elements where the consts are there, else at the element's
// (wrapped) index in global memory). kWrap: the periodic form, whose tiles
// form a ring on the axes of a.wrap; without it a.wrap is not read and the
// code is the closed domain's.
template <bool kConstsShared, int kForm, bool kWrap>
__global__ void __launch_bounds__(kHoSingleMaxThreads, 1) ho_single_kernel(HoSingleArgs a) {
  constexpr int kPlaneConsts = ho_plane_consts(kForm);
  constexpr bool kMetric = (kForm & kHoMetric) != 0;
  extern __shared__ float smem[];
  TileView<kHoStatePlanes, kWrap> t;
  t.tile = tile_of_block(a.tiles_j);
  if constexpr (kWrap) t.wrap = a.wrap;
  t.tr = a.tile_r;
  t.tc = a.tile_c;
  t.i0 = t.tile.ti * t.tr;
  t.j0 = t.tile.tj * t.tc;
  t.nx = a.nx;
  t.ny = a.ny;
  t.pitch = t.tc + 2;
  t.edge = t.tr + t.tc;
  t.exchange = a.exchange;
  const int tr = t.tr, tc = t.tc, ny = a.ny, pitch = t.pitch;
  const int plane = (tr + 2) * pitch, owned = tr * tc;
  float* konst = smem + kHoStatePlanes * plane;  // (29 or 33, TR, TC) where kConstsShared
  const long gplane = static_cast<long>(a.nx) * ny;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const auto global = [&](int r, int c) { return static_cast<long>(t.i0 + r) * ny + (t.j0 + c); };

  // The load: the tile and its apron at TR and TC, zeros beyond the domain
  // and in the apron at -1 (the stresses there arrive before they are read).
  // On a periodic axis the apron beyond the last tile is the first tile's
  // edge, read at its wrapped index.
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int x = tid; x < plane; x += n_threads) {
    const int r = region_row(x, inv_pitch) - 1, c = x - (r + 1) * pitch - 1;
    const bool in = r >= 0 && c >= 0 && t.inside(r, c);
    const long ij = kWrap ? (in ? static_cast<long>(t.index(r, c)) : 0) : global(r, c);
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) smem[p * plane + x] = in ? a.state[p * gplane + ij] : 0.0f;
  }
  const float inv_tc = 1.0f / static_cast<float>(tc);
  if (kConstsShared) {
    for (int x = tid; x < owned; x += n_threads) {
      const int r = region_row(x, inv_tc), c = x - r * tc;
      const bool in = t.inside(r, c);
      const long ij = global(r, c);
      konst[x] = in ? __ldg(a.k.strength + ij) : 0.0f;
#pragma unroll
      for (int q = 0; q < kPlaneConsts; ++q) {
#pragma unroll
        for (int p = 0; p < kHoPlanes; ++p) {
          konst[(1 + kHoPlanes * q + p) * owned + x] =
              in ? __ldg(ho_const_plane(a.k, q, p) + ij) : 0.0f;
        }
      }
      if constexpr (kMetric) {
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          konst[ho_width_plane(kForm, w) * owned + x] = in ? __ldg(ho_width(a.k, w) + ij) : 0.0f;
        }
      }
    }
  }
  // The metric form's width w of the tile's element (r, c), x = r TC + c.
  const auto own_width = [&](int w, int r, int c, int x) {
    return kConstsShared ? konst[ho_width_plane(kForm, w) * owned + x]
                         : __ldg(ho_width(a.k, w) + global(r, c));
  };
  __syncthreads();

  for (int sub = 0; sub < a.n_sub; ++sub) {
    // Stress half, element (r, c) of the tile: node indices r..r+1, c..c+1,
    // at TR or TC the apron. The last row and column go to the exchange.
    const int stress_half = 2 * sub + 1;
    for (int x = tid; x < owned; x += n_threads) {
      const int r = region_row(x, inv_tc), c = x - r * tc;
      if (!t.inside(r, c)) continue;
      const int e = t.cell(r, c);
      float u[kHoNodes], v[kHoNodes];
      ho_gather([&](int p, int di, int dj) { return smem[p * plane + e + di * pitch + dj]; }, u);
      ho_gather([&](int p, int di, int dj) { return smem[(kHoPlanes + p) * plane + e + di * pitch + dj]; },
                v);
      float sig[3 * kHoCoeffs];  // s11, s22, s12: planes kHoS11 .. kHoS12 + 2
      float* s11 = sig;
      float* s22 = sig + kHoCoeffs;
      float* s12 = sig + 2 * kHoCoeffs;
#pragma unroll
      for (int q = 0; q < 3 * kHoCoeffs; ++q) sig[q] = smem[(kHoS11 + q) * plane + e];
      const float strength = kConstsShared ? konst[x] : __ldg(a.k.strength + global(r, c));
      if constexpr (kMetric) {
        ho_stress_body(a.t, a.s, u, v, s11, s22, s12, strength, own_width(kHoInvDx, r, c, x),
                       own_width(kHoInvDy, r, c, x));
      } else {
        ho_stress_body(a.t, a.s, u, v, s11, s22, s12, strength, a.s.inv_dx, a.s.inv_dy);
      }
#pragma unroll
      for (int q = 0; q < 3 * kHoCoeffs; ++q) smem[(kHoS11 + q) * plane + e] = sig[q];
      t.publish(r, c, 1, kHoS11, kHoStatePlanes, sig, stress_half);
    }
    // The stresses of the tiles before this one into the apron at -1.
    for (int x = tid; x < (t.edge + 1) * 3 * kHoCoeffs; x += n_threads) {
      t.take(smem, plane, x, -1, kHoS11, stress_half);
    }
    __syncthreads();

    // Velocity half, node index (r, c) of the tile: elements r-1..r,
    // c-1..c, at -1 the apron. The first row and column go to the exchange.
    const bool last = sub + 1 == a.n_sub;
    const int velocity_half = 2 * sub + 2;
    for (int x = tid; x < owned; x += n_threads) {
      const int r = region_row(x, inv_tc), c = x - r * tc;
      if (!t.inside(r, c)) continue;
      const int e = t.cell(r, c);
      float uv[2 * kHoPlanes];
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) uv[p] = smem[p * plane + e];
      const auto load = [&](int di, int dj, float* s11, float* s22, float* s12) {
        const int f = e + di * pitch + dj;
#pragma unroll
        for (int q = 0; q < kHoCoeffs; ++q) {
          s11[q] = smem[(kHoS11 + q) * plane + f];
          s22[q] = smem[(kHoS22 + q) * plane + f];
          s12[q] = smem[(kHoS12 + q) * plane + f];
        }
      };
      // The widths of element (r + di, c + dj): in the metric form the
      // tile's own element's from own_width, a neighbour's at its (wrapped)
      // index, zeros beyond a closed domain (whose stresses are zeros).
      const auto widths = [&](int di, int dj) {
        if constexpr (kMetric) {
          if (di == 0 && dj == 0) return make_float2(own_width(kHoDx, r, c, x), own_width(kHoDy, r, c, x));
          if (!t.inside(r + di, c + dj)) return make_float2(0.0f, 0.0f);
          const int ij = t.index(r + di, c + dj);
          return make_float2(__ldg(a.k.dx + ij), __ldg(a.k.dy + ij));
        } else {
          return ho_uniform_widths(a.s);
        }
      };
      if (kConstsShared) {
        ho_velocity_update<kForm>(
            a.t, a.s, [&](int q, int p) { return konst[(1 + kHoPlanes * q + p) * owned + x]; },
            load, widths, uv);
      } else {
        ho_velocity_body<kForm>(a.t, a.s, a.k, global(r, c), load, widths, uv);
      }
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) smem[p * plane + e] = uv[p];
      if (!last) t.publish(r, c, -1, 0, 2 * kHoPlanes, uv, velocity_half);
    }
    if (last) break;
    // The velocities of the tiles after this one into the apron at TR and TC.
    for (int x = tid; x < (t.edge + 1) * 2 * kHoPlanes; x += n_threads) {
      t.take(smem, plane, x, 1, 0, velocity_half);
    }
    __syncthreads();
  }

  // Write the tile back (its cells inside the domain).
  __syncthreads();
  for (int x = tid; x < owned; x += n_threads) {
    const int r = region_row(x, inv_tc), c = x - r * tc;
    if (!t.inside(r, c)) continue;
    const long ij = global(r, c);
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) a.state[p * gplane + ij] = smem[p * plane + t.cell(r, c)];
  }
}

using HoSingleKernel = void (*)(HoSingleArgs);

// The kernel of a form (kHoWeighted, kHoMetric, and the periodic axes' bits
// shifted by kFormWrapShift) with or without its consts in shared memory;
// null for an unknown form. The closed unweighted instances of a uniform
// mesh are compiled in ho_single.cu, the metric forms in
// ho_single_metric.cu, the others in ho_single_forms.cu.
HoSingleKernel ho_single_of(bool consts_shared, int form);
HoSingleKernel ho_single_forms_of(bool consts_shared, int form);
HoSingleKernel ho_single_metric_of(bool consts_shared, int form);

// Dynamic shared memory of one block: the 17 state planes of a TR x TC tile
// and its apron, and the const planes of the form where consts_shared.
inline int ho_single_bytes(int tile_r, int tile_c, bool consts_shared, int form) {
  return kHoStatePlanes * (tile_r + 2) * (tile_c + 2) * static_cast<int>(sizeof(float)) +
         (consts_shared ? ho_const_planes(form) * tile_r * tile_c * static_cast<int>(sizeof(float))
                        : 0);
}

}  // namespace nst
