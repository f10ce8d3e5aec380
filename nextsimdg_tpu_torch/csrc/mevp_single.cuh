// The CG1 mEVP single-launch kernel (mevp_single.cu) as a template on the
// mesh, the resident const planes and the momentum form, shared by the
// sources that instantiate it: mevp_single.cu (the fixed-alpha forms, and
// the entry points), mevp_single_adaptive.cu (the adaptive-alpha forms) and
// the periodic sources, which nvcc compiles in parallel. The design is
// described in mevp_single.cu. Its pieces (the tile's view and owned cells,
// the load, the subcycle loop, the store) are device functions, which
// fused_dynamics.cuh runs ahead of the CFL count and the transport.
#pragma once

#include <algorithm>
#include <cstring>

#include "mevp_body.cuh"
#include "tile_exchange.cuh"

namespace nst {


constexpr int kSingleMaxThreads = 1024;
constexpr int kSinglePlanes = 5;    // u, v, s11, s22, s12: the state and an exchange slot
constexpr int kSingleMaxCells = 8;  // tile rows a thread owns, at most
constexpr int kSU = 0, kSV = 1, kS11 = 2;

// Const plane p's place in the order in which the host keeps const planes in
// shared memory (mevp_single_cuda.RESIDENT_ORDER, among the 12 metric or the
// 7 uniform consts, and a_node last in the weighted form): the velocity half
// reads half_dx and half_dy at four elements each, dt_m and the ocean
// current are read by both halves, the others once a subcycle. A kernel
// keeps the first kResident in shared memory, at that place, and reads the
// others from global memory (kMevpConstPlanes: a plane that a uniform mesh
// does not have).
__host__ __device__ constexpr int resident_rank(bool metric, int p) {
  return metric ? (p == kHalfDx ? 0 : p == kHalfDy ? 1 : p == kDtM ? 2 : p == kUo ? 3 : p == kVo ? 4
                   : p == kStrength ? 5 : p == kActive ? 6 : p == kBu ? 7 : p == kBv ? 8
                   : p == kInvDx ? 9 : p == kInvDy ? 10 : p == kInvW ? 11 : 12)
                : (p == kDtM ? 0 : p == kUo ? 1 : p == kVo ? 2 : p == kStrength ? 3 : p == kActive ? 4
                   : p == kBu ? 5 : p == kBv ? 6 : p == kANode ? 7 : kMevpConstPlanes);
}

// The count of "all planes" of a mesh and form: 12 or 7, and a_node.
__host__ __device__ constexpr int all_planes(bool metric, int form) {
  return (metric ? 12 : 7) + ((form & kFormWeighted) != 0 ? 1 : 0);
}

struct SingleArgs {
  float* state[kSinglePlanes];   // u, v, s11, s22, s12, each (nx, ny), updated in place
  unsigned long long* exchange;  // (tiles, 5, TR + TC): each tile's edges, zero at launch
  MevpConsts k;
  int nx, ny, n_sub;
  int tile_r, tile_c, tiles_j;  // TR x TC tiles, tiles_j of them along j
  MevpScalars s;
  int wrap;  // the periodic instances' axes (kWrapX, kWrapY), tiled exactly; last, so that
             // the closed instances read their parameters at the offsets they always had
};

// A block's view of its tile (tile_exchange.cuh) for the launch's arguments.
template <bool kWrap>
__device__ __forceinline__ TileView<kSinglePlanes, kWrap> single_view(const SingleArgs& a) {
  TileView<kSinglePlanes, kWrap> t;
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
  return t;
}

// The cells a thread owns for the whole launch, each both an element and a
// node: column c of the tile rows r0, r0 + rows, ... below r_end (none
// beyond the domain), at most kSingleMaxCells of them.
struct OwnedCells {
  int r0, rows, c, j, r_end;
  // fn(q, r) for the q-th owned cell, at tile row r.
  template <class Fn>
  __device__ __forceinline__ void each(Fn fn) const {
#pragma unroll
    for (int q = 0; q < kSingleMaxCells; ++q) {
      int r = r0 + q * rows;
      // Opaque to the compiler, so that the cells' addresses are not all
      // hoisted out of the subcycle loop into registers (they spill).
      asm volatile("" : "+r"(r));
      if (r < r_end) fn(q, r);
    }
  }
};

template <class View>
__device__ __forceinline__ OwnedCells owned_cells(const View& t) {
  const int tid = threadIdx.x, rows = static_cast<int>(blockDim.x) / t.tc;
  const int r0 = tid / t.tc, c = tid - r0 * t.tc, j = t.j0 + c;
  return {r0, rows, c, j, r0 < rows && j < t.ny ? min(t.tr, t.nx - t.i0) : 0};
}

// The load: every cell of the tile and its apron that lies in the domain,
// zeros elsewhere, into the 5 state planes and the kResident resident const
// planes after them (smem, planes of `plane` floats). The state's apron at
// -1 (stresses) stays zero until the exchange fills it, before it is read;
// the consts' apron at -1 holds the half_dx and half_dy that the velocity
// half weighs those stresses by.
template <bool kMetric, int kResident, bool kWrap>
__device__ __forceinline__ void single_load(const SingleArgs& a,
                                            const TileView<kSinglePlanes, kWrap>& t, float* smem,
                                            int plane) {
  const float inv_pitch = 1.0f / static_cast<float>(t.pitch);
  float* const konst = smem + kSinglePlanes * plane;
  const int n_threads = blockDim.x;
  for (int x = threadIdx.x; x < plane; x += n_threads) {
    const int r = region_row(x, inv_pitch) - 1, c = x - (r + 1) * t.pitch - 1;
    const bool in = t.inside(r, c), state_in = in && r >= 0 && c >= 0;
    const int ij = in ? (kWrap ? t.index(r, c) : (t.i0 + r) * a.ny + (t.j0 + c)) : 0;
#pragma unroll
    for (int p = 0; p < kSinglePlanes; ++p) smem[p * plane + x] = state_in ? a.state[p][ij] : 0.0f;
#pragma unroll
    for (int p = 0; p < kMevpConstPlanes; ++p) {
      if (resident_rank(kMetric, p) < kResident) {
        konst[resident_rank(kMetric, p) * plane + x] = in ? __ldg(mevp_const_plane(a.k, p) + ij) : 0.0f;
      }
    }
  }
}

// a.n_sub subcycles on the loaded tile (after a block barrier). kLastEdge:
// the last velocity half, too, publishes its first row and column and
// takes the next tiles' into the apron at TR and TC (fused_dynamics, which
// samples the final velocity there); without it that half ends the launch's
// exchange.
template <bool kMetric, int kResident, int kForm, bool kWrap, bool kLastEdge>
__device__ __forceinline__ void single_subcycles(const SingleArgs& a,
                                                 const TileView<kSinglePlanes, kWrap>& t,
                                                 const OwnedCells& own, float* smem, int plane) {
  const int pitch = t.pitch, nx = a.nx, ny = a.ny, c = own.c, j = own.j;
  float* const su = smem;
  float* const sv = su + plane;
  float* const s11 = sv + plane;
  float* const s22 = s11 + plane;
  float* const s12 = s22 + plane;
  float* const konst = smem + kSinglePlanes * plane;  // the resident const planes, same layout
  const auto shared = [](int p) { return resident_rank(kMetric, p) < kResident; };
  const int tid = threadIdx.x, n_threads = blockDim.x;
  // Const plane p at the cell of shared index e and domain index ij.
  const auto cst = [&](int p, int e, int ij) {
    return shared(p) ? konst[resident_rank(kMetric, p) * plane + e] : __ldg(mevp_const_plane(a.k, p) + ij);
  };
  // The stresses s around the node at e, times metric plane p of their own
  // element (0 beyond the domain, as weighted() of mevp_body.cuh).
  const auto weighted = [&](const float* s, int p, int e, int ij, int i) {
    if (!shared(p)) {
      return kWrap ? weighted_tile_wrap(s, mevp_const_plane(a.k, p), e, pitch, i, j, nx, ny, a.wrap)
                   : weighted_tile(s, mevp_const_plane(a.k, p), e, pitch, ij, i, j, nx, ny);
    }
    const float* w = konst + resident_rank(kMetric, p) * plane;
    return Around{s[e] * w[e], s[e - pitch] * w[e - pitch], s[e - 1] * w[e - 1],
                  s[e - pitch - 1] * w[e - pitch - 1]};
  };

  float cw[kSingleMaxCells], inv[kSingleMaxCells], bt[kSingleMaxCells];
  for (int sub = 0; sub < a.n_sub; ++sub) {
    // Stress half, element (r, c): nodes r..r+1, c..c+1 (at TR or TC the
    // apron). The last row and column go to the exchange.
    const int stress_half = 2 * sub + 1;
    own.each([&](int q, int r) {
      const int e = t.cell(r, c), ij = (t.i0 + r) * ny + j;
      const StressOut o = mevp_stress_body<kForm>(
          su[e], su[e + pitch], su[e + 1], su[e + pitch + 1], sv[e], sv[e + pitch], sv[e + 1],
          sv[e + pitch + 1], s11[e], s22[e], s12[e], cst(kStrength, e, ij), cst(kDtM, e, ij),
          cst(kActive, e, ij), cst(kUo, e, ij), cst(kVo, e, ij),
          kMetric ? cst(kInvDx, e, ij) : a.s.inv_dx, kMetric ? cst(kInvDy, e, ij) : a.s.inv_dy,
          a.s, (kForm & kFormWeighted) != 0 ? cst(kANode, e, ij) : 1.0f,
          (kForm & kFormAdaptive) == 0 ? 0.0f : kMetric ? cst(kInvW, e, ij) : a.s.inv_w);
      s11[e] = o.s11;
      s22[e] = o.s22;
      s12[e] = o.s12;
      cw[q] = o.c_w;
      inv[q] = o.inv_drag;
      if constexpr ((kForm & kFormAdaptive) != 0) bt[q] = o.beta;
      const float sig[3] = {o.s11, o.s22, o.s12};
      t.publish(r, c, 1, kS11, kSinglePlanes, sig, stress_half);
    });
    // The stresses of the tiles before this one into the apron at -1.
    for (int x = tid; x < (t.edge + 1) * 3; x += n_threads) t.take(smem, plane, x, -1, kS11, stress_half);
    __syncthreads();

    // Velocity half, node (r, c): elements r-1..r, c-1..c (at -1 the
    // apron), and the c_w and inv_drag of element (r, c) from above. The
    // first row and column go to the exchange.
    const bool edge = kLastEdge || sub + 1 != a.n_sub;
    const int velocity_half = 2 * sub + 2;
    own.each([&](int q, int r) {
      const int e = t.cell(r, c), i = t.i0 + r, ij = i * ny + j;
      float2 f;
      float inv_w;
      if (kMetric) {
        f = forces_metric(weighted(s11, kHalfDy, e, ij, i), weighted(s12, kHalfDx, e, ij, i),
                          weighted(s12, kHalfDy, e, ij, i), weighted(s22, kHalfDx, e, ij, i));
        inv_w = cst(kInvW, e, ij);
      } else {
        const Around a11 = {s11[e], s11[e - pitch], s11[e - 1], s11[e - pitch - 1]};
        const Around a22 = {s22[e], s22[e - pitch], s22[e - 1], s22[e - pitch - 1]};
        const Around a12 = {s12[e], s12[e - pitch], s12[e - 1], s12[e - pitch - 1]};
        f = forces_uniform(a11, a22, a12, a.s);
        inv_w = a.s.inv_w;
      }
      const float2 uv = mevp_velocity_body(
          f, inv_w, su[e], sv[e], cst(kUo, e, ij), cst(kVo, e, ij), cw[q], cst(kDtM, e, ij),
          cst(kBu, e, ij), cst(kBv, e, ij), inv[q], (kForm & kFormAdaptive) != 0 ? bt[q] : a.s.beta,
          a.s);
      su[e] = uv.x;
      sv[e] = uv.y;
      if (edge) {
        const float vel[2] = {uv.x, uv.y};
        t.publish(r, c, -1, kSU, kSV + 1, vel, velocity_half);
      }
    });
    if (!edge) break;
    // The velocities of the tiles after this one into the apron at TR and TC.
    for (int x = tid; x < (t.edge + 1) * 2; x += n_threads) t.take(smem, plane, x, 1, kSU, velocity_half);
    __syncthreads();
  }
}

// Write the tile back: each thread its own cells, which it wrote last.
template <class View>
__device__ __forceinline__ void single_store(const SingleArgs& a, const View& t,
                                             const OwnedCells& own, const float* smem, int plane) {
  own.each([&](int, int r) {
    const int e = t.cell(r, own.c), ij = (t.i0 + r) * a.ny + own.j;
#pragma unroll
    for (int p = 0; p < kSinglePlanes; ++p) a.state[p][ij] = smem[p * plane + e];
  });
}

// kWrap: the periodic form, whose tiles form a ring on the axes of a.wrap;
// without it a.wrap is not read and the code is the closed domain's.
template <bool kMetric, int kResident, int kForm, bool kWrap>
__global__ void __launch_bounds__(kSingleMaxThreads, 1) mevp_single_kernel(SingleArgs a) {
  extern __shared__ float smem[];
  const TileView<kSinglePlanes, kWrap> t = single_view<kWrap>(a);
  const int plane = (t.tr + 2) * t.pitch;
  single_load<kMetric, kResident, kWrap>(a, t, smem, plane);
  __syncthreads();
  const OwnedCells own = owned_cells(t);
  single_subcycles<kMetric, kResident, kForm, kWrap, false>(a, t, own, smem, plane);
  single_store(a, t, own, smem, plane);
}

// The kernel for a mesh (metric or uniform) and momentum form with the
// first n_resident of its const planes in shared memory: none, one, two or
// all of them (null for another count).
template <bool kMetric, int kForm, bool kWrap>
const void* single_kernel_of(int n_resident) {
  constexpr int kAll = all_planes(kMetric, kForm);
  switch (n_resident) {
    case 0: return reinterpret_cast<const void*>(&mevp_single_kernel<kMetric, 0, kForm, kWrap>);
    case 1: return reinterpret_cast<const void*>(&mevp_single_kernel<kMetric, 1, kForm, kWrap>);
    case 2: return reinterpret_cast<const void*>(&mevp_single_kernel<kMetric, 2, kForm, kWrap>);
    case kAll: return reinterpret_cast<const void*>(&mevp_single_kernel<kMetric, kAll, kForm, kWrap>);
    default: return nullptr;
  }
}

template <int kForm, bool kWrap = false>
const void* single_kernel_of(bool metric, int n_resident) {
  return metric ? single_kernel_of<true, kForm, kWrap>(n_resident)
                : single_kernel_of<false, kForm, kWrap>(n_resident);
}

// The adaptive-alpha forms' kernels (mevp_single_adaptive.cu), as
// single_kernel_of<kForm>(metric, n_resident) for kForm = kFormAdaptive and
// kFormWeighted | kFormAdaptive; null for another form or count.
const void* single_kernel_adaptive(bool metric, int form, int n_resident);

// The periodic instances of every form (mevp_single_periodic.cu, and
// mevp_single_periodic_adaptive.cu for the adaptive forms); null for an
// unknown form or count.
const void* single_kernel_periodic(bool metric, int form, int n_resident);
const void* single_kernel_periodic_adaptive(bool metric, int form, int n_resident);

}  // namespace nst
