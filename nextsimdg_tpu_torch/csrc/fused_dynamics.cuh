// The whole CG1 dynamics phase in one cooperative launch (fused_dynamics.cu)
// as two kernel templates, shared by the sources that instantiate them:
//
//   fused_dynamics_kernel, the headline's form (a closed mesh, fixed alpha,
//       unweighted stresses, dG1 rk2 without TVB) on the resident const
//       planes and the coastline form: fused_dynamics.cu (the form without
//       face masks, and the entry points) and fused_dynamics_masked.cu;
//   fused_dynamics_forms_kernel, every other form of a uniform mesh: on
//       the degree (dG0, dG1, dG2), the TVB limiter, the adaptive alpha and
//       the resident const planes, each axis closed or periodic, the
//       stresses A-weighted or not, the coastline's face masks and the
//       scheme (rk1, rk2, rk3) at run time: fused_dynamics_dg0.cu,
//       fused_dynamics_dg1.cu, fused_dynamics_dg2.cu and their _tvb forms.
//
// nvcc compiles the sources in parallel. The design is described in
// fused_dynamics.cu.
#pragma once

#include <climits>

#include "dg1_body.cuh"
#include "mevp_single.cuh"

namespace nst {

constexpr int kFusedMaxThreads = 512;  // a block: at most 512 threads (128 registers a thread)
constexpr int kFusedDeg = 1;           // dG1 ...
constexpr int kFusedTracers = 3;       // ... hice, cice, hsnow
constexpr int kFusedDofs = DgShape<kFusedDeg>::kDofs;
constexpr int kFusedPlanes = kFusedDofs * kFusedTracers;  // a tracer buffer: plane d * 3 + t
constexpr int kFusedConsts = 7;        // the uniform const set, all resident or none
// The other forms: every uniform const and a_node (a plane of ones where the
// stresses are not A-weighted: c_w * 1 is c_w), all resident or none.
constexpr int kFormConsts = kFusedConsts + 1;
constexpr int kFormMevp = kFormWeighted;  // the fixed-alpha forms' kForm; | kFormAdaptive
constexpr int kMaxStages = 3;             // rk3

// A block's threads at most, by degree: dG2's stage body (6 coefficients of
// five elements, 9 volume points, the 21-point limiter) needs more than
// the 128 registers a thread of 512 has.
template <int kDeg>
struct FusedShape {
  static constexpr int kMaxThreads = kDeg == 2 ? 256 : kFusedMaxThreads;
  static constexpr int kPlanes = DgShape<kDeg>::kDofs * kFusedTracers;
};


// Everything a launch takes.
struct FusedArgs {
  SingleArgs m;            // the mEVP part: the 5 state planes, updated in place, and their exchange
  const float* psi_in;     // (3, 3, nx, ny): the dG1 coefficients of hice, cice, hsnow
  float* psi_out;          // the same after the k substeps (not psi_in)
  const float* face_x;     // the coastline face masks (kMasks), else not read
  const float* face_y;
  unsigned long long* tracer_words;  // (tiles, 2, 9, 2 (TR + TC)), zero at launch
  unsigned long long* partials;      // (tiles, 2), zero at launch
  float* info;             // speed_x, speed_y, k: written by block 0
  DgTables<kFusedDeg> tb;
  double dt;               // the outer time step [s]: dt_sub = float(dt / k), as the host divides it
  float dt_f, dx_min, dy_min, c_stab;  // float32 roundings of dt, min dx, min dy, 0.85 / (2p + 1)
  int k_fixed;             // > 0: k (auto_substeps off); 0: k from the CFL number
  int k_floor, k_max;
};

// The other forms' launch: the headline's fields, the scheme and the TVB
// tolerances.
template <int kDeg>
struct FusedFormArgs {
  SingleArgs m;            // a.wrap: the periodic axes; k.a_node set (ones when unweighted)
  const float* psi_in;     // (K, 3, nx, ny)
  float* psi_out;
  const float* face_x;
  const float* face_y;
  unsigned long long* tracer_words;  // (tiles, 2, 3K, 2 (TR + TC)), zero at launch
  unsigned long long* partials;
  float* info;
  DgTables<kDeg> tb;
  double dt;
  float dt_f, dx_min, dy_min, c_stab;
  int k_fixed;
  int k_floor, k_max;
  int n_stages;                        // the SSP-RK scheme's stages: 1, 2 or 3
  float a[kMaxStages], b[kMaxStages];  // stage s: lim(a[s] base + b[s] (psi + dt rhs(psi))); a[0] = 0
  float tol_x, tol_y;                  // kTvb: M dx^2, M dy^2
};

// The CFL substep count from the two max speeds, as the host's
// transport.substeps_from_speeds computes it from a float32 CPU tensor: each
// operation float32, the Python scalars rounded to float32 first, the ceil's
// conversion to int32 as x86 converts (INT_MIN for NaN and out of range),
// then clamped to [k_floor, k_max] and at least 1.
template <class Args>
__device__ __forceinline__ int fused_substeps(float speed_x, float speed_y, const Args& f) {
  if (f.k_fixed > 0) return f.k_fixed;
  const float nu = (speed_x / f.dx_min + speed_y / f.dy_min) * f.dt_f;
  const float q = ceilf(nu / f.c_stab);
  int k = q >= -2147483648.0f && q < 2147483648.0f ? static_cast<int>(q) : INT_MIN;
  k = max(k, f.k_floor);
  return min(max(k, 1), f.k_max);
}

// The max of (x, y) over the block, in every thread. red: shared, two
// slots a warp and two for the result.
__device__ __forceinline__ float2 fused_block_max(float x, float y, float* red) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, offset));
    y = fmaxf(y, __shfl_down_sync(0xffffffffu, y, offset));
  }
  const int warps = static_cast<int>(blockDim.x) / 32, w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    red[2 * w] = x;
    red[2 * w + 1] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < warps; ++k) {
      x = fmaxf(x, red[2 * k]);
      y = fmaxf(y, red[2 * k + 1]);
    }
    red[2 * kFusedMaxThreads / 32] = x;
    red[2 * kFusedMaxThreads / 32 + 1] = y;
  }
  __syncthreads();
  const float2 m = make_float2(red[2 * kFusedMaxThreads / 32], red[2 * kFusedMaxThreads / 32 + 1]);
  __syncthreads();  // red may be reused
  return m;
}

// A tile's tracer edges in the exchange: per plane 2 (TR + TC) words, its
// first row (TC), last row (TC), first column (TR) and last column (TR).
template <int kPlanes>
struct TracerEdgesOf {
  unsigned long long* words;  // (tiles, 2, kPlanes, 2 (TR + TC))
  int tr, tc, span;           // span = 2 (TR + TC)
  __device__ __forceinline__ unsigned long long* slot(int b, int parity) const {
    return words + (static_cast<long>(b) * 2 + parity) * kPlanes * span;
  }
  // Plane pl of the owned cell (r, c) to its edges' words, where it lies
  // on one.
  __device__ __forceinline__ void publish(unsigned long long* mine, int pl, int r, int c, float value,
                                          int tag) const {
    if (r == 0) publish_word(mine, span, pl, c, value, tag);
    if (r == tr - 1) publish_word(mine, span, pl, tc + c, value, tag);
    if (c == 0) publish_word(mine, span, pl, 2 * tc + r, value, tag);
    if (c == tc - 1) publish_word(mine, span, pl, 2 * tc + tr + r, value, tag);
  }
};
using TracerEdges = TracerEdgesOf<kFusedPlanes>;

// One SSP-RK2 stage of the positivity-limited dG1 transport on the tile's
// owned elements, for the 3 tracers: dst = lim(cur + dt rhs(cur)) (the
// first stage), or with kBlend lim(0.5 base + 0.5 (cur + dt rhs(cur))) (the
// second, dst = base: each element reads only its own base). dg1_stage_cell
// of dg1_body.cuh on the tile's shared planes (cur with its one-ring apron,
// the velocity nodes with the apron at TR and TC, the face masks likewise),
// with dg1_rk_stage's walls: the first faces of a closed axis and the faces
// beyond its end carry no flux. The edge elements' new coefficients go to
// the exchange at once (`tag`, in the slot of the stage's parity).
template <bool kBlend, bool kMasks, class View>
__device__ __forceinline__ void fused_stage(const FusedArgs& f, const View& t, const OwnedCells& own,
                                            const float* su, const float* sv, const float* fx,
                                            const float* fy, const float* cur, float* base,
                                            float* dst, int plane, float dt_sub,
                                            const TracerEdges& edges, int tag) {
  const int pitch = t.pitch, c = own.c, j = own.j;
  unsigned long long* const mine = edges.slot(static_cast<int>(blockIdx.x), tag & 1);
  own.each([&](int, int r) {
    const int e = t.cell(r, c), i = t.i0 + r;
    Corners corners;
    corners.u00 = su[e];
    corners.u10 = su[e + pitch];
    corners.u01 = su[e + 1];
    corners.u11 = su[e + pitch + 1];
    corners.v00 = sv[e];
    corners.v10 = sv[e + pitch];
    corners.v01 = sv[e + 1];
    corners.v11 = sv[e + pitch + 1];
    const DgVelocity<kFusedDeg> q = sample_velocity(f.tb, corners);
    Dg1Faces faces;
    faces.left_wall = i == 0;
    faces.has_right = i + 1 < t.nx;
    faces.bottom_wall = j == 0;
    faces.has_top = j + 1 < t.ny;
    faces.fx_left = kMasks ? fx[e] : 1.0f;
    faces.fx_right = kMasks ? (faces.has_right ? fx[e + pitch] : 0.0f) : 1.0f;
    faces.fy_bottom = kMasks ? fy[e] : 1.0f;
    faces.fy_top = kMasks ? (faces.has_top ? fy[e + 1] : 0.0f) : 1.0f;
    const Dg1Metric gm = {};
    // One tracer at a time (not unrolled): the three tracers' 45 neighbour
    // coefficients live at once spilled the coastline form at 128 registers.
#pragma unroll 1
    for (int tr = 0; tr < kFusedTracers; ++tr) {
      float p[kFusedDofs], p_l[kFusedDofs], p_r[kFusedDofs], p_b[kFusedDofs], p_t[kFusedDofs],
          p0[kFusedDofs], val[kFusedDofs];
#pragma unroll
      for (int d = 0; d < kFusedDofs; ++d) {
        const float* s = cur + (d * kFusedTracers + tr) * plane + e;
        p[d] = s[0];
        p_l[d] = s[-pitch];
        p_r[d] = s[pitch];
        p_b[d] = s[-1];
        p_t[d] = s[1];
        p0[d] = kBlend ? base[(d * kFusedTracers + tr) * plane + e] : 0.0f;
      }
      dg1_stage_cell<kFusedDeg, false, kBlend, true>(f.tb, q, faces, gm, p, p_l, p_r, p_b, p_t, p0,
                                                     kBlend ? 0.5f : 0.0f, kBlend ? 0.5f : 1.0f,
                                                     dt_sub, val);
#pragma unroll
      for (int d = 0; d < kFusedDofs; ++d) {
        const int pl = d * kFusedTracers + tr;
        dst[pl * plane + e] = val[d];
        if (r == 0) publish_word(mine, edges.span, pl, c, val[d], tag);
        if (r == t.tr - 1) publish_word(mine, edges.span, pl, t.tc + c, val[d], tag);
        if (c == 0) publish_word(mine, edges.span, pl, 2 * t.tc + r, val[d], tag);
        if (c == t.tc - 1) publish_word(mine, edges.span, pl, 2 * t.tc + t.tr + r, val[d], tag);
      }
    }
  });
}

// The neighbours' stage-`tag` edges into the one-ring apron of dst (no
// corners: a face reads its two elements only); cells beyond the domain
// stay zero. One word a thread, each polled until it carries the tag.
template <class View>
__device__ __forceinline__ void fused_take(const View& t, const TracerEdges& edges, float* dst,
                                           int plane, int tag) {
  const int span = edges.span, n_threads = blockDim.x;
  for (int x = threadIdx.x; x < kFusedPlanes * span; x += n_threads) {
    const int p = x / span, k = x - p * span;
    int r, c, n, dir, from;
    if (k < t.tc) {  // row -1: the tile before along i, its last row
      r = -1, c = k, n = 0, dir = -1, from = t.tc + k;
    } else if (k < 2 * t.tc) {  // row TR: the tile after along i, its first row
      r = t.tr, c = k - t.tc, n = 0, dir = 1, from = k - t.tc;
    } else if (k < 2 * t.tc + t.tr) {  // column -1: the tile before along j, its last column
      r = k - 2 * t.tc, c = -1, n = 1, dir = -1, from = 2 * t.tc + t.tr + r;
    } else {  // column TC: the tile after along j, its first column
      r = k - 2 * t.tc - t.tr, c = t.tc, n = 1, dir = 1, from = 2 * t.tc + r;
    }
    if (!t.inside(r, c)) continue;
    dst[p * plane + t.cell(r, c)] =
        take_word(edges.slot(t.neighbour(n, dir), tag & 1), span, p, from, tag);
  }
}

// The launch: one block a tile (mevp_single's tiles, each thread its owned
// cells), shared memory: the 5 state planes, kResident const planes (0 or
// all 7), the two tracer buffers of 9 planes (psi0, the step's base and
// result; psi1, the first stage's), with kMasks the two face masks, each
// plane the tile and its one-cell apron.
template <int kResident, bool kMasks>
__global__ void __launch_bounds__(kFusedMaxThreads, 1)
fused_dynamics_kernel(const __grid_constant__ FusedArgs f) {
  extern __shared__ float smem[];
  __shared__ float red[2 * kFusedMaxThreads / 32 + 2];
  const SingleArgs& a = f.m;
  const TileView<kSinglePlanes, false> t = single_view<false>(a);
  const int plane = (t.tr + 2) * t.pitch, ny = a.ny;
  float* const su = smem;
  float* const sv = su + plane;
  float* const psi0 = smem + (kSinglePlanes + kResident) * plane;
  float* const psi1 = psi0 + kFusedPlanes * plane;
  float* const fx = psi1 + kFusedPlanes * plane;
  float* const fy = fx + plane;
  const long domain = static_cast<long>(a.nx) * ny;

  // 1. The load: the mEVP state and consts, the tracers (psi0) and the
  // masks with their whole apron, zeros beyond the domain and in psi1.
  single_load<false, kResident, false>(a, t, smem, plane);
  {
    const float inv_pitch = 1.0f / static_cast<float>(t.pitch);
    const int n_threads = blockDim.x;
    for (int x = threadIdx.x; x < plane; x += n_threads) {
      const int r = region_row(x, inv_pitch) - 1, c = x - (r + 1) * t.pitch - 1;
      const bool in = t.inside(r, c);
      const long ij = in ? static_cast<long>(t.i0 + r) * ny + (t.j0 + c) : 0;
#pragma unroll
      for (int p = 0; p < kFusedPlanes; ++p) {
        psi0[p * plane + x] = in ? __ldg(f.psi_in + p * domain + ij) : 0.0f;
        psi1[p * plane + x] = 0.0f;
      }
      if constexpr (kMasks) {
        fx[x] = in ? __ldg(f.face_x + ij) : 0.0f;
        fy[x] = in ? __ldg(f.face_y + ij) : 0.0f;
      }
    }
  }
  __syncthreads();
  const OwnedCells own = owned_cells(t);

  // 2. The N subcycles, the last velocity edge taken too (tags 1 .. 2N).
  single_subcycles<false, kResident, 0, false, true>(a, t, own, smem, plane);

  // 3. The CFL speeds of the tile's elements at the dG1 points, as
  // dg1_sample_cfl samples them; the block's pair to the exchange (tag
  // 2N + 1); every block reduces all the pairs, so every block holds the
  // same speeds and k.
  float sx = 0.0f, sy = 0.0f;
  own.each([&](int, int r) {
    const int e = t.cell(r, own.c);
    const float u00 = su[e], u10 = su[e + t.pitch], u01 = su[e + 1], u11 = su[e + t.pitch + 1];
    const float v00 = sv[e], v10 = sv[e + t.pitch], v01 = sv[e + 1], v11 = sv[e + t.pitch + 1];
#pragma unroll
    for (int p = 0; p < DgShape<kFusedDeg>::kVol; ++p) {
      sx = fmaxf(sx, fabsf(bilinear(f.tb.w_vol[p], u00, u10, u01, u11)));
      sy = fmaxf(sy, fabsf(bilinear(f.tb.w_vol[p], v00, v10, v01, v11)));
    }
#pragma unroll
    for (int q = 0; q < DgShape<kFusedDeg>::kEdge; ++q) {
      sx = fmaxf(sx, fabsf(along_face(f.tb.w_edge[q], u00, u01)));
      sy = fmaxf(sy, fabsf(along_face(f.tb.w_edge[q], v00, v10)));
    }
  });
  float2 m = fused_block_max(sx, sy, red);
  int tag = 2 * a.n_sub + 1;
  const int tiles = static_cast<int>(gridDim.x);
  if (threadIdx.x == 0) {
    publish_word(f.partials, 0, 0, 2 * blockIdx.x, m.x, tag);
    publish_word(f.partials, 0, 0, 2 * blockIdx.x + 1, m.y, tag);
  }
  sx = sy = 0.0f;
  const int n_threads = blockDim.x;
  for (int x = threadIdx.x; x < 2 * tiles; x += n_threads) {
    const float value = take_word(f.partials, 0, 0, x, tag);
    if (x & 1) {
      sy = fmaxf(sy, value);
    } else {
      sx = fmaxf(sx, value);
    }
  }
  m = fused_block_max(sx, sy, red);
  const int k = fused_substeps(m.x, m.y, f);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    f.info[0] = m.x;
    f.info[1] = m.y;
    f.info[2] = static_cast<float>(k);
  }

  // 4. k SSP-RK2 substeps at dt / k (tags 2N + 2 ...), the tracers' edges
  // passed after each stage but the last.
  const float dt_sub = static_cast<float>(f.dt / k);
  const TracerEdges edges = {f.tracer_words, t.tr, t.tc, 2 * (t.tr + t.tc)};
  for (int step = 0; step < k; ++step) {
    ++tag;
    fused_stage<false, kMasks>(f, t, own, su, sv, fx, fy, psi0, nullptr, psi1, plane, dt_sub, edges,
                               tag);
    fused_take(t, edges, psi1, plane, tag);
    __syncthreads();
    ++tag;
    fused_stage<true, kMasks>(f, t, own, su, sv, fx, fy, psi1, psi0, psi0, plane, dt_sub, edges, tag);
    if (step + 1 == k) break;
    fused_take(t, edges, psi0, plane, tag);
    __syncthreads();
  }

  // 5. The output: each thread its own cells.
  single_store(a, t, own, smem, plane);
  own.each([&](int, int r) {
    const int e = t.cell(r, own.c);
    const long ij = static_cast<long>(t.i0 + r) * ny + own.j;
#pragma unroll
    for (int p = 0; p < kFusedPlanes; ++p) f.psi_out[p * domain + ij] = psi0[p * plane + e];
  });
}

// The kernel of a form: the 7 consts resident or none, with or without the
// face masks (fused_dynamics_masked.cu); null for another count.
template <bool kMasks>
const void* fused_kernel_of(int n_resident) {
  switch (n_resident) {
    case 0: return reinterpret_cast<const void*>(&fused_dynamics_kernel<0, kMasks>);
    case kFusedConsts: return reinterpret_cast<const void*>(&fused_dynamics_kernel<kFusedConsts, kMasks>);
    default: return nullptr;
  }
}

// The coastline form's kernels (fused_dynamics_masked.cu).
const void* fused_kernel_masked(int n_resident);

// -- The other forms --------------------------------------------------------------
// The headline's instances above keep their code; the other forms' kernel
// runs the same steps on these generalizations of its pieces: any degree,
// each axis closed or periodic (t.wrap), the face masks always read (ones
// without a coastline), the TVB form's stage unlimited.

// One SSP-RK stage of the dG transport at degree kDeg on the tile's owned
// elements, for the 3 tracers: dst = lim(sa base + sb (cur + dt rhs(cur))),
// or lim(cur + dt rhs(cur)) where sa is 0 (base not read; else dst may be
// base: each element reads only its own base). dg1_stage_cell of
// dg1_body.cuh on the tile's shared planes, as fused_stage, with the walls
// of the closed axes only (a periodic axis has none). lim: the positivity
// limiter (kLimit), or none (the TVB form's stage, which form_limit
// limits). The edge elements' new coefficients go to the exchange at once
// (`tag`): every plane, or without kLimit the means alone.
template <int kDeg, bool kLimit, class View>
__device__ __forceinline__ void form_stage(const FusedFormArgs<kDeg>& f, const View& t,
                                           const OwnedCells& own, const float* su, const float* sv,
                                           const float* fx, const float* fy, const float* cur,
                                           const float* base, float* dst, int plane, float sa, float sb,
                                           float dt_sub, const TracerEdgesOf<FusedShape<kDeg>::kPlanes>& edges,
                                           int tag) {
  constexpr int kDofs = DgShape<kDeg>::kDofs;
  const int pitch = t.pitch, c = own.c, j = own.j;
  const bool wx = (t.wrap & kWrapX) != 0, wy = (t.wrap & kWrapY) != 0;
  unsigned long long* const mine = edges.slot(static_cast<int>(blockIdx.x), tag & 1);
  own.each([&](int, int r) {
    const int e = t.cell(r, c), i = t.i0 + r;
    Corners corners;
    corners.u00 = su[e];
    corners.u10 = su[e + pitch];
    corners.u01 = su[e + 1];
    corners.u11 = su[e + pitch + 1];
    corners.v00 = sv[e];
    corners.v10 = sv[e + pitch];
    corners.v01 = sv[e + 1];
    corners.v11 = sv[e + pitch + 1];
    const DgVelocity<kDeg> q = sample_velocity(f.tb, corners);
    Dg1Faces faces;
    faces.left_wall = !wx && i == 0;
    faces.has_right = wx || i + 1 < t.nx;
    faces.bottom_wall = !wy && j == 0;
    faces.has_top = wy || j + 1 < t.ny;
    faces.fx_left = fx[e];
    faces.fx_right = faces.has_right ? fx[e + pitch] : 0.0f;
    faces.fy_bottom = fy[e];
    faces.fy_top = faces.has_top ? fy[e + 1] : 0.0f;
    const Dg1Metric gm = {};
#pragma unroll 1
    for (int tr = 0; tr < kFusedTracers; ++tr) {
      float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs], p0[kDofs], val[kDofs];
#pragma unroll
      for (int d = 0; d < kDofs; ++d) {
        const float* s = cur + (d * kFusedTracers + tr) * plane + e;
        p[d] = s[0];
        p_l[d] = s[-pitch];
        p_r[d] = s[pitch];
        p_b[d] = s[-1];
        p_t[d] = s[1];
        p0[d] = sa != 0.0f ? base[(d * kFusedTracers + tr) * plane + e] : 0.0f;
      }
      dg1_stage_cell<kDeg, false, true, kLimit>(f.tb, q, faces, gm, p, p_l, p_r, p_b, p_t, p0, sa, sb,
                                                dt_sub, val);
#pragma unroll
      for (int d = 0; d < kDofs; ++d) {
        const int pl = d * kFusedTracers + tr;
        dst[pl * plane + e] = val[d];
        if (kLimit || d == 0) edges.publish(mine, pl, r, c, val[d], tag);
      }
    }
  });
}

// The TVB form's limiter on the tile's owned elements, in place on buf
// after its stage: dg_tvb_limit of dg1_body.cuh (the minmod slope limiter
// against the neighbours' means, then positivity), as dg1_limit and
// transport_tiled's TVB form run it; a closed axis's first and last
// elements take zero-gradient ghosts, a periodic axis (t.wrap) none. The
// neighbours' means are the stage's (the limiters never change a mean), in
// the apron where they lie beyond the tile. The limited higher
// coefficients of the edge elements go to the exchange at once (`tag`).
template <int kDeg, class View>
__device__ __forceinline__ void form_limit(const FusedFormArgs<kDeg>& f, const View& t,
                                           const OwnedCells& own, float* buf, int plane,
                                           const TracerEdgesOf<FusedShape<kDeg>::kPlanes>& edges,
                                           int tag) {
  constexpr int kDofs = DgShape<kDeg>::kDofs;
  const int pitch = t.pitch, c = own.c, j = own.j;
  const bool wx = (t.wrap & kWrapX) != 0, wy = (t.wrap & kWrapY) != 0;
  unsigned long long* const mine = edges.slot(static_cast<int>(blockIdx.x), tag & 1);
  own.each([&](int, int r) {
    const int e = t.cell(r, c), i = t.i0 + r;
    TvbNeighbours n;
    n.wall_l = !wx && i == 0;
    n.wall_r = !wx && i == t.nx - 1;
    n.wall_b = !wy && j == 0;
    n.wall_t = !wy && j == t.ny - 1;
    n.tol_x = f.tol_x;
    n.tol_y = f.tol_y;
#pragma unroll 1
    for (int tr = 0; tr < kFusedTracers; ++tr) {
      const float* mean = buf + tr * plane + e;  // coefficient 0 of tracer tr
      n.m_l = mean[-pitch];
      n.m_r = mean[pitch];
      n.m_b = mean[-1];
      n.m_t = mean[1];
      float val[kDofs], out[kDofs];
#pragma unroll
      for (int d = 0; d < kDofs; ++d) val[d] = buf[(d * kFusedTracers + tr) * plane + e];
      dg_tvb_limit<kDeg>(f.tb, val, n, out);
#pragma unroll
      for (int d = 1; d < kDofs; ++d) {
        const int pl = d * kFusedTracers + tr;
        buf[pl * plane + e] = out[d];
        edges.publish(mine, pl, r, c, out[d], tag);
      }
    }
  });
}

// fused_take for planes [kP0, kP1) of kPlanes (the TVB form takes the
// means, then the higher coefficients), on a ring where t.wrap says so.
template <int kP0, int kP1, int kPlanes, class View>
__device__ __forceinline__ void form_take(const View& t, const TracerEdgesOf<kPlanes>& edges, float* dst,
                                          int plane, int tag) {
  const int span = edges.span, n_threads = blockDim.x;
  for (int x = threadIdx.x; x < (kP1 - kP0) * span; x += n_threads) {
    const int p = kP0 + x / span, k = x - (p - kP0) * span;
    int r, c, n, dir, from;
    if (k < t.tc) {  // row -1: the tile before along i, its last row
      r = -1, c = k, n = 0, dir = -1, from = t.tc + k;
    } else if (k < 2 * t.tc) {  // row TR: the tile after along i, its first row
      r = t.tr, c = k - t.tc, n = 0, dir = 1, from = k - t.tc;
    } else if (k < 2 * t.tc + t.tr) {  // column -1: the tile before along j, its last column
      r = k - 2 * t.tc, c = -1, n = 1, dir = -1, from = 2 * t.tc + t.tr + r;
    } else {  // column TC: the tile after along j, its first column
      r = k - 2 * t.tc - t.tr, c = t.tc, n = 1, dir = 1, from = 2 * t.tc + r;
    }
    if (!t.inside(r, c)) continue;
    dst[p * plane + t.cell(r, c)] =
        take_word(edges.slot(t.neighbour(n, dir), tag & 1), span, p, from, tag);
  }
}

// Every other form of a uniform mesh: kDeg (dG0, dG1, dG2), kTvb (the TVB
// limiter, dG1 and dG2), kForm (kFormMevp, | kFormAdaptive: beta in
// registers), kResident (0 or all kFormConsts const planes; dG2 only all);
// at run time the periodic axes (f.m.wrap: the tiles a ring, no wall
// faces), the A-weighted stresses (f.m.k.a_node: the node concentrations,
// else ones), the coastline (f.face_x, f.face_y: its face masks, else ones:
// a flux times 1 is the flux) and the scheme (f.n_stages, f.a, f.b). The
// headline kernel's steps; shared memory: the 5 state planes, kResident
// const planes, 2 tracer buffers of 3K planes (3 for rk3: psi0, the
// substep's base and result; psi1, the first stage's; psi2, rk3's second
// stage's) and the two face masks. A stage sends its edges as the
// headline's do; with kTvb the stage, unlimited, sends its edge elements'
// means, every block takes its neighbours' and limits its own elements
// (form_limit), then sends the limited higher coefficients: two tagged
// exchanges a stage, the tags still rising through the launch.
template <int kDeg, bool kTvb, int kForm, int kResident>
__global__ void __launch_bounds__(FusedShape<kDeg>::kMaxThreads, 1)
fused_dynamics_forms_kernel(const __grid_constant__ FusedFormArgs<kDeg> f) {
  static_assert(!kTvb || kDeg > 0, "dG0 has no slopes to limit");
  constexpr int kPlanes = FusedShape<kDeg>::kPlanes;
  extern __shared__ float smem[];
  __shared__ float red[2 * kFusedMaxThreads / 32 + 2];
  const SingleArgs& a = f.m;
  const TileView<kSinglePlanes, true> t = single_view<true>(a);
  const int plane = (t.tr + 2) * t.pitch, ny = a.ny, n_stages = f.n_stages;
  const int n_buffers = n_stages == kMaxStages ? 3 : 2;
  float* const su = smem;
  float* const sv = su + plane;
  float* const psi0 = smem + (kSinglePlanes + kResident) * plane;
  float* const psi1 = psi0 + kPlanes * plane;
  float* const psi2 = psi1 + kPlanes * plane;
  float* const fx = psi0 + n_buffers * kPlanes * plane;
  float* const fy = fx + plane;
  const long domain = static_cast<long>(a.nx) * ny;

  // 1. The load, as the headline's, each cell at its wrapped index; zeros
  // in the stages' buffers.
  single_load<false, kResident, true>(a, t, smem, plane);
  {
    const float inv_pitch = 1.0f / static_cast<float>(t.pitch);
    const int n_threads = blockDim.x;
    for (int x = threadIdx.x; x < plane; x += n_threads) {
      const int r = region_row(x, inv_pitch) - 1, c = x - (r + 1) * t.pitch - 1;
      const bool in = t.inside(r, c);
      const long ij = in ? static_cast<long>(t.index(r, c)) : 0;
#pragma unroll
      for (int p = 0; p < kPlanes; ++p) {
        psi0[p * plane + x] = in ? __ldg(f.psi_in + p * domain + ij) : 0.0f;
        for (int b = 1; b < n_buffers; ++b) psi0[(b * kPlanes + p) * plane + x] = 0.0f;
      }
      fx[x] = in ? __ldg(f.face_x + ij) : 0.0f;
      fy[x] = in ? __ldg(f.face_y + ij) : 0.0f;
    }
  }
  __syncthreads();
  const OwnedCells own = owned_cells(t);

  // 2. The N subcycles (tags 1 .. 2N).
  single_subcycles<false, kResident, kForm, true, true>(a, t, own, smem, plane);

  // 3. The CFL speeds at the degree's points and k (tag 2N + 1), as the
  // headline's.
  float sx = 0.0f, sy = 0.0f;
  own.each([&](int, int r) {
    const int e = t.cell(r, own.c);
    const float u00 = su[e], u10 = su[e + t.pitch], u01 = su[e + 1], u11 = su[e + t.pitch + 1];
    const float v00 = sv[e], v10 = sv[e + t.pitch], v01 = sv[e + 1], v11 = sv[e + t.pitch + 1];
#pragma unroll
    for (int p = 0; p < DgShape<kDeg>::kVol; ++p) {
      sx = fmaxf(sx, fabsf(bilinear(f.tb.w_vol[p], u00, u10, u01, u11)));
      sy = fmaxf(sy, fabsf(bilinear(f.tb.w_vol[p], v00, v10, v01, v11)));
    }
#pragma unroll
    for (int q = 0; q < DgShape<kDeg>::kEdge; ++q) {
      sx = fmaxf(sx, fabsf(along_face(f.tb.w_edge[q], u00, u01)));
      sy = fmaxf(sy, fabsf(along_face(f.tb.w_edge[q], v00, v10)));
    }
  });
  float2 m = fused_block_max(sx, sy, red);
  int tag = 2 * a.n_sub + 1;
  const int tiles = static_cast<int>(gridDim.x);
  if (threadIdx.x == 0) {
    publish_word(f.partials, 0, 0, 2 * blockIdx.x, m.x, tag);
    publish_word(f.partials, 0, 0, 2 * blockIdx.x + 1, m.y, tag);
  }
  sx = sy = 0.0f;
  const int n_threads = blockDim.x;
  for (int x = threadIdx.x; x < 2 * tiles; x += n_threads) {
    const float value = take_word(f.partials, 0, 0, x, tag);
    if (x & 1) {
      sy = fmaxf(sy, value);
    } else {
      sx = fmaxf(sx, value);
    }
  }
  m = fused_block_max(sx, sy, red);
  const int k = fused_substeps(m.x, m.y, f);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    f.info[0] = m.x;
    f.info[1] = m.y;
    f.info[2] = static_cast<float>(k);
  }

  // 4. k substeps of n_stages stages: stage 0 from cur into psi1, a middle
  // stage from psi1 into psi2, the last (rk2, rk3) blended into cur in
  // place; rk1's one stage writes psi1, which becomes the next substep's
  // cur. Named pointers and constant indices: an array indexed by the stage
  // would live in local memory.
  const float dt_sub = static_cast<float>(f.dt / k);
  const TracerEdgesOf<kPlanes> edges = {f.tracer_words, t.tr, t.tc, 2 * (t.tr + t.tc)};
  float* cur = psi0;
  float* first = psi1;
  for (int step = 0; step < k; ++step) {
    for (int s = 0; s < n_stages; ++s) {
      const float* src = s == 0 ? cur : (s == 1 ? first : psi2);
      float* dst = s == 0 ? first : (s + 1 == n_stages ? cur : psi2);
      const float sa = s == 0 ? f.a[0] : (s == 1 ? f.a[1] : f.a[2]);
      const float sb = s == 0 ? f.b[0] : (s == 1 ? f.b[1] : f.b[2]);
      const bool last = step + 1 == k && s + 1 == n_stages;
      ++tag;
      form_stage<kDeg, !kTvb>(f, t, own, su, sv, fx, fy, src, cur, dst, plane, sa, sb, dt_sub, edges, tag);
      if constexpr (kTvb) {
        form_take<0, kFusedTracers>(t, edges, dst, plane, tag);  // the means
        __syncthreads();
        ++tag;
        form_limit<kDeg>(f, t, own, dst, plane, edges, tag);
        if (!last) form_take<kFusedTracers, kPlanes>(t, edges, dst, plane, tag);
      } else if (!last) {
        form_take<0, kPlanes>(t, edges, dst, plane, tag);
      }
      if (!last) __syncthreads();
    }
    if (n_stages == 1) {
      float* const swap = cur;
      cur = first;
      first = swap;
    }
  }

  // 5. The output: each thread its own cells.
  single_store(a, t, own, smem, plane);
  own.each([&](int, int r) {
    const int e = t.cell(r, own.c);
    const long ij = static_cast<long>(t.i0 + r) * ny + own.j;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) f.psi_out[p * domain + ij] = cur[p * plane + e];
  });
}

// The other forms' kernel at a degree and TVB form: adaptive alpha or not,
// the consts resident (kFormConsts) or none (not at dG2, whose tiles keep
// them resident); null for another count.
template <int kDeg, bool kTvb>
const void* fused_forms_kernel_of(bool adaptive, int n_resident) {
  constexpr int kA = kFormMevp | kFormAdaptive;
  if (n_resident == kFormConsts) {
    return adaptive ? reinterpret_cast<const void*>(&fused_dynamics_forms_kernel<kDeg, kTvb, kA, kFormConsts>)
                    : reinterpret_cast<const void*>(&fused_dynamics_forms_kernel<kDeg, kTvb, kFormMevp, kFormConsts>);
  }
  if constexpr (kDeg != 2) {
    if (n_resident == 0) {
      return adaptive ? reinterpret_cast<const void*>(&fused_dynamics_forms_kernel<kDeg, kTvb, kA, 0>)
                      : reinterpret_cast<const void*>(&fused_dynamics_forms_kernel<kDeg, kTvb, kFormMevp, 0>);
    }
  }
  return nullptr;
}

// The other forms' instances, a source each (fused_dynamics_dg0.cu,
// fused_dynamics_dg1.cu, fused_dynamics_dg1_tvb.cu, fused_dynamics_dg2.cu,
// fused_dynamics_dg2_tvb.cu), compiled in parallel.
const void* fused_forms_dg0(bool adaptive, int n_resident);
const void* fused_forms_dg1(bool adaptive, int n_resident);
const void* fused_forms_dg1_tvb(bool adaptive, int n_resident);
const void* fused_forms_dg2(bool adaptive, int n_resident);
const void* fused_forms_dg2_tvb(bool adaptive, int n_resident);

}  // namespace nst
