// DG tracer transport on Hopper (dG0, dG1, dG2): CFL speeds and one SSP-RK
// stage.
//
// Replaces the transport part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas
// (velocity_from_cg, cfl_substeps and k limited DGTransport.step calls on
// the stacked (K, T, nx, ny) tracers, all resident on one core, at any DG
// degree), and runs DGTransport.run's unlimited steps (BASELINE config 2):
//
//   dg1_sample_cfl (elements): samples the CG1 velocity at the degree's
//                  volume points (2x2, or 3x3 at dG2) and the 2 (3) points
//                  of the element's left and bottom faces and reduces
//                  max |vx| and max |vy| over the elements.
//                  It streams: at most as many blocks as are resident walk
//                  the rows, each warp a strip of 128 columns (32 with
//                  4-byte loads) down a chunk of rows (1 to 32, sized so
//                  that the chunks fill the resident warps); a lane loads 4 consecutive
//                  nodes of a row in one 16-byte load where the rows allow
//                  it (chosen on the host by alignment), takes the node
//                  after them from the next lane by a shuffle, keeps the
//                  row below from one row to the next in registers and has
//                  the next row's loads in flight while it computes, so
//                  each node is read about once. The max is taken in
//                  registers, then over the warp and the block; each block
//                  writes its pair to a scratch slot and the last block to
//                  finish (a counter that it resets) reduces the pairs into
//                  the two speeds: no atomic on the speeds, nothing to zero
//                  before the launch. A max is exact in any order, so the
//                  host turns the speeds into k with the same torch
//                  operations as the plain cfl_substeps and equal speeds
//                  give an equal k. It samples the first ex x ey elements
//                  of node planes of nx x ny nodes with a row stride ld: on
//                  a rank block, the block's own elements inside its
//                  velocity widened by the halo exchange, so that the nodes
//                  beyond the block are its neighbours' and not zeros.
//   dg1_rk_stage   (elements): out = lim(a*base + b*(psi + dt*rhs(psi))), or
//                  lim(psi + dt*rhs(psi)) when a == 0, for the 3 tracers x K
//                  dofs, one launch per RK stage (the TPU kernel's k loop,
//                  coupled_pallas.py:113-128). The velocity is sampled from
//                  the CG1 nodes u and v, or (the qv form: the HO path and
//                  the advection run) read from the 12 (dG2: 24) quadrature
//                  planes of a QuadVelocity. It zeroes the global x = 0 and
//                  y = 0 wall faces, multiplies the fluxes by the face_x and
//                  face_y planes (all ones without a coastline), on a graded
//                  or spherical mesh reads the transport's 5 metric planes,
//                  and applies the degree's positivity limiter. Its no-limit
//                  instance (DGTransport.run, whose steps do not limit)
//                  advects one tracer in the qv form and reads no face
//                  masks (every face but the walls open). It reads its
//                  neighbours' psi, so `out` must not alias `psi` (it may
//                  alias `base`).
//
// The tables, the velocity sampling and the per-face and per-element stage
// math live in dg1_body.cuh, shared with the tiled schedule of
// transport_tiled.cu; the dg1_rk_stage kernel template lives in
// dg1_stage.cuh, instantiated here (the closed instances), in
// transport_tvb.cu (the TVB form's unlimited 3-tracer instances, with
// dg1_limit) and in transport_periodic.cu (the periodic instances). On a
// periodic axis (the periodic instances, a template argument kWrap, on the
// launch's `wrap` axes) both kernels' loads wrap: node nx is node 0, a
// window cell beyond the domain is copied from its wrapped cell, and no
// face is a wall.
//
// What bounds dg1_sample_cfl on the H100: the 8 bytes of u and v per node,
// read once (64 MiB each at 4096^2, ~40 us at the data sheet's 3.35 TB/s);
// at 256^2 the launch itself. Its first form ran one element a thread with
// 8 scalar loads and two atomicMax per block of 256 threads on the same two
// words (131,072 of them at 4096^2), after a memset (PERF.md).
//
// What bounds dg1_rk_stage on the H100: its bytes would take 0.0024 ms at
// 256^2 on the data sheet (31 planes an element blended, 22 without the
// base, 41 in the qv form), but the first form ran at 40% of that. It ran
// one element a thread in 32 x 8 blocks, 16 resident warps an SM at 256^2,
// each thread walking the tracers with 15 dependent neighbour loads a
// tracer; every coefficient was fetched 5 times and every interior face's
// flux computed twice, once by each side: a latency- and issue-bound
// kernel. This design: a tile of 4 x 32 elements a block of 384 threads,
// one thread an element and tracer, four blocks an SM (48 warps at 256^2,
// under a 40-register bound; at dG2, whose thread holds 6 coefficients, 9
// volume points and a 21-point limiter, two blocks an SM under an
// 85-register bound). The threads first copy the tile's windows
// into shared memory by 16-byte cp.async (4-byte where a plane or its rows
// are not 16-byte aligned), each window once and every thread a share of
// each: the coefficients with a one-cell apron, then the CG1 nodes or the
// qv planes, the face masks and the metric planes, all one shape so that
// one flat loop takes them; meanwhile each thread loads its own base (only
// in the blended instantiation). Then each face's flux is computed once,
// by the element above or right of it (the tile's far faces by its last
// row and first row's lanes), into shared memory, where its two elements
// read it: with --fmad=false both sides would run the same operations on
// the same values, so sharing changes no bit. In the CG1 form the
// element's 8 volume velocities are sampled once, split over its 3 tracer
// threads. After a barrier each thread updates its element. The blend, the
// velocity source, the metric, the degree, the limiter and the tracers a
// block (3, or 1 for the run's one tracer) are template arguments. The tile
// lives in dynamic shared memory (at dG2 in the qv form with the metric
// it exceeds the 48 KB of a static one). No tensor cores
// (an FP32 stencil) and no TMA tensor copies (they faulted with an illegal
// instruction under driver 580.159.03, CUDA 13.0: PERF.md).
#include <cuda/atomic>

#include <algorithm>
#include <atomic>
#include <cstring>

#include "async_copy.cuh"
#include "dg1_body.cuh"
#include "dg1_stage.cuh"

namespace nst {

constexpr int kCflThreads = 256;
constexpr int kCflMaxRows = 32;  // rows a warp walks down a strip, at most, before it takes the next

// The max of (x, y) over the block, in thread 0. `wx`, `wy`: shared, one
// slot a warp.
__device__ __forceinline__ float2 block_max(float x, float y, float* wx, float* wy) {
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    x = fmaxf(x, __shfl_down_sync(0xffffffffu, x, offset));
    y = fmaxf(y, __shfl_down_sync(0xffffffffu, y, offset));
  }
  if ((threadIdx.x & 31) == 0) {
    wx[threadIdx.x >> 5] = x;
    wy[threadIdx.x >> 5] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kCflThreads / 32; ++w) {
      x = fmaxf(x, wx[w]);
      y = fmaxf(y, wy[w]);
    }
  }
  return make_float2(x, y);
}

// Nodes (a, b), ..., (a, b + kPer) of f, 0 beyond the nx x ny nodes, in
// two steps so that a row's loads are in flight while the row before is
// computed: load_nodes issues the lane's own kPer (one 16-byte load for
// kPer = 4) and, in the last lane, the node after them; finish_nodes takes
// the node after them from the next lane. Every lane of the warp calls both.
template <int kPer, bool kWrap>
__device__ __forceinline__ void load_nodes(const float* f, int a, int b, int nx, int ny, int ld,
                                           float (&x)[kPer + 1], int wrap) {
  if (kWrap && (wrap & kWrapX) && a >= nx) a -= nx;  // node row nx is row 0
  const bool row = a < nx;
  const float* p = f + static_cast<long>(a) * ld + b;
  if (kPer == 4) {
    const float4 w = row && b < ny ? *reinterpret_cast<const float4*>(p)
                                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    x[0] = w.x;
    x[1] = b + 1 < ny ? w.y : 0.0f;
    x[2] = b + 2 < ny ? w.z : 0.0f;
    x[3] = b + 3 < ny ? w.w : 0.0f;
  } else {
    x[0] = row && b < ny ? *p : 0.0f;
  }
  x[kPer] = (threadIdx.x & 31) == 31 && row && b + kPer < ny ? p[kPer] : 0.0f;
  // Node column ny is column 0 on a periodic y axis: the lane whose nodes
  // end the row loads it (after finish_nodes, which would take a zero).
  if (kWrap && (wrap & kWrapY) && row && b < ny && b + kPer >= ny) x[kPer] = f[static_cast<long>(a) * ld];
}

template <int kPer, bool kWrap>
__device__ __forceinline__ void finish_nodes(float (&x)[kPer + 1], int b, int ny, int wrap) {
  const float next = __shfl_down_sync(0xffffffffu, x[0], 1);
  if ((threadIdx.x & 31) != 31 && !(kWrap && (wrap & kWrapY) && b < ny && b + kPer >= ny)) {
    x[kPer] = next;
  }
}

// kPer consecutive elements a lane: 4 by 16-byte loads (u and v 16-byte
// aligned, ld a multiple of 4, and every 16-byte load of the last node
// column inside the row; the host checks), else 1 by 4-byte loads. A warp
// takes item after item: `rows` rows (the host sizes them so that the items
// fill the resident warps) of a strip of 32 kPer columns.
// scratch: [0] the count of blocks done (0 between launches), then a
// (max |vx|, max |vy|) pair per block.
// kVol, kEdge: the degree's volume and face points (SamplePoints).
// kWrap: the periodic form (node nx is node 0 on the axes of `wrap`);
// without it `wrap` is not read and the code is the closed domain's.
template <int kPer, int kVol, int kEdge, bool kWrap>
__global__ void __launch_bounds__(kCflThreads)
dg1_sample_cfl_kernel(const float* __restrict__ u, const float* __restrict__ v, int ex, int ey,
                      int nx, int ny, int ld, int rows, SamplePoints<kVol, kEdge> tb,
                      float* __restrict__ speeds, unsigned int* __restrict__ scratch, int wrap) {
  constexpr int kStrip = 32 * kPer;
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * kCflThreads + threadIdx.x) >> 5;
  const int n_warps = gridDim.x * (kCflThreads / 32);
  const int strips = (ey + kStrip - 1) / kStrip;
  const int items = strips * ((ex + rows - 1) / rows);
  float sx = 0.0f, sy = 0.0f;
  for (int item = warp; item < items; item += n_warps) {
    // Consecutive warps take consecutive strips of the same rows.
    const int chunk = item / strips, i0 = chunk * rows, i1 = min(i0 + rows, ex);
    const int j = (item - chunk * strips) * kStrip + lane * kPer;
    float u_top[kPer + 1], v_top[kPer + 1], u_bot[kPer + 1], v_bot[kPer + 1];
    load_nodes<kPer, kWrap>(u, i0, j, nx, ny, ld, u_top, wrap);
    load_nodes<kPer, kWrap>(v, i0, j, nx, ny, ld, v_top, wrap);
    load_nodes<kPer, kWrap>(u, i0 + 1, j, nx, ny, ld, u_bot, wrap);
    load_nodes<kPer, kWrap>(v, i0 + 1, j, nx, ny, ld, v_bot, wrap);
    finish_nodes<kPer, kWrap>(u_top, j, ny, wrap);
    finish_nodes<kPer, kWrap>(v_top, j, ny, wrap);
    finish_nodes<kPer, kWrap>(u_bot, j, ny, wrap);
    finish_nodes<kPer, kWrap>(v_bot, j, ny, wrap);
    for (int i = i0; i < i1; ++i) {
      // The next row's loads go out before this row's maxima.
      float u_next[kPer + 1] = {}, v_next[kPer + 1] = {};
      const bool more = i + 1 < i1;
      if (more) {
        load_nodes<kPer, kWrap>(u, i + 2, j, nx, ny, ld, u_next, wrap);
        load_nodes<kPer, kWrap>(v, i + 2, j, nx, ny, ld, v_next, wrap);
      }
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        if (j + q < ey) {
#pragma unroll
          for (int p = 0; p < kVol; ++p) {
            sx = fmaxf(sx, fabsf(bilinear(tb.w_vol[p], u_top[q], u_bot[q], u_top[q + 1], u_bot[q + 1])));
            sy = fmaxf(sy, fabsf(bilinear(tb.w_vol[p], v_top[q], v_bot[q], v_top[q + 1], v_bot[q + 1])));
          }
#pragma unroll
          for (int e = 0; e < kEdge; ++e) {
            sx = fmaxf(sx, fabsf(along_face(tb.w_edge[e], u_top[q], u_top[q + 1])));
            sy = fmaxf(sy, fabsf(along_face(tb.w_edge[e], v_top[q], v_bot[q])));
          }
        }
      }
      if (more) {
        finish_nodes<kPer, kWrap>(u_next, j, ny, wrap);
        finish_nodes<kPer, kWrap>(v_next, j, ny, wrap);
      }
#pragma unroll
      for (int q = 0; q <= kPer; ++q) {
        u_top[q] = u_bot[q];
        v_top[q] = v_bot[q];
        u_bot[q] = u_next[q];
        v_bot[q] = v_next[q];
      }
    }
  }

  // The block's pair into its slot; the last block to count reduces them.
  __shared__ float wx[kCflThreads / 32], wy[kCflThreads / 32];
  __shared__ bool last;
  float2 m = block_max(sx, sy, wx, wy);
  float* pairs = reinterpret_cast<float*>(scratch + 1);
  if (threadIdx.x == 0) {
    pairs[2 * blockIdx.x] = m.x;
    pairs[2 * blockIdx.x + 1] = m.y;
    // Release: the pair is visible before the count says so.
    cuda::atomic_ref<unsigned int, cuda::thread_scope_device> count(scratch[0]);
    last = count.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  sx = sy = 0.0f;
  for (int b = threadIdx.x; b < gridDim.x; b += kCflThreads) {
    sx = fmaxf(sx, __ldcg(pairs + 2 * b));
    sy = fmaxf(sy, __ldcg(pairs + 2 * b + 1));
  }
  m = block_max(sx, sy, wx, wy);
  if (threadIdx.x == 0) {
    speeds[0] = m.x;
    speeds[1] = m.y;
    scratch[0] = 0;  // for the next launch on this scratch
  }
}

// Blocks of dg1_sample_cfl_kernel<kPer, kVol, kEdge> resident at once on
// `device`, worked out once per device and form.
template <int kPer, int kVol, int kEdge>
int cfl_resident_blocks(int device) {
  static std::atomic<int> known[64];
  if (device < 0 || device >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  int blocks = known[device].load(std::memory_order_relaxed);
  if (blocks > 0) return blocks;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dg1_sample_cfl_kernel<kPer, kVol, kEdge, false>, kCflThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  known[device].store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

// The instance of the launch's form: with the limiter, the coupled step's 3
// tracers in every form; without it, the advection run's one tracer in the
// qv form, without face masks, or (kStageUnlimited, dG1 and dG2) the
// coupled step's 3 tracers in every form, which dg1_limit then limits.
template <int kDeg>
cudaError_t run_stage(const StageArgs<kDeg>& g, bool metric, bool qv, bool blend, int mode,
                      cudaStream_t s) {
  if (g.wrap) return run_stage_periodic<kDeg>(g, metric, qv, blend, mode, s);
  if (mode == kStageUnlimited) {
    if constexpr (kDeg == 0) {
      return cudaErrorInvalidValue;  // dG0 has no slopes: its stage limits in place
    } else {
      return run_stage_unlimited<kDeg>(g, metric, qv, blend, s);
    }
  }
  if (mode == kStageRun) {
    if (metric) {
      return blend ? launch_stage<kDeg, 1, true, true, true, false>(g, s)
                   : launch_stage<kDeg, 1, true, true, false, false>(g, s);
    }
    return blend ? launch_stage<kDeg, 1, false, true, true, false>(g, s)
                 : launch_stage<kDeg, 1, false, true, false, false>(g, s);
  }
  constexpr int T = kStageTracers;
  if (metric) {
    if (qv) {
      return blend ? launch_stage<kDeg, T, true, true, true, true>(g, s)
                   : launch_stage<kDeg, T, true, true, false, true>(g, s);
    }
    return blend ? launch_stage<kDeg, T, true, false, true, true>(g, s)
                 : launch_stage<kDeg, T, true, false, false, true>(g, s);
  }
  if (qv) {
    return blend ? launch_stage<kDeg, T, false, true, true, true>(g, s)
                 : launch_stage<kDeg, T, false, true, false, true>(g, s);
  }
  return blend ? launch_stage<kDeg, T, false, false, true, true>(g, s)
               : launch_stage<kDeg, T, false, false, false, true>(g, s);
}

// The launch's arguments at degree kDeg (see nst_dg1_rk_stage), then the
// launch.
template <int kDeg>
int stage_call(const float* psi, const float* base, const float* u, const float* v,
               const float* face_x, const float* face_y, const void* const* metric,
               const void* const* qv, float* out, int nx, int ny, int mode, int wrap, float a,
               float b, float dt, const float* tables, cudaStream_t stream) {
  const StageArgs<kDeg> g = stage_args<kDeg>(psi, base, u, v, face_x, face_y, metric, qv, out, nx,
                                             ny, mode, wrap, a, b, dt, tables);
  return static_cast<int>(
      run_stage<kDeg>(g, metric != nullptr, qv != nullptr, a != 0.0f, mode, stream));
}

// dg1_sample_cfl at the volume and face points of one degree.
template <int kVol, int kEdge>
int sample_call(const float* u, const float* v, float* speeds, unsigned int* scratch,
                int scratch_blocks, int ex, int ey, int nx, int ny, int ld, int vector,
                int wrap, const float* tables, int device, cudaStream_t stream) {
  SamplePoints<kVol, kEdge> tb;
  std::memcpy(&tb, tables, sizeof(tb));
  const int resident = vector ? cfl_resident_blocks<4, kVol, kEdge>(device)
                              : cfl_resident_blocks<1, kVol, kEdge>(device);
  if (resident < 0) return -resident;
  // Rows an item: enough items for every resident warp, at most 32 rows.
  const long strips = (ey + 32L * (vector ? 4 : 1) - 1) / (32L * (vector ? 4 : 1));
  const long warps = static_cast<long>(std::min(resident, scratch_blocks)) * (kCflThreads / 32);
  const int rows = static_cast<int>(
      std::max(1L, std::min<long>(kCflMaxRows, (strips * ex + warps - 1) / warps)));
  const long items = strips * ((ex + rows - 1) / rows);
  const long blocks = std::max(1L, std::min((items + kCflThreads / 32 - 1) / (kCflThreads / 32),
                                            static_cast<long>(std::min(resident, scratch_blocks))));
  const auto kernel = wrap ? (vector ? dg1_sample_cfl_kernel<4, kVol, kEdge, true>
                                     : dg1_sample_cfl_kernel<1, kVol, kEdge, true>)
                           : (vector ? dg1_sample_cfl_kernel<4, kVol, kEdge, false>
                                     : dg1_sample_cfl_kernel<1, kVol, kEdge, false>);
  kernel<<<static_cast<int>(blocks), kCflThreads, 0, stream>>>(u, v, ex, ey, nx, ny, ld, rows, tb,
                                                               speeds, scratch, wrap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

// Floats of DgTables at `degree` (0, 1 or 2), or -1.
int nst_dg1_n_table_floats(int degree) {
  switch (degree) {
    case 0: return sizeof(nst::DgTables<0>) / sizeof(float);
    case 1: return sizeof(nst::DgTables<1>) / sizeof(float);
    case 2: return sizeof(nst::DgTables<2>) / sizeof(float);
    default: return -1;
  }
}

// `speeds` receives max |vx| and max |vy| over the first ex x ey elements
// of the nx x ny node planes u and v (row stride ld), sampled at the
// quadrature points of `degree` (tables: its DgTables); nothing needs to be
// zeroed before. scratch: 1 + 2 * scratch_blocks words on the device, the
// first 0 (and left 0 by each launch); launches on the same scratch must
// not overlap (one scratch a stream). vector: 16-byte loads (u and v
// 16-byte aligned, ld % 4 == 0, and 4 nodes from the last node column's
// 16-byte boundary inside the row). wrap: the periodic axes (kWrapX,
// kWrapY; node nx is node 0), on the whole domain only (ex = nx, ey = ny).
// Returns cudaGetLastError(); does not synchronise.
int nst_dg1_sample_cfl(const float* u, const float* v, float* speeds, unsigned int* scratch,
                       int scratch_blocks, int ex, int ey, int nx, int ny, int ld, int vector,
                       int wrap, int degree, const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (wrap < 0 || wrap > (nst::kWrapX | nst::kWrapY) || (wrap && (ex != nx || ey != ny))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (ex > nx || ey > ny || ny > ld || scratch_blocks < 1 || degree < 0 || degree > 2 ||
      (vector && ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(v)) % 16 != 0 ||
                  ld % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return degree == 2 ? nst::sample_call<9, 3>(u, v, speeds, scratch, scratch_blocks, ex, ey, nx,
                                              ny, ld, vector, wrap, tables, device, s)
                     : nst::sample_call<4, 2>(u, v, speeds, scratch, scratch_blocks, ex, ey, nx,
                                              ny, ld, vector, wrap, tables, device, s);
}

// One SSP-RK stage at `degree` (0, 1 or 2; tables: its DgTables): psi,
// base, out (K, n_tracers, nx, ny); out may alias base, not psi; base is
// read only where a != 0. mode kStageLimited (the coupled step): n_tracers
// is 3 (the kernel's warps are laid out for hice, cice and hsnow), the
// positivity limiter applies; kStageUnlimited (the TVB form's stage, dG1
// and dG2): the same without the limiter (dg1_limit follows); kStageRun
// (DGTransport.run): n_tracers is 1, the velocity comes from qv and face_x
// and face_y are not read (every face is open). wrap: the periodic axes
// (kWrapX, kWrapY): the window loads wrap and no face is a wall. The
// velocity: the CG1 nodes u and v, or with qv (not null) the quadrature-
// velocity plane pointers in the order of DgQvPlanes (12, or 24 at dG2;
// u and v are then not read). metric: null on a uniform mesh, else the 5
// plane pointers in the order of Dg1MetricPlanes. Returns
// cudaGetLastError(); does not synchronise.
int nst_dg1_rk_stage(const float* psi, const float* base, const float* u, const float* v,
                     const float* face_x, const float* face_y, const void* const* metric,
                     const void* const* qv, float* out, int nx, int ny, int n_tracers, int degree,
                     int mode, int wrap, float a, float b, float dt, const float* tables,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool form_ok = mode == nst::kStageRun
                           ? n_tracers == 1 && qv != nullptr
                           : (mode == nst::kStageLimited || (mode == nst::kStageUnlimited && degree > 0)) &&
                                 n_tracers == nst::kStageTracers && face_x && face_y;
  if (nx < 1 || ny < 1 || !form_ok || degree < 0 || degree > 2 || wrap < 0 ||
      wrap > (nst::kWrapX | nst::kWrapY)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0:
      return nst::stage_call<0>(psi, base, u, v, face_x, face_y, metric, qv, out, nx, ny, mode,
                                wrap, a, b, dt, tables, s);
    case 1:
      return nst::stage_call<1>(psi, base, u, v, face_x, face_y, metric, qv, out, nx, ny, mode,
                                wrap, a, b, dt, tables, s);
    default:
      return nst::stage_call<2>(psi, base, u, v, face_x, face_y, metric, qv, out, nx, ny, mode,
                                wrap, a, b, dt, tables, s);
  }
}

}  // extern "C"
