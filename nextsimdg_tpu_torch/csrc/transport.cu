// dG1 tracer transport on Hopper: CFL speeds and one limited SSP-RK stage.
//
// Replaces the transport part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas
// (velocity_from_cg, cfl_substeps and k limited DGTransport.step calls on
// the stacked (K=3, T, nx, ny) tracers, all resident on one core):
//
//   dg1_sample_cfl (elements): samples the CG1 velocity at the 2x2 volume
//                  points and the 2 points of the element's left and bottom
//                  faces and reduces max |vx| and max |vy| over the elements.
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
//                  lim(psi + dt*rhs(psi)) when a == 0, for all T tracers x 3
//                  dofs. It re-samples the velocity from u and v instead of
//                  reading 12 quadrature planes, zeroes the global x = 0 and
//                  y = 0 wall faces, multiplies the fluxes by the face_x and
//                  face_y planes (all ones without a coastline), on a graded
//                  or spherical mesh reads the transport's 5 metric planes,
//                  and applies the dG1 corner positivity limiter. It reads
//                  its neighbours' psi, so `out` must not alias `psi` (it
//                  may alias `base`).
//
// The tables, the velocity sampling and the per-element stage math live in
// dg1_body.cuh, shared with the tiled schedule of transport_tiled.cu.
//
// What bounds dg1_sample_cfl on the H100: the 8 bytes of u and v per node,
// read once (64 MiB each at 4096^2, ~40 us at the data sheet's 3.35 TB/s);
// at 256^2 the launch itself. Its first form ran one element a thread with
// 8 scalar loads and two atomicMax per block of 256 threads on the same two
// words (131,072 of them at 4096^2), after a memset (PERF.md).
//
// What bounds dg1_rk_stage on the H100: a stage reads u, v, the two face planes and
// 9 coefficient planes with a 5-point stencil, and writes 9 (about 88 bytes
// per element when the neighbours hit in cache); the whole phase at 256^2
// stays in L2, so again launch latency bounds it (2 stages per substep).
// Keeping k on the device and fusing the stages is left for later.
#include <cuda/atomic>

#include <algorithm>
#include <atomic>
#include <cstring>

#include "dg1_body.cuh"

namespace nst {

__device__ __forceinline__ Corners load_corners(const float* u, const float* v,
                                                int i, int j, int nx, int ny) {
  Corners c;
  c.u00 = at(u, i, j, nx, ny);
  c.u10 = at(u, i + 1, j, nx, ny);
  c.u01 = at(u, i, j + 1, nx, ny);
  c.u11 = at(u, i + 1, j + 1, nx, ny);
  c.v00 = at(v, i, j, nx, ny);
  c.v10 = at(v, i + 1, j, nx, ny);
  c.v01 = at(v, i, j + 1, nx, ny);
  c.v11 = at(v, i + 1, j + 1, nx, ny);
  return c;
}

__device__ __forceinline__ void load_coeffs(const float* psi, int t, int n_tracers,
                                            int i, int j, int nx, int ny,
                                            float c[kDofs]) {
  const long plane = static_cast<long>(nx) * ny;
#pragma unroll
  for (int k = 0; k < kDofs; ++k) {
    c[k] = (i >= 0 && i < nx && j >= 0 && j < ny)
               ? psi[(k * n_tracers + t) * plane + static_cast<long>(i) * ny + j]
               : 0.0f;
  }
}

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
template <int kPer>
__device__ __forceinline__ void load_nodes(const float* f, int a, int b, int nx, int ny, int ld,
                                           float (&x)[kPer + 1]) {
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
}

template <int kPer>
__device__ __forceinline__ void finish_nodes(float (&x)[kPer + 1]) {
  const float next = __shfl_down_sync(0xffffffffu, x[0], 1);
  if ((threadIdx.x & 31) != 31) x[kPer] = next;
}

// kPer consecutive elements a lane: 4 by 16-byte loads (u and v 16-byte
// aligned, ld a multiple of 4, and every 16-byte load of the last node
// column inside the row; the host checks), else 1 by 4-byte loads. A warp
// takes item after item: `rows` rows (the host sizes them so that the items
// fill the resident warps) of a strip of 32 kPer columns.
// scratch: [0] the count of blocks done (0 between launches), then a
// (max |vx|, max |vy|) pair per block.
template <int kPer>
__global__ void __launch_bounds__(kCflThreads)
dg1_sample_cfl_kernel(const float* __restrict__ u, const float* __restrict__ v, int ex, int ey,
                      int nx, int ny, int ld, int rows, Dg1Tables tb, float* __restrict__ speeds,
                      unsigned int* __restrict__ scratch) {
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
    load_nodes<kPer>(u, i0, j, nx, ny, ld, u_top);
    load_nodes<kPer>(v, i0, j, nx, ny, ld, v_top);
    load_nodes<kPer>(u, i0 + 1, j, nx, ny, ld, u_bot);
    load_nodes<kPer>(v, i0 + 1, j, nx, ny, ld, v_bot);
    finish_nodes<kPer>(u_top);
    finish_nodes<kPer>(v_top);
    finish_nodes<kPer>(u_bot);
    finish_nodes<kPer>(v_bot);
    for (int i = i0; i < i1; ++i) {
      // The next row's loads go out before this row's maxima.
      float u_next[kPer + 1] = {}, v_next[kPer + 1] = {};
      const bool more = i + 1 < i1;
      if (more) {
        load_nodes<kPer>(u, i + 2, j, nx, ny, ld, u_next);
        load_nodes<kPer>(v, i + 2, j, nx, ny, ld, v_next);
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
        finish_nodes<kPer>(u_next);
        finish_nodes<kPer>(v_next);
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

// Blocks of dg1_sample_cfl_kernel<kPer> resident at once on `device`,
// worked out once per device and form.
template <int kPer>
int cfl_resident_blocks(int device) {
  static std::atomic<int> known[64];
  if (device < 0 || device >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  int blocks = known[device].load(std::memory_order_relaxed);
  if (blocks > 0) return blocks;
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dg1_sample_cfl_kernel<kPer>, kCflThreads, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  known[device].store(per_sm * sms, std::memory_order_relaxed);
  return per_sm * sms;
}

template <bool kMetric>
__global__ void dg1_rk_stage_kernel(
    const float* __restrict__ psi, const float* base, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ face_x,
    const float* __restrict__ face_y, Dg1MetricPlanes m, float* out, int nx, int ny,
    int n_tracers, float a, float b, float dt, Dg1Tables tb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ij = i * ny + j;
  const long plane = static_cast<long>(nx) * ny;

  const Dg1Velocity q = sample_velocity(tb, load_corners(u, v, i, j, nx, ny));
  Dg1Faces f;
  f.left_wall = i == 0;
  f.has_right = i + 1 < nx;
  f.bottom_wall = j == 0;
  f.has_top = j + 1 < ny;
  f.fx_left = face_x[ij];
  f.fx_right = f.has_right ? face_x[ij + ny] : 0.0f;
  f.fy_bottom = face_y[ij];
  f.fy_top = f.has_top ? face_y[ij + 1] : 0.0f;
  Dg1Metric g = {};
  if (kMetric) g = load_metric(m, ij, ny, f.has_right, f.has_top);

  for (int t = 0; t < n_tracers; ++t) {
    float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs], p0[kDofs];
    load_coeffs(psi, t, n_tracers, i, j, nx, ny, p);
    load_coeffs(psi, t, n_tracers, i - 1, j, nx, ny, p_l);
    load_coeffs(psi, t, n_tracers, i + 1, j, nx, ny, p_r);
    load_coeffs(psi, t, n_tracers, i, j - 1, nx, ny, p_b);
    load_coeffs(psi, t, n_tracers, i, j + 1, nx, ny, p_t);
#pragma unroll
    for (int k = 0; k < kDofs; ++k) {
      p0[k] = a != 0.0f ? base[(k * n_tracers + t) * plane + ij] : 0.0f;
    }
    float val[kDofs];
    dg1_stage_cell<kMetric>(tb, q, f, g, p, p_l, p_r, p_b, p_t, p0, a, b, dt, val);
#pragma unroll
    for (int k = 0; k < kDofs; ++k) out[(k * n_tracers + t) * plane + ij] = val[k];
  }
}

}  // namespace nst

extern "C" {

int nst_dg1_n_table_floats() { return sizeof(nst::Dg1Tables) / sizeof(float); }

// `speeds` receives max |vx| and max |vy| over the first ex x ey elements
// of the nx x ny node planes u and v (row stride ld); nothing needs to be
// zeroed before. scratch: 1 + 2 * scratch_blocks words on the device, the
// first 0 (and left 0 by each launch); launches on the same scratch must
// not overlap (one scratch a stream). vector: 16-byte loads (u and v
// 16-byte aligned, ld % 4 == 0, and 4 nodes from the last node column's
// 16-byte boundary inside the row). Returns cudaGetLastError(); does not
// synchronise.
int nst_dg1_sample_cfl(const float* u, const float* v, float* speeds, unsigned int* scratch,
                       int scratch_blocks, int ex, int ey, int nx, int ny, int ld, int vector,
                       const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ex > nx || ey > ny || ny > ld || scratch_blocks < 1 ||
      (vector && ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(v)) % 16 != 0 ||
                  ld % 4 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::Dg1Tables tb;
  std::memcpy(&tb, tables, sizeof(tb));
  const int resident = vector ? nst::cfl_resident_blocks<4>(device) : nst::cfl_resident_blocks<1>(device);
  if (resident < 0) return -resident;
  // Rows an item: enough items for every resident warp, at most 32 rows.
  const long strips = (ey + 32L * (vector ? 4 : 1) - 1) / (32L * (vector ? 4 : 1));
  const long warps = static_cast<long>(std::min(resident, scratch_blocks)) * (nst::kCflThreads / 32);
  const int rows = static_cast<int>(
      std::max(1L, std::min<long>(nst::kCflMaxRows, (strips * ex + warps - 1) / warps)));
  const long items = strips * ((ex + rows - 1) / rows);
  const long blocks = std::max(1L, std::min((items + nst::kCflThreads / 32 - 1) / (nst::kCflThreads / 32),
                                            static_cast<long>(std::min(resident, scratch_blocks))));
  const auto kernel = vector ? nst::dg1_sample_cfl_kernel<4> : nst::dg1_sample_cfl_kernel<1>;
  kernel<<<static_cast<int>(blocks), nst::kCflThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, ex, ey, nx, ny, ld, rows, tb, speeds, scratch);
  return static_cast<int>(cudaGetLastError());
}

// psi, base, out: (3, n_tracers, nx, ny); out may alias base, not psi.
// metric: null on a uniform mesh, else the 5 plane pointers in the order
// of Dg1MetricPlanes.
int nst_dg1_rk_stage(const float* psi, const float* base, const float* u,
                     const float* v, const float* face_x, const float* face_y,
                     const void* const* metric, float* out, int nx, int ny,
                     int n_tracers, float a, float b, float dt, const float* tables,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::Dg1Tables tb;
  std::memcpy(&tb, tables, sizeof(tb));
  nst::Dg1MetricPlanes m = {};
  if (metric != nullptr) std::memcpy(&m, metric, sizeof(m));
  const auto kernel = metric != nullptr ? nst::dg1_rk_stage_kernel<true>
                                        : nst::dg1_rk_stage_kernel<false>;
  kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      psi, base, u, v, face_x, face_y, m, out, nx, ny, n_tracers, a, b, dt, tb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
