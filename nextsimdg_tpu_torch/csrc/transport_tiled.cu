// DG tracer transport on Hopper (dG0, dG1, dG2) by ghost-zone tiles: whole
// substeps per launch, on persistent blocks whose window loads overlap
// their compute.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled,
// which runs up to K_CAP limited SSP-RK substeps per round on a halo'd block
// in VMEM, re-sampling the quadrature velocity inside the block, and writes
// back the interior (the TPU's pipeline fetches the next block while it
// computes this one). Here a tile is T x T elements and its window the
// (T + 2H)^2 cells around it, of u and v (nodes) and of the K x group
// coefficient planes of a group of the tracers: all of them at dG0 and dG1,
// one at dG2, whose 6 coefficients a tracer would leave no room for a full
// tile (a work item is a tile and a group, so the velocity is sampled once
// a group). The launch runs as many blocks as fit on the card at once, and
// block b walks the items b, b + G, b + 2G, ... (G blocks; the groups of a
// tile are consecutive items). For each item it runs n_sub substeps of
// rk1, rk2 or rk3 on the window in shared memory, each RK stage followed by
// a barrier, and writes the interior to the output planes (ping-pong on
// the host: blocks run in parallel and in no order, so a launch never
// updates its input in place).
//
// Window loads: with two input buffers, the window of the block's next tile
// is copied into one while the block computes on the other: cp.async
// (async_copy.cuh), each thread starting its share of the copies and
// waiting for them only before the tile that needs them, with the copy's
// zero fill beyond the domain giving the window's zeros there. Where ny is
// a multiple of 4 (and the planes 16-byte aligned) each copy moves 4 cells,
// else 1. A window row starts at the 16-byte boundary at or before the
// window's first column, so a block's window sits `s` = (j0 mod 4) columns
// into its rows, and the rows are padded to a multiple of 4 cells. With
// one buffer the copy of the next tile starts after the current one is
// stored, as a block per tile would, but on persistent blocks. (The Tensor Memory
// Accelerator's tensor copies, which would take the copies off the compute
// threads, fault with an illegal instruction on the H100 machines this was
// measured on, the CUDA toolkit's own libcu++ example included; PERF.md.)
//
// Ring budget: an RK stage at element e reads the coefficients of e - 1 and
// e + 1, and the velocity of element e needs nodes e and e + 1, so each
// stage invalidates one ring on either side. The host runs at most
// K_CAP = (H - 1) // stages substeps per launch, as transport_tiled.py does
// (its extra ring is the block-edge velocity sample; here that ring is
// absorbed by the first stage, so the budget is one ring conservative).
//
// Shared memory: one or two input buffers of u, v and the coefficients, and
// a scratch buffer of the coefficients (two for rk3). rk2's first stage
// writes the scratch buffer from the input; its second stage reads the
// scratch around the element and the input at the element (the step's
// base) and writes the input in place, which is safe because every element
// reads only its own base value. rk3's second stage reads the first scratch
// around the element and the base, and writes the second scratch: its
// neighbours read the first in the same stage, and the third stage needs
// the base again. The third stage reads the second scratch and the base and
// writes the input in place, as rk2's second does. A stage writes zeros at the cells of its region outside the
// domain, so the scratch buffer, which holds the previous tile's values,
// reads as zeros there like the copied window. The face masks, and on a
// graded or spherical mesh the transport's 5 metric planes, are read from
// global memory (read-only, L1/L2), so the metric does not grow the shared
// memory of a block.
//
// The HO path (kQv) passes the precomputed quadrature velocity of
// ho_velocity_to_quad instead of (u, v): 4 + 4 volume planes and 2 + 2 face
// planes (9 + 9 and 3 + 3 at dG2), read from global memory like the metric planes, so the window
// holds the coefficients only and the sampling is skipped. An element's
// right and top faces read the neighbour's vn_x and vn_y, which is the
// plain version's shifted left and bottom face fluxes.
//
// Walls: loads outside the domain are zeros and cells outside the domain
// are never updated, as in transport.cu's load_coeffs and at(). Each element
// runs dg1_stage_cell of dg1_body.cuh with the wall flags of its global
// index, exactly as dg1_rk_stage does (the JAX kernel zeroes the wall
// columns of the face masks instead; both give a zero flux there), so this
// schedule equals dg1_rk_stage's bit for bit.
//
// What bounds it on the H100 (dG1): a grid-wide dg1_rk_stage launch reads
// 13 planes and writes 9 per stage. Here the tracers are read and written once
// per launch (the window's ring ~1.4x more reads, mostly from L2), and the
// stage math, ~800 float operations per element and stage, runs on the
// window out of shared memory at ((T + 2H)/T)^2 redundant work in the first
// stage. With the loads behind the compute, the arithmetic and the
// shared-memory reads of the stages set the time.
#include <cstdint>
#include <cstring>

#include "async_copy.cuh"
#include "dg1_body.cuh"

namespace nst {

// The block size is a launch parameter; at most 768 threads keep the ~80
// registers of the dG1 stage body free of spills, at most 384 the larger
// dG2 body (6 coefficients of 5 elements, 9 volume points, the 21-point
// limiter).
template <int kDeg>
struct TransportShape {
  static constexpr int kMaxThreads = kDeg == 2 ? 384 : 768;
};
constexpr int kTransportMaxBuffers = 2;
constexpr int kTransportMaxStages = 3;

// Everything a launch takes.
template <int kDeg>
struct TransportTiledArgs {
  const float* psi_in;  // (K, n_tracers, nx, ny)
  float* psi_out;
  const float* u;
  const float* v;
  const float* face_x;
  const float* face_y;
  Dg1MetricPlanes m;
  DgQvPlanes<kDeg> qv;
  int nx, ny, n_tracers, group, n_groups, tile, halo, tiles_j, n_items, n_buffers, n_sub,
      n_stages;
  int compute;  // 0: load and store the windows only (the phase measurement)
  // Stage s: lim(a[s] base + b[s] (psi + dt rhs(psi))); a[0] is 0.
  float a[kTransportMaxStages], b[kTransportMaxStages];
  float dt;
  DgTables<kDeg> tb;
};

// Floats of shared memory, rounded up to 128 bytes.
__host__ __device__ __forceinline__ int round_128(int floats) { return (floats + 31) / 32 * 32; }

// The shared memory of one block, in floats: the input buffers (the
// n_coeff coefficient planes of a group, then u and v), then the scratch
// buffers of the coefficients (two for rk3). A window row holds the
// window's w cells from column s <= 3 on, padded to a multiple of 4.
struct TransportLayout {
  int window, pitch, plane, coeffs, buffer, scratch;
  __host__ __device__ TransportLayout(int tile, int halo, int n_coeff, bool qv, int n_stages)
      : window(tile + 2 * halo), pitch((tile + 2 * halo + 3 + 3) / 4 * 4),
        plane(window * pitch), coeffs(round_128(n_coeff * plane)),
        buffer(coeffs + (qv ? 0 : 2 * round_128(plane))),
        scratch((n_stages == 3 ? 2 : 1) * coeffs) {}
  __host__ __device__ int bytes(int n_buffers) const {
    return (n_buffers * buffer + scratch) * static_cast<int>(sizeof(float));
  }
};

// kVec: cells a copy moves, 4 (16 bytes: ny a multiple of 4, aligned
// planes) or 1.
template <int kDeg, bool kMetric, bool kQv, int kVec>
__global__ void __launch_bounds__(TransportShape<kDeg>::kMaxThreads, 1)
transport_tiled_kernel(const TransportTiledArgs<kDeg> g) {
  constexpr int kDofs = DgShape<kDeg>::kDofs;
  extern __shared__ __align__(128) float smem[];
  const int group = g.group;
  const TransportLayout lay(g.tile, g.halo, kDofs * group, kQv, g.n_stages);
  const int w = lay.window, P = lay.pitch, plane = lay.plane;
  const int nx = g.nx, ny = g.ny, nb = g.n_buffers;
  const long gplane = static_cast<long>(nx) * ny;
  float* const scratch = smem + nb * lay.buffer;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const int first = static_cast<int>(blockIdx.x), stride = static_cast<int>(gridDim.x);
  const int n_mine = (g.n_items - first + stride - 1) / stride;  // this block's items
  const int chunks = P / kVec;  // copies a window row
  const float inv_chunks = 1.0f / static_cast<float>(chunks);

  // Local item m is tile `tile` and tracers g0 ... g0 + group - 1; window
  // cell (a, b) of it is grid cell (i0 + a, j0 + b), at a * P + s + b of
  // each plane of its buffer, m % n_buffers. Window plane d * group + t
  // holds coefficient d of tracer g0 + t, grid plane d * n_tracers + g0 + t.
  const auto origin = [&](int m, int& i0, int& j0, int& g0) {
    const int item = first + m * stride;
    const int tile = item / g.n_groups;
    g0 = (item - tile * g.n_groups) * group;
    const int ti = tile / g.tiles_j;
    i0 = ti * g.tile - g.halo;
    j0 = (tile - ti * g.tiles_j) * g.tile - g.halo;
  };
  // Start copying local item m's window into its buffer: row a, copy x of
  // it covers columns ja + kVec x .. of the grid, ja = j0 - s the 16-byte
  // boundary at or before j0. One group of copies per item, empty past the
  // last, so that the waits count right.
  const auto issue = [&](int m) {
    if (m < n_mine) {
      float* dst = smem + (m % nb) * lay.buffer;
      float* dst_u = dst + lay.coeffs;
      float* dst_v = dst_u + round_128(plane);
      int i0, j0, g0;
      origin(m, i0, j0, g0);
      const int ja = j0 - (j0 & 3);
      for (int x = tid; x < w * chunks; x += n_threads) {
        const int a = region_row(x, inv_chunks), b = (x - a * chunks) * kVec;
        const int i = i0 + a, j = ja + b;
        const bool in = i >= 0 && i < nx && j >= 0 && j < ny;
        const long ij = static_cast<long>(i) * ny + j;
        const int at = a * P + b;
        // Beyond the domain the source is not read: any valid address will do.
#pragma unroll
        for (int d = 0; d < kDofs; ++d) {
          for (int t = 0; t < group; ++t) {
            const float* src = g.psi_in + (d * g.n_tracers + g0 + t) * gplane;
            cp_async<kVec>(dst + (d * group + t) * plane + at, in ? src + ij : g.psi_in, in);
          }
        }
        if (!kQv) {
          cp_async<kVec>(dst_u + at, in ? g.u + ij : g.u, in);
          cp_async<kVec>(dst_v + at, in ? g.v + ij : g.v, in);
        }
      }
    }
    cp_async_commit();
  };

  for (int m = 0; m < nb; ++m) issue(m);
  for (int m = 0; m < n_mine; ++m) {
    // Wait for the window of item m (the group of item m + 1 may stay in
    // flight).
    if (nb == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int i0, j0, g0;
    origin(m, i0, j0, g0);
    float* const input = smem + (m % nb) * lay.buffer + (j0 & 3);  // window cell (0, 0)
    const float* su = input + lay.coeffs;
    const float* sv = su + round_128(plane);

    float* cur = input;  // the substep's input and base
    // The stages' outputs: the first stage's (spare0), and rk3's second
    // (spare1). Named pointers and constant indices: an array indexed by
    // the stage would live in local memory.
    float* spare0 = scratch + (j0 & 3);
    float* const spare1 = scratch + lay.coeffs + (j0 & 3);
    int ring = 0;  // stages run so far: the valid window is [ring, w - ring)
    for (int sub = 0; sub < (g.compute ? g.n_sub : 0); ++sub) {
      for (int stage = 0; stage < g.n_stages; ++stage) {
        // Stage 0: lim(psi + dt rhs(psi)) from cur into spare0. A later
        // stage: lim(a base + b (psi_s + dt rhs(psi_s))) from the previous
        // stage's output, base cur, into spare1, or into cur in place for
        // the last.
        const float* src = stage == 0 ? cur : (stage == 1 ? spare0 : spare1);
        float* dst = stage == 0 ? spare0 : (stage == g.n_stages - 1 ? cur : spare1);
        const float sa = stage == 0 ? 0.0f : (stage == 1 ? g.a[1] : g.a[2]);
        const float sb = stage == 0 ? g.b[0] : (stage == 1 ? g.b[1] : g.b[2]);
        const int lo = ring + 1, r = w - 2 - 2 * ring;
        const float inv_r = 1.0f / static_cast<float>(r);
        for (int idx = tid; idx < r * r; idx += n_threads) {
          const int da = region_row(idx, inv_r);
          const int a = lo + da, b = lo + idx - da * r;
          const int i = i0 + a, j = j0 + b;
          const int c = a * P + b;
          if (i < 0 || i >= nx || j < 0 || j >= ny) {
            for (int q = 0; q < kDofs * group; ++q) dst[q * plane + c] = 0.0f;
            continue;
          }
          const long ij = static_cast<long>(i) * ny + j;
          Dg1Faces f;
          f.left_wall = i == 0;
          f.has_right = i + 1 < nx;
          f.bottom_wall = j == 0;
          f.has_top = j + 1 < ny;
          DgVelocity<kDeg> q;
          if (kQv) {
            q = load_qv(g.qv, ij, ny, f.has_right, f.has_top);
          } else {
            Corners corners;
            corners.u00 = su[c];
            corners.u10 = su[c + P];
            corners.u01 = su[c + 1];
            corners.u11 = su[c + P + 1];
            corners.v00 = sv[c];
            corners.v10 = sv[c + P];
            corners.v01 = sv[c + 1];
            corners.v11 = sv[c + P + 1];
            q = sample_velocity(g.tb, corners);
          }
          f.fx_left = __ldg(g.face_x + ij);
          f.fx_right = f.has_right ? __ldg(g.face_x + ij + ny) : 0.0f;
          f.fy_bottom = __ldg(g.face_y + ij);
          f.fy_top = f.has_top ? __ldg(g.face_y + ij + 1) : 0.0f;
          Dg1Metric gm = {};
          if (kMetric) gm = load_metric(g.m, ij, ny, f.has_right, f.has_top);
          for (int t = 0; t < group; ++t) {
            float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs], p0[kDofs];
#pragma unroll
            for (int d = 0; d < kDofs; ++d) {
              const float* s = src + (d * group + t) * plane + c;
              p[d] = s[0];
              p_l[d] = s[-P];
              p_r[d] = s[P];
              p_b[d] = s[-1];
              p_t[d] = s[1];
              p0[d] = sa != 0.0f ? cur[(d * group + t) * plane + c] : 0.0f;
            }
            float val[kDofs];
            dg1_stage_cell<kDeg, kMetric>(g.tb, q, f, gm, p, p_l, p_r, p_b, p_t, p0, sa, sb,
                                          g.dt, val);
#pragma unroll
            for (int d = 0; d < kDofs; ++d) dst[(d * group + t) * plane + c] = val[d];
          }
        }
        __syncthreads();
        ++ring;
      }
      if (g.n_stages == 1) {  // rk1: the stage's output is the next substep's input
        float* tmp = cur;
        cur = spare0;
        spare0 = tmp;
      }
    }

    // The T x T interior (window cells [halo, halo + tile)) is exact.
    const float inv_t = 1.0f / static_cast<float>(g.tile);
    for (int idx = tid; idx < g.tile * g.tile; idx += n_threads) {
      const int da = region_row(idx, inv_t);
      const int a = g.halo + da, b = g.halo + idx - da * g.tile;
      const int i = i0 + a, j = j0 + b;
      if (i >= nx || j >= ny) continue;
      const int c = a * P + b;
      const long ij = static_cast<long>(i) * ny + j;
#pragma unroll
      for (int d = 0; d < kDofs; ++d) {
        for (int t = 0; t < group; ++t) {
          g.psi_out[(d * g.n_tracers + g0 + t) * gplane + ij] = cur[(d * group + t) * plane + c];
        }
      }
    }
    // Every thread is done with this buffer (and the scratch): the window
    // of item m + n_buffers may go into it.
    __syncthreads();
    issue(m + nb);
  }
}

template <int kDeg>
using TransportKernel = void (*)(TransportTiledArgs<kDeg>);

template <int kDeg>
TransportKernel<kDeg> transport_tiled_of(bool metric, bool qv, bool vec) {
  if (vec) {
    return metric ? (qv ? transport_tiled_kernel<kDeg, true, true, 4>
                        : transport_tiled_kernel<kDeg, true, false, 4>)
                  : (qv ? transport_tiled_kernel<kDeg, false, true, 4>
                        : transport_tiled_kernel<kDeg, false, false, 4>);
  }
  return metric ? (qv ? transport_tiled_kernel<kDeg, true, true, 1>
                      : transport_tiled_kernel<kDeg, true, false, 1>)
                : (qv ? transport_tiled_kernel<kDeg, false, true, 1>
                      : transport_tiled_kernel<kDeg, false, false, 1>);
}

// The instance of a launch as an untyped function pointer (for the
// attribute and occupancy queries).
const void* transport_tiled_ptr(int degree, bool metric, bool qv, bool vec) {
  switch (degree) {
    case 0: return reinterpret_cast<const void*>(transport_tiled_of<0>(metric, qv, vec));
    case 1: return reinterpret_cast<const void*>(transport_tiled_of<1>(metric, qv, vec));
    default: return reinterpret_cast<const void*>(transport_tiled_of<2>(metric, qv, vec));
  }
}

// The launch's arguments at degree kDeg (see nst_transport_tiled), then the
// launch of `grid` blocks with `bytes` of shared memory.
template <int kDeg>
int tiled_call(const float* psi_in, float* psi_out, const float* u, const float* v,
               const float* face_x, const float* face_y, const void* const* metric,
               const void* const* qv, int nx, int ny, int n_tracers, int group, int tile,
               int halo, int n_sub, int n_stages, int threads, int n_buffers, int vec,
               int blocks, int compute, const float* weights, float dt, const float* tables,
               int bytes, cudaStream_t stream) {
  TransportTiledArgs<kDeg> g = {};
  g.psi_in = psi_in;
  g.psi_out = psi_out;
  g.u = u;
  g.v = v;
  g.face_x = face_x;
  g.face_y = face_y;
  if (metric != nullptr) std::memcpy(&g.m, metric, sizeof(g.m));
  if (qv != nullptr) std::memcpy(&g.qv, qv, sizeof(g.qv));
  g.nx = nx;
  g.ny = ny;
  g.n_tracers = n_tracers;
  g.group = group;
  g.n_groups = n_tracers / group;
  g.tile = tile;
  g.halo = halo;
  g.tiles_j = (ny + tile - 1) / tile;
  g.n_items = (nx + tile - 1) / tile * g.tiles_j * g.n_groups;
  g.n_buffers = n_buffers;
  g.n_sub = n_sub;
  g.n_stages = n_stages;
  g.compute = compute;
  for (int s = 0; s < kTransportMaxStages; ++s) {
    g.a[s] = weights[s];
    g.b[s] = weights[kTransportMaxStages + s];
  }
  g.dt = dt;
  std::memcpy(&g.tb, tables, sizeof(g.tb));
  const auto kernel = transport_tiled_of<kDeg>(metric != nullptr, qv != nullptr, vec != 0);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  const int grid = blocks < g.n_items ? blocks : g.n_items;
  kernel<<<grid, threads, bytes, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

// Dynamic shared memory of one block (tile, halo, n_coeff coefficient
// planes in a window: K x the tracers of a group, n_buffers input buffers;
// qv: the HO path's window, without u and v; n_stages 3 takes a second
// scratch buffer).
int nst_transport_tiled_shared_bytes(int tile, int halo, int n_coeff, int n_buffers, int qv,
                                     int n_stages) {
  return nst::TransportLayout(tile, halo, n_coeff, qv != 0, n_stages).bytes(n_buffers);
}

// Blocks of `threads` threads with `bytes` of shared memory that one SM
// holds at once (the kernel of the degree, metric, qv and copy width
// given), or minus a CUDA error code.
int nst_transport_tiled_blocks_per_sm(int degree, int metric, int qv, int vec, int threads,
                                      int bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  const void* kernel = nst::transport_tiled_ptr(degree, metric != 0, qv != 0, vec != 0);
  int per_sm = 0;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return per_sm;
}

// One round at `degree` (0, 1 or 2; tables: its DgTables), by blocks of
// `threads` threads (at most 768, 384 at dG2): n_sub substeps of an
// n_stages-stage SSP-RK scheme (1: rk1, 2: rk2, 3: rk3; weights: a[3] then
// b[3], stage s computing lim(a[s] base + b[s] (psi + dt rhs(psi))), a[0]
// = 0) from psi_in into psi_out, both (K, n_tracers, nx, ny), which must
// not alias; n_sub * n_stages <= halo - 1. A block's window holds `group`
// tracers (n_tracers a multiple of it). Tiles of `tile`; n_buffers 1 or 2
// input buffers a block; vec: copy 16 bytes at a time (ny a multiple of 4
// and 16-byte aligned planes), else 4; blocks: the grid (each block walks
// the items, a tile and a group each; at most one per item is launched: as
// many as the card holds at once for persistent blocks,
// nst_transport_tiled_blocks_per_sm); compute 0 only loads and stores the
// windows. metric: null on a uniform mesh, else the 5 plane pointers in
// the order of Dg1MetricPlanes. qv: null on the CG1 path (velocity sampled
// from u, v), else the quadrature-velocity plane pointers in the order of
// DgQvPlanes (12, or 24 at dG2; u and v are then not read). Launches on
// `stream`, returns cudaGetLastError() (or the error of the shared-memory
// attribute); does not synchronise.
int nst_transport_tiled(const float* psi_in, float* psi_out, const float* u, const float* v,
                        const float* face_x, const float* face_y, const void* const* metric,
                        const void* const* qv, int nx, int ny, int n_tracers, int group,
                        int degree, int tile, int halo, int n_sub, int n_stages, int threads,
                        int n_buffers, int vec, int blocks, int compute, const float* weights,
                        float dt, const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int max_threads =
      degree == 2 ? nst::TransportShape<2>::kMaxThreads : nst::TransportShape<1>::kMaxThreads;
  if (nx < 1 || ny < 1 || n_tracers < 1 || group < 1 || n_tracers % group != 0 || degree < 0 ||
      degree > 2 || tile < 1 || n_sub < 1 || n_stages < 1 ||
      n_stages > nst::kTransportMaxStages || n_sub * n_stages > halo - 1 || threads < 32 ||
      threads > max_threads || tile + 2 * halo > 1000 || n_buffers < 1 ||
      n_buffers > nst::kTransportMaxBuffers || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (vec && (ny % 4 != 0 || !aligned(psi_in) || (qv == nullptr && (!aligned(u) || !aligned(v))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_coeff = (degree == 0 ? 1 : degree == 1 ? 3 : 6) * group;
  const int bytes =
      nst_transport_tiled_shared_bytes(tile, halo, n_coeff, n_buffers, qv != nullptr, n_stages);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0:
      return nst::tiled_call<0>(psi_in, psi_out, u, v, face_x, face_y, metric, qv, nx, ny,
                                n_tracers, group, tile, halo, n_sub, n_stages, threads,
                                n_buffers, vec, blocks, compute, weights, dt, tables, bytes, s);
    case 1:
      return nst::tiled_call<1>(psi_in, psi_out, u, v, face_x, face_y, metric, qv, nx, ny,
                                n_tracers, group, tile, halo, n_sub, n_stages, threads,
                                n_buffers, vec, blocks, compute, weights, dt, tables, bytes, s);
    default:
      return nst::tiled_call<2>(psi_in, psi_out, u, v, face_x, face_y, metric, qv, nx, ny,
                                n_tracers, group, tile, halo, n_sub, n_stages, threads,
                                n_buffers, vec, blocks, compute, weights, dt, tables, bytes, s);
  }
}

}  // extern "C"
