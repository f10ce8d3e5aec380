// dG1 tracer transport on Hopper by ghost-zone tiles: whole substeps per
// launch, on persistent blocks whose window loads overlap their compute.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled,
// which runs up to K_CAP limited SSP-RK substeps per round on a halo'd block
// in VMEM, re-sampling the quadrature velocity inside the block, and writes
// back the interior (the TPU's pipeline fetches the next block while it
// computes this one). Here a tile is T x T elements and its window the
// (T + 2H)^2 cells around it, of u and v (nodes) and of the 3 x n_tracers
// dG1 coefficient planes. The launch runs as many blocks as fit on the card
// at once, and block b walks the tiles b, b + G, b + 2G, ... (G blocks). For
// each tile it runs n_sub substeps of rk1 or rk2 on the window in shared
// memory, each RK stage followed by a barrier, and writes the interior to
// the output planes (ping-pong on the host: blocks run in parallel and in
// no order, so a launch never updates its input in place).
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
// a scratch buffer of the coefficients. rk2's first stage writes the scratch
// buffer from the input; its second stage reads the scratch around the
// element and the input at the element (the step's base) and writes the
// input in place, which is safe because every element reads only its own
// base value. A stage writes zeros at the cells of its region outside the
// domain, so the scratch buffer, which holds the previous tile's values,
// reads as zeros there like the copied window. The face masks, and on a
// graded or spherical mesh the transport's 5 metric planes, are read from
// global memory (read-only, L1/L2), so the metric does not grow the shared
// memory of a block.
//
// The HO path (kQv) passes the precomputed quadrature velocity of
// ho_velocity_to_quad instead of (u, v): 4 + 4 volume planes and 2 + 2 face
// planes, read from global memory like the metric planes, so the window
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
// What bounds it on the H100: a grid-wide dg1_rk_stage launch reads 13
// planes and writes 9 per stage. Here the tracers are read and written once
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
// registers of the stage body free of spills.
constexpr int kTransportMaxThreads = 768;
constexpr int kTransportMaxBuffers = 2;

// Everything a launch takes.
struct TransportTiledArgs {
  const float* psi_in;  // (3 n_tracers, nx, ny)
  float* psi_out;
  const float* u;
  const float* v;
  const float* face_x;
  const float* face_y;
  Dg1MetricPlanes m;
  Dg1QvPlanes qv;
  int nx, ny, n_tracers, tile, halo, tiles_j, n_tiles, n_buffers, n_sub, n_stages;
  int compute;  // 0: load and store the windows only (the phase measurement)
  float a2, b2, dt;
  Dg1Tables tb;
};

// Floats of shared memory, rounded up to 128 bytes.
__host__ __device__ __forceinline__ int round_128(int floats) { return (floats + 31) / 32 * 32; }

// The shared memory of one block, in floats: the input buffers (the
// coefficients, then u and v), then the scratch buffer. A window row holds
// the window's w cells from column s <= 3 on, padded to a multiple of 4.
struct TransportLayout {
  int window, pitch, plane, n_coeff, coeffs, buffer, scratch;
  __host__ __device__ TransportLayout(int tile, int halo, int n_tracers, bool qv)
      : window(tile + 2 * halo), pitch((tile + 2 * halo + 3 + 3) / 4 * 4),
        plane(window * pitch), n_coeff(kDofs * n_tracers), coeffs(round_128(n_coeff * plane)),
        buffer(coeffs + (qv ? 0 : 2 * round_128(plane))), scratch(coeffs) {}
  __host__ __device__ int bytes(int n_buffers) const {
    return (n_buffers * buffer + scratch) * static_cast<int>(sizeof(float));
  }
};

// kVec: cells a copy moves, 4 (16 bytes: ny a multiple of 4, aligned
// planes) or 1.
template <bool kMetric, bool kQv, int kVec>
__global__ void __launch_bounds__(kTransportMaxThreads, 1)
transport_tiled_kernel(const TransportTiledArgs g) {
  extern __shared__ __align__(128) float smem[];
  const TransportLayout lay(g.tile, g.halo, g.n_tracers, kQv);
  const int w = lay.window, P = lay.pitch, plane = lay.plane, n_coeff = lay.n_coeff;
  const int nx = g.nx, ny = g.ny, nb = g.n_buffers;
  const long gplane = static_cast<long>(nx) * ny;
  float* const scratch = smem + nb * lay.buffer;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const int first = static_cast<int>(blockIdx.x), stride = static_cast<int>(gridDim.x);
  const int n_mine = (g.n_tiles - first + stride - 1) / stride;  // this block's tiles
  const int chunks = P / kVec;  // copies a window row
  const float inv_chunks = 1.0f / static_cast<float>(chunks);

  // Window cell (a, b) of local tile m is grid cell (i0 + a, j0 + b), at
  // a * P + s + b of each plane of its buffer, m % n_buffers.
  const auto origin = [&](int m, int& i0, int& j0) {
    const int t = first + m * stride;
    const int ti = t / g.tiles_j;
    i0 = ti * g.tile - g.halo;
    j0 = (t - ti * g.tiles_j) * g.tile - g.halo;
  };
  // Start copying local tile m's window into its buffer: row a, copy x of
  // it covers columns ja + kVec x .. of the grid, ja = j0 - s the 16-byte
  // boundary at or before j0. One group per tile, empty past the last, so
  // that the waits count right.
  const auto issue = [&](int m) {
    if (m < n_mine) {
      float* dst = smem + (m % nb) * lay.buffer;
      float* dst_u = dst + lay.coeffs;
      float* dst_v = dst_u + round_128(plane);
      int i0, j0;
      origin(m, i0, j0);
      const int ja = j0 - (j0 & 3);
      for (int x = tid; x < w * chunks; x += n_threads) {
        const int a = region_row(x, inv_chunks), b = (x - a * chunks) * kVec;
        const int i = i0 + a, j = ja + b;
        const bool in = i >= 0 && i < nx && j >= 0 && j < ny;
        const long ij = static_cast<long>(i) * ny + j;
        const int at = a * P + b;
        // Beyond the domain the source is not read: any valid address will do.
        for (int q = 0; q < n_coeff; ++q) {
          cp_async<kVec>(dst + q * plane + at, in ? g.psi_in + q * gplane + ij : g.psi_in, in);
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
    // Wait for the window of tile m (the group of tile m + 1 may stay in
    // flight).
    if (nb == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int i0, j0;
    origin(m, i0, j0);
    float* const input = smem + (m % nb) * lay.buffer + (j0 & 3);  // window cell (0, 0)
    const float* su = input + lay.coeffs;
    const float* sv = su + round_128(plane);

    float* cur = input;                    // the substep's input (and, for rk2, its base)
    float* spare = scratch + (j0 & 3);     // the first stage's output
    int ring = 0;  // stages run so far: the valid window is [ring, w - ring)
    for (int sub = 0; sub < (g.compute ? g.n_sub : 0); ++sub) {
      for (int stage = 0; stage < g.n_stages; ++stage) {
        // Stage 0: lim(psi + dt rhs(psi)) from cur into spare. Stage 1 (rk2):
        // lim(a2 base + b2 (psi1 + dt rhs(psi1))) from spare, base cur, into cur.
        const float* src = stage == 0 ? cur : spare;
        float* dst = stage == 0 ? spare : cur;
        const float sa = stage == 0 ? 0.0f : g.a2;
        const float sb = stage == 0 ? 1.0f : g.b2;
        const int lo = ring + 1, r = w - 2 - 2 * ring;
        const float inv_r = 1.0f / static_cast<float>(r);
        for (int idx = tid; idx < r * r; idx += n_threads) {
          const int da = region_row(idx, inv_r);
          const int a = lo + da, b = lo + idx - da * r;
          const int i = i0 + a, j = j0 + b;
          const int c = a * P + b;
          if (i < 0 || i >= nx || j < 0 || j >= ny) {
            for (int q = 0; q < n_coeff; ++q) dst[q * plane + c] = 0.0f;
            continue;
          }
          const long ij = static_cast<long>(i) * ny + j;
          Dg1Faces f;
          f.left_wall = i == 0;
          f.has_right = i + 1 < nx;
          f.bottom_wall = j == 0;
          f.has_top = j + 1 < ny;
          Dg1Velocity q;
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
          for (int t = 0; t < g.n_tracers; ++t) {
            float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs], p0[kDofs];
#pragma unroll
            for (int d = 0; d < kDofs; ++d) {
              const float* s = src + (d * g.n_tracers + t) * plane + c;
              p[d] = s[0];
              p_l[d] = s[-P];
              p_r[d] = s[P];
              p_b[d] = s[-1];
              p_t[d] = s[1];
              p0[d] = sa != 0.0f ? cur[(d * g.n_tracers + t) * plane + c] : 0.0f;
            }
            float val[kDofs];
            dg1_stage_cell<kMetric>(g.tb, q, f, gm, p, p_l, p_r, p_b, p_t, p0, sa, sb, g.dt, val);
#pragma unroll
            for (int d = 0; d < kDofs; ++d) dst[(d * g.n_tracers + t) * plane + c] = val[d];
          }
        }
        __syncthreads();
        ++ring;
      }
      if (g.n_stages == 1) {  // rk1: the stage's output is the next substep's input
        float* tmp = cur;
        cur = spare;
        spare = tmp;
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
      for (int q = 0; q < n_coeff; ++q) g.psi_out[q * gplane + ij] = cur[q * plane + c];
    }
    // Every thread is done with this buffer (and the scratch): the window
    // of tile m + n_buffers may go into it.
    __syncthreads();
    issue(m + nb);
  }
}

using TransportKernel = void (*)(TransportTiledArgs);

TransportKernel transport_tiled_of(bool metric, bool qv, bool vec) {
  if (vec) {
    return metric ? (qv ? transport_tiled_kernel<true, true, 4> : transport_tiled_kernel<true, false, 4>)
                  : (qv ? transport_tiled_kernel<false, true, 4> : transport_tiled_kernel<false, false, 4>);
  }
  return metric ? (qv ? transport_tiled_kernel<true, true, 1> : transport_tiled_kernel<true, false, 1>)
                : (qv ? transport_tiled_kernel<false, true, 1> : transport_tiled_kernel<false, false, 1>);
}

}  // namespace nst

extern "C" {

// Dynamic shared memory of one block (tile, halo, n_buffers input buffers;
// qv: the HO path's window, without u and v).
int nst_transport_tiled_shared_bytes(int tile, int halo, int n_tracers, int n_buffers, int qv) {
  return nst::TransportLayout(tile, halo, n_tracers, qv != 0).bytes(n_buffers);
}

// Blocks of `threads` threads with `bytes` of shared memory that one SM
// holds at once (the kernel of the metric, qv and copy width given), or
// minus a CUDA error code.
int nst_transport_tiled_blocks_per_sm(int metric, int qv, int vec, int threads, int bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
  const auto kernel = nst::transport_tiled_of(metric != 0, qv != 0, vec != 0);
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

// One round, by blocks of `threads` threads (at most 768): n_sub substeps of
// an n_stages-stage SSP-RK scheme (1: rk1, 2: rk2 with second-stage weights
// a2, b2) from psi_in into psi_out, both (3, n_tracers, nx, ny), which must
// not alias; n_sub * n_stages <= halo - 1. Tiles of `tile`; n_buffers 1 or
// 2 input buffers a block; vec: copy 16 bytes at a time (ny a multiple of 4
// and 16-byte aligned planes), else 4; blocks: the grid (each block walks
// the tiles; at most one per tile is launched: as many as the card holds
// at once for persistent blocks, nst_transport_tiled_blocks_per_sm);
// compute 0 only loads and stores the windows. metric: null on a uniform
// mesh, else the 5 plane pointers in the order of Dg1MetricPlanes. qv: null
// on the CG1 path (velocity sampled from u, v), else the 12
// quadrature-velocity plane pointers in the order of Dg1QvPlanes (u and v
// are then not read). Launches on `stream`, returns cudaGetLastError() (or
// the error of the shared-memory attribute); does not synchronise.
int nst_transport_tiled(const float* psi_in, float* psi_out, const float* u, const float* v,
                        const float* face_x, const float* face_y, const void* const* metric,
                        const void* const* qv, int nx, int ny, int n_tracers, int tile, int halo,
                        int n_sub, int n_stages, int threads, int n_buffers, int vec, int blocks,
                        int compute, float a2, float b2, float dt, const float* tables, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || n_tracers < 1 || tile < 1 || n_sub < 1 || n_stages < 1 ||
      n_stages > 2 || n_sub * n_stages > halo - 1 || threads < 32 ||
      threads > nst::kTransportMaxThreads || tile + 2 * halo > 1000 || n_buffers < 1 ||
      n_buffers > nst::kTransportMaxBuffers || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (vec && (ny % 4 != 0 || !aligned(psi_in) || (qv == nullptr && (!aligned(u) || !aligned(v))))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::TransportTiledArgs g = {};
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
  g.tile = tile;
  g.halo = halo;
  g.tiles_j = (ny + tile - 1) / tile;
  g.n_tiles = (nx + tile - 1) / tile * g.tiles_j;
  g.n_buffers = n_buffers;
  g.n_sub = n_sub;
  g.n_stages = n_stages;
  g.compute = compute;
  g.a2 = a2;
  g.b2 = b2;
  g.dt = dt;
  std::memcpy(&g.tb, tables, sizeof(g.tb));
  const auto kernel = nst::transport_tiled_of(metric != nullptr, qv != nullptr, vec != 0);
  const int bytes = nst_transport_tiled_shared_bytes(tile, halo, n_tracers, n_buffers, qv != nullptr);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  const int grid = blocks < g.n_tiles ? blocks : g.n_tiles;
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
