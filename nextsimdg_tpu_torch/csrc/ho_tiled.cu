// Higher-order (CG2/dG1) mEVP subcycles on Hopper by ghost-zone windows, one
// window per thread-block cluster: H subcycles per launch.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py::ho_subcycles_tiled,
// which runs halo_x HO subcycles per round on full-row halo'd blocks of the
// 17 state planes (4 + 4 CG2 velocity, 3 x 3 dG1 stress coefficients) and
// the 29 const planes in VMEM, ping-ponging the padded state between two
// HBM slots and writing back only the interiors.
//
// Here a cluster of CA x CB blocks (cluster_window.cuh) holds one window of
// (CA S) x (CB S) cells of the 17 state planes: block (p, q) of the cluster
// keeps the S x S sub-window at (p S, q S) of it in its shared memory. The
// launch runs min(H, remaining) subcycles on the window, each one a stress
// phase over the elements that are still valid, a cluster barrier, a
// velocity phase over the node indices, and a cluster barrier. The element
// gather reaches +1 and the node scatter -1 node index, so each subcycle
// invalidates one ring of the cluster's window on either side (the
// argument of the JAX kernel), and after H subcycles the window's interior,
// (CA S - 2H) x (CB S - 2H), is exact; only the interior is written back.
// The ring is paid once per cluster, not once per block: a 2 x 2 cluster of
// 48^2 sub-windows computes 1.21x the interior's work over 8 subcycles,
// where one 48^2 window a block (the design before clusters) computed 1.58x.
// The 29 const planes are read from global memory where they are needed
// (read-only for the launch, through __ldg).
//
// Across a sub-window edge a stress gather reads the next block's first
// node row or column, a velocity scatter the previous block's last element
// row or column. Each block's sub-window has a one-cell apron: after each
// phase the block copies its edge row and column into the apron of the
// neighbour that reads them (through distributed shared memory), so every
// read is local. (Reading the neighbour's shared memory in place instead
// ran 25-35% slower on the H100; PERF.md.)
//
// A cluster barrier after each phase orders the pushes before the
// neighbours' reads, and the reads before the next pushes (the block's
// barrier for a cluster of one block). On the H100 one costs ~0.7 us in
// 2 x 2 clusters against ~0.03 us for the block's barrier
// (benchmarks.mevp_large --barriers); splitting it (arrive after the edge
// cells, wait before the next phase) measured no better (PERF.md). The
// barriers and the pushes cost more than the ring they save: the host
// ships clusters of one block, one 48^2 window a block
// (ho_tiled_cuda.launch_config), and the larger clusters stay for the
// checks and the sweeps.
//
// In place in shared memory is safe: the stress phase writes only its
// element's coefficients (and their apron copies) and reads, besides them,
// only velocities; the velocity phase writes only its node index's
// velocities and reads, besides them, only stresses. Clusters run in
// parallel and in no order, so a launch reads one state buffer and writes
// another (ping-pong on the host).
//
// Walls: a load outside the domain is a zero, in every plane, and cells
// outside the domain are never updated (nor pushed), so they stay zero: that
// is the closed wall (the i = nx and j = ny nodes are implicit zeros, and a
// missing element contributes no force). nx and ny need not be multiples of
// the interior, nor N of H.
//
// Each element and node index runs ho_stress_body and ho_velocity_body of
// ho_body.cuh, as ho_single.cu does, with the same --fmad=false, so the two
// schedules agree bit for bit.
//
// What bounds it on the H100: the ~900 float32 operations per element and
// subcycle, times the ring's redundancy, and how well one block of up to
// 512 threads an SM (the body's ~128 registers) hides the latency of its
// barriers, divides, square roots and const loads from L1/L2. HBM sees the
// 17 state planes in and out once per launch. Shared memory sizes the
// sub-window: 17 planes of (S + 2)^2 floats in a block's 227 KB, so
// S <= 56. A cluster's blocks must be resident on one GPC at once: with
// one block an SM the H100 holds 132 clusters of one block but 30 clusters
// of 4 (120 SMs). The shipped sub-window width, 48, has a kernel of its
// own with the width a compile-time constant.
#include <cstring>

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
// offsets become immediates), 0 where it is read from sub_w.
template <int kS>
__global__ void __launch_bounds__(kHoTiledMaxThreads)
ho_tiled_kernel(const float* __restrict__ state_in, float* __restrict__ state_out, HoConsts k,
                int nx, int ny, int sub_w, int halo, int n_sub, HoScalars s, HoTables t) {
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
  const auto inside = [&](int i, int j) { return i >= 0 && i < nx && j >= 0 && j < ny; };

  // The load: the sub-window and its apron, zeros beyond the domain, row by
  // row, consecutive threads on consecutive cells of a row.
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int c = tid; c < plane; c += n_threads) {
    const int da = region_row(c, inv_pitch);
    const int i = i0 + da - 1, j = j0 + c - da * pitch - 1;
    const bool in = inside(i, j);
    const long ij = static_cast<long>(i) * ny + j;
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
      ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + static_cast<long>(i) * ny + j));
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
      ho_velocity_body(t, s, k, static_cast<long>(i) * ny + j,
                       [&](int di, int dj, float* s11, float* s22, float* s12) {
                         const int e = c + di * pitch + dj;
#pragma unroll
                         for (int q = 0; q < kHoCoeffs; ++q) {
                           s11[q] = smem[(kHoS11 + q) * plane + e];
                           s22[q] = smem[(kHoS22 + q) * plane + e];
                           s12[q] = smem[(kHoS12 + q) * plane + e];
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

// n_barriers barriers between two phases (window_sync) in a row, and
// nothing else: what one costs in clusters of a shape
// (benchmarks.mevp_large --barriers).
__global__ void window_sync_kernel(int n_barriers) {
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPos pos = cluster_pos(cluster);
  for (int i = 0; i < n_barriers; ++i) window_sync(cluster, pos);
}

using HoTiledKernel = void (*)(const float*, float*, HoConsts, int, int, int, int, int,
                               HoScalars, HoTables);

// The kernel of a sub-window width: the shipped width 48 has its own.
HoTiledKernel ho_tiled_of(int sub) {
  return sub == 48 ? ho_tiled_kernel<48> : ho_tiled_kernel<0>;
}

// A launch configuration the kernel takes: 1 to 16 blocks a cluster, each
// axis' interior at least one cell, up to 512 threads.
bool ho_tiled_valid(int ca, int cb, int sub, int halo, int threads) {
  return ca >= 1 && cb >= 1 && ca * cb <= kHoTiledMaxClusterBlocks && sub >= 1 && sub <= 1000 &&
         halo >= 1 && ca * sub > 2 * halo && cb * sub > 2 * halo && threads >= 32 &&
         threads <= kHoTiledMaxThreads;
}

}  // namespace nst

extern "C" {

int nst_ho_tiled_shared_bytes(int sub) {
  const int pitch = sub + 2;
  return nst::kHoStatePlanes * pitch * pitch * static_cast<int>(sizeof(float));
}

// Clusters of a launch configuration (ca x cb blocks of `threads`, sub-windows
// of `sub`) that the card holds at once, from cudaOccupancyMaxActiveClusters
// (0 where the kernel does not take it or none fits; -1 - error where the
// runtime refuses).
int nst_ho_tiled_max_clusters(int ca, int cb, int sub, int halo, int threads, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  if (!nst::ho_tiled_valid(ca, cb, sub, halo, threads)) return 0;
  const nst::ClusterLaunch launch(dim3(cb, ca), cb, ca, threads,
                                  nst_ho_tiled_shared_bytes(sub), nullptr);
  return nst::max_active_clusters(nst::ho_tiled_of(sub), launch);
}

// One wave of window_sync_kernel: as many clusters of ca x cb blocks of
// `threads` threads, each holding `bytes` of dynamic shared memory, as the
// card holds at once (written to *clusters), each block running
// n_barriers barriers. Returns the CUDA error of the launch or of its
// attributes; does not synchronise.
int nst_window_syncs(int ca, int cb, int threads, int bytes, int n_barriers, int device,
                     void* stream, int* clusters) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ca < 1 || cb < 1 || ca * cb > nst::kHoTiledMaxClusterBlocks || threads < 32 ||
      threads > 1024 || bytes < 0 || n_barriers < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const nst::ClusterLaunch probe(dim3(cb, ca), cb, ca, threads, bytes, nullptr);
  const int active = nst::max_active_clusters(nst::window_sync_kernel, probe);
  if (active < 0) return -1 - active;
  if (active == 0) return static_cast<int>(cudaErrorInvalidValue);
  *clusters = active;
  const nst::ClusterLaunch launch(dim3(active * cb, ca), cb, ca, threads, bytes,
                                  static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.config, nst::window_sync_kernel, n_barriers);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// One round: n_sub (<= halo) subcycles from the (17, nx, ny) state_in into
// state_out, which must not alias it, by clusters_a x clusters_b clusters of
// ca x cb blocks of `threads` threads (at most 512), each block an S x S
// sub-window (sub) and its apron; the clusters must cover the
// domain (clusters_a (ca sub - 2 halo) >= nx, and along j likewise). consts
// points to the 29 const-plane pointers in the order of HoConsts; scalars
// and tables to HoScalars and HoTables. Launches on `stream`, returns the
// CUDA error of the launch or its attributes (a refused cluster shape,
// shared memory size or non-portable size included); does not synchronise.
int nst_ho_tiled(const float* state_in, float* state_out, const void* const* consts, int nx,
                 int ny, int ca, int cb, int sub, int halo, int clusters_a,
                 int clusters_b, int n_sub, int threads, const float* scalars,
                 const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || !nst::ho_tiled_valid(ca, cb, sub, halo, threads) || n_sub < 1 ||
      halo < n_sub || clusters_a < 1 || clusters_b < 1 ||
      static_cast<long>(clusters_a) * (ca * sub - 2 * halo) < nx ||
      static_cast<long>(clusters_b) * (cb * sub - 2 * halo) < ny ||
      static_cast<long>(clusters_a) * ca > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::HoConsts k;
  std::memcpy(&k, consts, sizeof(k));
  nst::HoScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  nst::HoTables t;
  std::memcpy(&t, tables, sizeof(t));
  const int bytes = nst_ho_tiled_shared_bytes(sub);
  const auto kernel = nst::ho_tiled_of(sub);
  err = nst::prepare_cluster_kernel(kernel, bytes, ca * cb);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nst::ClusterLaunch launch(dim3(clusters_b * cb, clusters_a * ca), cb, ca, threads, bytes,
                                  static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.config, kernel, state_in, state_out, k, nx, ny, sub, halo,
                           n_sub, s, t);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
