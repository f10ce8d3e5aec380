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
// the interior, nor N of H. On a periodic axis (the periodic instances,
// ho_tiled.cuh's kWrap) there is no wall: every window cell is a domain
// cell, loaded from its wrapped index and updated, so the ring argument
// alone bounds the exact interior; only cells inside the domain are written
// back.
//
// The A-weighted form (kHoWeighted) reads four more const planes, a_{k}, and
// weights the ocean drag by them. Its instances and the periodic ones are
// compiled in ho_tiled_forms.cu, so that the closed unweighted ones here keep
// their code. On a graded or spherical mesh (the metric form, kHoMetric) the
// element widths are four more const planes, read at each element's index,
// the apron's elements' too (wrapped on a periodic axis); its instances are
// compiled in ho_tiled_metric.cu.
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

#include "ho_tiled.cuh"

namespace nst {

// n_barriers barriers between two phases (window_sync) in a row, and
// nothing else: what one costs in clusters of a shape
// (benchmarks.mevp_large --barriers).
__global__ void window_sync_kernel(int n_barriers) {
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPos pos = cluster_pos(cluster);
  for (int i = 0; i < n_barriers; ++i) window_sync(cluster, pos);
}

HoTiledKernel ho_tiled_of(int sub, int form) {
  if ((form & kHoMetric) != 0) return ho_tiled_metric_of(sub, form);
  if (form != 0) return ho_tiled_forms_of(sub, form);
  return sub == 48 ? ho_tiled_kernel<48, 0, false> : ho_tiled_kernel<0, 0, false>;
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
// of `sub`) of the instance of `form` that the card holds at once, from
// cudaOccupancyMaxActiveClusters (0 where the kernel does not take it or none
// fits; -1 - error where the runtime refuses).
int nst_ho_tiled_max_clusters(int ca, int cb, int sub, int halo, int threads, int form,
                              int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const auto kernel = nst::ho_tiled_of(sub, form);
  if (!nst::ho_tiled_valid(ca, cb, sub, halo, threads) || kernel == nullptr) return 0;
  const nst::ClusterLaunch launch(dim3(cb, ca), cb, ca, threads,
                                  nst_ho_tiled_shared_bytes(sub), nullptr);
  return nst::max_active_clusters(kernel, launch);
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
// points to the 37 const-plane pointers in the order of HoConsts, the a_{k}
// null outside the weighted form, the widths null outside the metric form;
// scalars and tables to HoScalars and HoTables. form: kHoWeighted,
// kHoMetric, and the periodic axes' bits (kWrapX, kWrapY) shifted by
// kFormWrapShift, on which the windows wrap. Launches on
// `stream`, returns the CUDA error of the launch or its attributes (a
// refused cluster shape, shared memory size or non-portable size included);
// does not synchronise.
int nst_ho_tiled(const float* state_in, float* state_out, const void* const* consts, int nx,
                 int ny, int ca, int cb, int sub, int halo, int clusters_a,
                 int clusters_b, int n_sub, int threads, int form, const float* scalars,
                 const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wrap = form >> nst::kFormWrapShift;
  if (nx < 1 || ny < 1 || !nst::ho_tiled_valid(ca, cb, sub, halo, threads) || n_sub < 1 ||
      wrap > (nst::kWrapX | nst::kWrapY) ||
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
  if (((form & nst::kHoWeighted) != 0) != (k.a[0] != nullptr) ||
      ((form & nst::kHoMetric) != 0) != (k.dx != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = nst_ho_tiled_shared_bytes(sub);
  const auto kernel = nst::ho_tiled_of(sub, form);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  err = nst::prepare_cluster_kernel(kernel, bytes, ca * cb);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nst::ClusterLaunch launch(dim3(clusters_b * cb, clusters_a * ca), cb, ca, threads, bytes,
                                  static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.config, kernel, state_in, state_out, k, nx, ny, sub, halo,
                           n_sub, s, t, wrap);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
