// One ghost-zone window per thread-block cluster (Hopper): the launch and
// the neighbour exchange that ho_tiled.cu and rdma_band (mevp_rdma.cu)
// share.
//
// A tiled kernel that runs H subcycles on a window of the state pays a ring
// of H cells at the window's edge: the cells there are computed on spoiled
// inputs and thrown away. With one window per block that ring is paid at
// every block's edge, and shared memory (227 KB a block) caps the window.
// A cluster of blocks on neighbouring SMs of one GPC holds one window
// between them: block (p, q) of the cluster keeps the sub-window at (p S,
// q S) in its own shared memory, and the ring is paid once at the
// cluster's outer edge. What a cell reads across a sub-window edge the
// block that computes it copies into a one-cell apron of the neighbour's
// sub-window (distributed shared memory, cooperative_groups'
// map_shared_rank), so that every read is local. Both the mEVP stencils
// read one way per phase (the stress phase at element (a, b) reads nodes
// a..a+1, b..b+1; the velocity phase at node (a, b) reads elements
// a-1..a, b-1..b), so an element on the last row or column of a sub-window
// is pushed down and right, and a node on the first row or column up and
// left.
//
// Barriers: cluster.sync() (arrive with release, wait with acquire) after
// the load and after each phase (a block barrier where the cluster is one
// block: window_sync). On the H100 a cluster barrier costs ~0.7 us in
// clusters of 4 and ~0.8 us in clusters of 16, the block's ~0.03 us
// (window_sync_kernel, benchmarks.mevp_large --barriers): a cluster pays
// only where a phase has many microseconds of work. The first makes every block of the cluster
// resident before any reads or writes another's shared memory, and keeps a
// neighbour's load of its apron from overwriting a pushed value; the last
// one of a launch keeps a block from leaving while a neighbour still reads
// or writes its shared memory. Every block of a cluster reaches every
// barrier: the grid is a whole number of clusters, and a block whose
// sub-window lies wholly outside the domain computes nothing but does not
// return early.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace nst {

namespace cg = cooperative_groups;

// The position of this block in its cluster: (x, y) = (column, row) of the
// block in the cluster, (nx, ny) = the cluster's blocks along each.
struct ClusterPos {
  int x, y, nx, ny;
  // The rank of block (x, y) of the cluster, as map_shared_rank takes it.
  __device__ __forceinline__ unsigned rank(int bx, int by) const {
    return static_cast<unsigned>(by * nx + bx);
  }
};

__device__ __forceinline__ ClusterPos cluster_pos(const cg::cluster_group& cluster) {
  const dim3 index = cluster.block_index();
  const dim3 dims = cluster.dim_blocks();
  return {static_cast<int>(index.x), static_cast<int>(index.y), static_cast<int>(dims.x),
          static_cast<int>(dims.y)};
}

// The barrier between two phases: the cluster's (arrive with release, wait
// with acquire), or the block's where the cluster is one block.
__device__ __forceinline__ void window_sync(const cg::cluster_group& cluster, const ClusterPos& pos) {
  if (pos.nx * pos.ny == 1) {
    __syncthreads();
  } else {
    cluster.sync();
  }
}

// The launch configuration of a grid of clusters of cluster_x x cluster_y
// blocks (cluster_x along gridDim.x).
struct ClusterLaunch {
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attribute;

  ClusterLaunch(dim3 grid, int cluster_x, int cluster_y, int threads, int bytes,
                cudaStream_t stream) {
    config = {};
    config.gridDim = grid;
    config.blockDim = dim3(threads);
    config.dynamicSmemBytes = static_cast<size_t>(bytes);
    config.stream = stream;
    attribute.id = cudaLaunchAttributeClusterDimension;
    attribute.val.clusterDim.x = static_cast<unsigned>(cluster_x);
    attribute.val.clusterDim.y = static_cast<unsigned>(cluster_y);
    attribute.val.clusterDim.z = 1;
    config.attrs = &attribute;
    config.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;  // config.attrs points into this object
};

// Lets `kernel` take `bytes` of dynamic shared memory and, for clusters of
// more than 8 blocks (non-portable), the cluster size. Clears and returns
// the runtime's error.
template <class Kernel>
cudaError_t prepare_cluster_kernel(Kernel kernel, int bytes, int cluster_blocks) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && cluster_blocks > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err != cudaSuccess) cudaGetLastError();  // not reported by a later launch
  return err;
}

// Clusters of a launch configuration that the card holds at once
// (cudaOccupancyMaxActiveClusters), 0 where none fits, or -1 - error where
// the runtime refuses.
template <class Kernel>
int max_active_clusters(Kernel kernel, const ClusterLaunch& launch) {
  const int blocks = static_cast<int>(launch.attribute.val.clusterDim.x *
                                      launch.attribute.val.clusterDim.y);
  cudaError_t err = prepare_cluster_kernel(kernel, static_cast<int>(launch.config.dynamicSmemBytes),
                                           blocks);
  int clusters = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &launch.config);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err == cudaErrorInvalidValue || err == cudaErrorInvalidClusterSize
               ? 0
               : -1 - static_cast<int>(err);
  }
  return clusters;
}

}  // namespace nst
