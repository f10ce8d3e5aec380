// One ghost-zone round of CG1 mEVP on a rank block whose halo strips
// travel while the interior computes: the two kernels of the round.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma, which in one
// kernel stages h-wide strips, sends them to the neighbour chips by remote
// DMA, runs n_sub <= h subcycles on the whole local block with zero ghosts
// while they fly, then re-runs the subcycles on the edge bands with the
// received ghosts and patches the block's edge rows and columns (x first;
// the y strips carry the x ghosts, and so the corners, and the y bands
// patch last). On Hopper the transfer is no kernel: it is a device copy on
// the receiving rank's copy stream (parallel/exchange.py), and the interior
// pass is mevp_tiled on the block. What is left is here:
//
//   rdma_stage: packs a rank's send strips, in one launch, into a
//               (2, P, ., .) buffer (lo, hi) of the state's P planes (5;
//               17 in the HO round): along x its first and last h
//               rows; along y its first and last h columns, extended above
//               and below by the x ghosts it received (zeros at a closed
//               global wall), so that the y neighbours receive the corners
//               of their diagonal neighbours.
//   rdma_band:  n_sub subcycles on the two edge bands of one axis (blockIdx.z
//               picks lo or hi), by clusters of blocks along the band's
//               long axis (cluster_window.cuh): a cluster's window spans
//               the band's 3h cells across and cluster x seg cells along
//               it, each block a seg-cell stretch with a one-cell apron
//               along the band. Each block assembles its region in shared
//               memory straight from the round's sources: the rank's
//               pre-round planes (mevp_tiled wrote the interior pass into
//               fresh planes, so these are intact), the received x ghosts
//               and, for the y bands, the received y ghosts; the consts are
//               read by offset from the rank's widened const planes.
//               Nothing is copied per round. It writes only the band's
//               patch rows (x) or columns (y) into the state after the
//               interior pass.
//
// The sources are addressed in the coordinates of the rank's widened block
// E: (nx + 2hx) x (ny + 2hy), the own block at (hx, hy), hx = h when the x
// axis is split over ranks (else 0), hy likewise. An x band is E's rows
// [0, 3h) or [nx - h, nx + 2h) over the own columns; a y band is E's
// columns [0, 3h) or [ny - h, ny + 2h) over all of E's rows. A band is
// closed: a read beyond it is a zero, as in the TPU kernel's band arrays;
// but on a ring (a periodic axis not split over ranks, which the band then
// spans) a read beyond either end along the band wraps to the other.
//
// The forms (mevp_rdma.cuh): the metric round of a rank block of a graded
// or spherical mesh (the 5 metric planes among the widened consts, read by
// offset where they are used), the A-weighted and adaptive subcycle bodies
// of mevp_body.cuh, and the ring along the band, as template arguments
// whose closed uniform instances keep this file's code; the forms are
// compiled in mevp_rdma_forms.cu and mevp_rdma_metric.cu.
//
// The cone. Only the h patch rows (or columns) of a band are written back,
// and after the subcycles that follow subcycle `sub` they depend on the
// nodes of the patch widened by r = n_sub - 1 - sub on either side and on
// the elements widened by r + 1 before it and r after it (a node reads the
// elements at -1 and 0, an element the nodes at 0 and +1). Subcycle `sub`
// computes those cells only, clipped to the band (the host works them out:
// mevp_rdma_cuda.band_cone); at h = n_sub = 16 that is 31 of the band's 48
// rows on average. Cells outside the cone never reach the patch, so the
// patch is what the whole band's subcycles give. Along the band the ring
// argument holds: each subcycle spoils one ring of the cluster's window,
// and the window's interior is exact after n_sub subcycles.
//
// Each element and node runs mevp_stress_body and mevp_velocity_body of
// mevp_body.cuh with the arguments of mevp_tiled, and each value it keeps
// is computed from the same values as there, so a round equals the blocked
// exchange's round (mevp_tiled on the widened block) and the single-device
// schedule bit for bit (n_sub <= h, nx, ny >= 2h). Like mevp_tiled, a
// thread owns fixed cells and keeps their c_w and inv_drag in registers,
// and the region holds 5 planes.
//
// What bounds it on the H100: the arithmetic of the cone (at h = 16 and a
// 2048^2 block ~1M element-subcycles a band), spread over enough blocks to
// reach every SM (the clusters of a pair of bands number ~2 x 2048 /
// (cluster x seg - 2 n_sub)), plus the ring along the band paid once a
// cluster and the 2 n_sub + 1 cluster barriers (~0.8 us each in clusters
// of 16 on the H100, mevp_large --barriers: ~40% of a launch); not the bytes it
// moves (the strips and the patches are ~1% of the state). rdma_stage moves
// 2 x 5 x h x (ny or nx + 2h) floats (2.6 MB for the x strips of a 2048^2
// block at h = 16), one float4 a thread along the rows, and is bound by its
// launch and its wrapper's host path (mevp_rdma_cuda.RoundSources builds
// and checks the round's pointer arrays once).
#include <cstring>

#include "mevp_rdma.cuh"

namespace nst {

// Row r of strip plane k on `side` (0: lo, 1: hi): the source row and the
// strip row it is copied to, `len` floats each. x: own rows [0, h) or
// [nx - h, nx); y: E's rows (the x ghosts above and below the own rows),
// own columns [0, h) or [ny - h, ny).
template <int P>
__device__ __forceinline__ const float* stage_source(const RdmaSourcesT<P>& src, int axis, int side,
                                                     int k, int r) {
  const float* own = src.own[0];
#pragma unroll
  for (int p = 1; p < P; ++p) own = k == p ? src.own[p] : own;
  if (axis == 0) return own + (r + (side ? src.nx - src.h : 0)) * src.ny;
  const int col = side ? src.ny - src.h : 0;
  const int ir = r - src.hx;
  if (ir < 0) return src.gx_lo + (k * src.h + r) * src.ny + col;
  if (ir >= src.nx) return src.gx_hi + (k * src.h + ir - src.nx) * src.ny + col;
  return own + ir * src.ny + col;
}

// A 3-D grid: z = side x plane (2P), y x blockDim.y = strip rows, x x
// blockDim.x = the row's floats (kVec: float4s). No division by a run-time
// value. P: the state's planes, 5 (CG1) or 17 (HO).
template <int P, bool kVec>
__global__ void __launch_bounds__(kRdmaMaxThreads)
rdma_stage_kernel(RdmaSourcesT<P> src, int axis, int rows, int len, float* __restrict__ out) {
  const int r = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.z;
  const int side = z / P, k = z - side * P;
  if (r >= rows || x >= (kVec ? len / 4 : len)) return;
  const float* from = stage_source(src, axis, side, k, r);
  float* to = out + (z * rows + r) * len;
  if (kVec) {
    reinterpret_cast<float4*>(to)[x] = __ldg(reinterpret_cast<const float4*>(from) + x);
  } else {
    to[x] = from[x];
  }
}

// The send strips of `axis` of a state of P planes into out (see
// nst_rdma_stage).
template <int P>
int rdma_stage_launch(const void* const* sources, const int* dims, int axis, float* out,
                      cudaStream_t stream) {
  RdmaSourcesT<P> src;
  rdma_sources_of(sources, dims, src);
  if (src.h < 1 || (axis != 0 && axis != 1) || (axis == 0 && src.hx != src.h) ||
      (axis == 1 && src.hy != src.h)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = axis == 0 ? src.h : src.nx + 2 * src.hx;
  const int len = axis == 0 ? src.ny : src.h;
  bool vec = src.ny % 4 == 0 && src.h % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  for (int p = 0; p < P + 4; ++p) vec = vec && reinterpret_cast<uintptr_t>(sources[p]) % 16 == 0;
  const int per_row = vec ? len / 4 : len;
  // Up to 256 threads along a row (a power of two), the rest of a
  // 256-thread block over rows.
  int bx = 1;
  while (bx < per_row && bx < 256) bx *= 2;
  const dim3 block(bx, 256 / bx);
  const dim3 grid((per_row + bx - 1) / bx, (rows + block.y - 1) / block.y, 2 * P);
  if (vec) {
    rdma_stage_kernel<P, true><<<grid, block, 0, stream>>>(src, axis, rows, len, out);
  } else {
    rdma_stage_kernel<P, false><<<grid, block, 0, stream>>>(src, axis, rows, len, out);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel of a band axis, block size and form: the closed uniform
// instances here (up to kRdmaBandThreads threads under that launch bound,
// more under kRdmaMaxThreads), the others in mevp_rdma_forms.cu and
// mevp_rdma_metric.cu; null where there is none.
RdmaBandKernel rdma_band_of(int long_axis, int threads, bool metric = false, int form = 0,
                            bool wrap = false) {
  if (metric) return rdma_band_metric_of(long_axis, threads, form, wrap);
  if (form != 0 || wrap) return rdma_band_forms_of(long_axis, threads, form, wrap);
  return rdma_band_select<false, 0, false>(long_axis, threads);
}

// Whether the kernel takes clusters of `cluster` blocks of `threads`, each
// `seg` cells along a band `across` cells wide: a thread owns one position
// along the band and at most 4 cells across it.
bool rdma_band_valid(int across, int cluster, int seg, int threads) {
  if (cluster < 1 || cluster > kRdmaMaxClusterBlocks || seg < 1 || seg > 1000 || across < 2 ||
      threads < 32 || threads > kRdmaMaxThreads) {
    return false;
  }
  const int stride = threads / seg;
  return stride >= 1 && (across + stride - 1) / stride <= kRdmaMaxCells;
}

}  // namespace nst

extern "C" {

// sources: P + 4 pointers (the P pre-round planes, gx_lo, gx_hi, gy_lo,
// gy_hi; the ghosts of an axis that is not split are null); dims: nx, ny,
// h, hx, hy and P, the state's planes: 5 (CG1) or 17 (HO, in the order of
// coupled_cuda.ho_flatten). The send strips of `axis` into out: (2, P, h,
// ny) for x, (2, P, nx + 2hx, h) for y, in 16-byte vectors where every
// row starts 16-byte aligned. Returns cudaGetLastError(); does not
// synchronise.
int nst_rdma_stage(const void* const* sources, const int* dims, int axis, float* out,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (dims[5]) {
    case nst::kRdmaPlanes: return nst::rdma_stage_launch<nst::kRdmaPlanes>(sources, dims, axis, out, s);
    case nst::kRdmaHoPlanes:
      return nst::rdma_stage_launch<nst::kRdmaHoPlanes>(sources, dims, axis, out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Clusters of `cluster` rdma_band blocks of `threads` threads, each `seg`
// cells along a band of `axis` (0: x, 1: y) that is `across` cells wide,
// that the card holds at once (cudaOccupancyMaxActiveClusters; 0 where the
// kernel takes no such clusters or none fits; -1 - error where the runtime
// refuses).
int nst_rdma_band_max_clusters(int axis, int across, int cluster, int seg, int threads,
                               int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const int long_axis = axis == 0 ? 1 : 0;
  if (!nst::rdma_band_valid(across, cluster, seg, threads)) return 0;
  const int bytes = nst::rdma_band_shared_bytes(nst::kRdmaPlanes, long_axis, across, seg);
  const nst::ClusterLaunch launch(dim3(cluster, 1, 2), cluster, 1, threads, bytes, nullptr);
  return nst::max_active_clusters(nst::rdma_band_of(long_axis, threads), launch);
}

// n_sub subcycles on the two bands of `axis` (0: x, 1: y) and their patches
// into the 5 state planes `state` (the interior pass's output), by
// n_clusters clusters a band of `cluster` blocks of `threads` threads, each
// `seg` cells along the band; cone: n_sub x 8 ints, the patch's cone per
// subcycle (RdmaCone). consts: the 13 widened const-plane pointers in
// MevpConsts order (the metric ones null on a uniform mesh, a_node null
// but in the weighted form), row length ld = ny + 2hy. metric: the metric
// round; form: the momentum form's bits and, shifted by kFormWrapShift,
// the periodic axis along the band (kWrapY for the x bands, kWrapX for
// the y bands: an axis not split over ranks; the forms take blocks of at
// most kRdmaBandThreads). Returns the CUDA error of the launch or its
// attributes; does not synchronise.
int nst_rdma_band(const void* const* sources, const int* dims, int axis,
                  const void* const* consts, int cluster, int seg, int threads, int n_clusters,
                  const int* cone, int n_sub, void* const* state, const float* scalars,
                  int metric, int form, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::RdmaSources src;
  const bool planes = nst::rdma_sources_of(sources, dims, src);
  const int h = src.h;
  if (!planes || n_sub < 1 || n_sub > h || n_sub > nst::kRdmaMaxSub || (axis != 0 && axis != 1) ||
      (axis == 0 && (src.hx != h || src.nx < 2 * h)) ||
      (axis == 1 && (src.hy != h || src.ny < 2 * h))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const nst::RdmaBands bands = nst::rdma_bands(src, axis);
  const int across = bands.long_axis ? bands.rows : bands.cols;
  const int along = bands.long_axis ? bands.cols : bands.rows;
  const int wrap = form >> nst::kFormWrapShift;
  const int wrap_along = axis == 0 ? nst::kWrapY : nst::kWrapX;
  // A ring along the band needs an axis that is not split (its ghosts
  // would be the wrap); across the band nothing wraps.
  const bool wraps = wrap == wrap_along;
  if (form < 0 || (wrap != 0 && !wraps) || (wraps && (axis == 0 ? src.hy : src.hx) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = nst::rdma_band_of(bands.long_axis, threads, metric != 0,
                                        form & ((1 << nst::kFormWrapShift) - 1), wraps);
  if (kernel == nullptr || !nst::rdma_band_valid(across, cluster, seg, threads) ||
      cluster * seg <= 2 * n_sub || n_clusters < 1 ||
      static_cast<long>(n_clusters) * (cluster * seg - 2 * n_sub) < along ||
      !nst::rdma_cone_valid(cone, n_sub, bands, wraps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::RdmaCone cn = {};
  std::memcpy(cn.r, cone, static_cast<size_t>(n_sub) * sizeof(cn.r[0]));
  nst::MevpConsts k = {};
  std::memcpy(&k, consts, nst::kMevpConstPlanes * sizeof(const float*));
  nst::MevpScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  const int bytes = nst::rdma_band_shared_bytes(nst::kRdmaPlanes, bands.long_axis, across, seg);
  err = nst::prepare_cluster_kernel(kernel, bytes, cluster);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* const* out = reinterpret_cast<float* const*>(state);
  const int ld = src.ny + 2 * src.hy;
  const nst::ClusterLaunch launch(dim3(n_clusters * cluster, 1, 2), cluster, 1, threads, bytes,
                                  static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.config, kernel, src, bands, k, ld, seg, n_sub, cn, out[0],
                           out[1], out[2], out[3], out[4], s);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
