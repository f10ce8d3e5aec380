// The HO (CG2/dG1) form of rdma_band: the band half of an rdma round of the
// higher-order mEVP solver on a rank block.
//
// Replaces, with rdma_stage of mevp_rdma.cu at 17 planes, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma in its HO
// instantiation (nextsimdg_tpu/dynamics/mevp_ho.py::_rdma_subcycles: the
// 17 flattened HO planes and the 29-37 widened const planes). The round is
// the CG1 round's (mevp_rdma.cu), generic over the state's planes: the 17
// state strips travel while the interior pass (ho_tiled or ho_single on
// the rank's own block) computes, then this kernel re-runs the n_sub
// subcycles on the two bands of each axis, x first, and writes their patch
// rows (x) or columns (y) into the 17 planes after the interior pass.
//
// The bands, their coordinates in the rank's widened block E, the cone of
// the patch (mevp_rdma_cuda.band_cone) and the cluster windows along the
// band are the CG1 band's: the HO subcycle reads the same neighbours (an
// element the node indices at 0 and +1 of its four owned planes, a node
// index the elements at -1 and 0), so it spoils one ring a subcycle as
// CG1's does, and the same cone holds the patch's dependence. The bodies
// are ho_body.cuh's (ho_stress_body and ho_velocity_update, with this
// band's accessors); built with --fmad=false like every HO kernel, a round
// equals the blocked schedule's round (ho_tiled or ho_single on the
// widened block) and the single-device step bit for bit.
//
// What bounds it on the H100: the HO arithmetic of the cone (516 + 398
// operations an element and node a subcycle in long dependent chains; at
// h = 16 on a 512^2 block a pair of x bands is ~0.24 G operations), not
// the bytes it moves (a pair of x bands of a 512^2 block reads ~10 MB), so
// its time is the latency of those chains over the warps in flight, plus
// 2 n_sub + 1 cluster barriers of ~0.8 us. The design (the kernel's first
// port ran 96 blocks of 256 threads with three cells a thread and its
// consts read from L2 at every use, 8 warps an SM on fewer SMs than the
// card has, at a 512^2 block):
// - it fills the card: a cluster splits the band across as well as along
//   (pos.nx x pos.ny blocks, up to 16), each block `rows` x seg cells with
//   a one-cell apron on every side that its neighbours fill through
//   distributed shared memory (the diagonal neighbour too), so that a
//   512^2 block's pair of bands runs 224 blocks of 384 threads, two an SM
//   on every SM, a thread a cell of the cone;
// - it stages the consts once a launch: each block copies the 29-37 const
//   planes of its cells and apron into shared memory with the state, by
//   cp.async, and every subcycle reads them from there (kStaged). Where
//   that costs more than it saves, the L2 instances of mevp_rdma_ho_l2.cu
//   read them by offset as before, three blocks an SM: the 2048^2 blocks,
//   whose bands fill the card several times over and run faster with more
//   cells resident an SM, and ghost widths above 16 (above 32 the staged
//   planes do not fit);
// - the launch geometry is the host's (mevp_rdma_cuda.HoBandConfig,
//   HO_BANDS: per block size and h, from benchmarks.mevp_large
//   --tiles=rdma_band_ho on the card). A form with one cluster barrier a
//   subcycle instead of two (the apron's elements recomputed, two copies of
//   the velocities) ran no faster at two blocks an SM and was dropped.
#include <cstring>

#include "mevp_rdma_ho.cuh"

namespace nst {

// The kernel of a band axis and form (kHoWeighted, kHoMetric), the ring
// along the band and where the consts live: the closed unweighted uniform
// staged instances here, the others in mevp_rdma_ho_forms.cu,
// mevp_rdma_ho_metric.cu and mevp_rdma_ho_l2.cu; null where there is none.
RdmaBandHoKernel rdma_band_ho_of(int long_axis, int form, bool wrap, bool staged) {
  if (!staged) return rdma_band_ho_l2_of(long_axis, form, wrap);
  if ((form & kHoMetric) != 0) return rdma_band_ho_metric_of(long_axis, form, wrap);
  if (form != 0 || wrap) return rdma_band_ho_forms_of(long_axis, form, wrap);
  return rdma_band_ho_select<0, false, true>(long_axis);
}

// The cells across the band that one block of a cluster `cluster_across`
// blocks across holds.
int rdma_band_ho_rows(int across, int cluster_across) {
  return (across + cluster_across - 1) / cluster_across;
}

// Whether the kernel takes clusters of cluster_along x cluster_across
// blocks of `threads` (at most the launch bound of the staged or the L2
// instances), each `seg` cells along the band and rdma_band_ho_rows across
// it, every block holding a cell of the band.
bool rdma_band_ho_valid(int across, int cluster_along, int cluster_across, int seg, int threads,
                        bool staged) {
  const int bound = staged ? kRdmaHoThreads : kRdmaHoL2Threads;
  if (cluster_along < 1 || cluster_across < 1 ||
      cluster_along * cluster_across > kRdmaMaxClusterBlocks || seg < 1 || seg > 1000 || across < 2 ||
      cluster_across > across || threads < 32 || threads > bound || threads % 32 != 0) {
    return false;
  }
  const int rows = rdma_band_ho_rows(across, cluster_across);
  return (cluster_across - 1) * rows < across && rows <= 1000;
}

}  // namespace nst

extern "C" {

// Clusters of cluster_along x cluster_across HO band blocks of `threads`
// threads, each `seg` cells along a band of `axis` (0: x, 1: y) that is
// `across` cells wide, of a form (kHoWeighted, kHoMetric) with staged or L2
// consts, that the card holds at once (0 where the kernel takes no such
// clusters or none fits; -1 - error where the runtime refuses).
int nst_rdma_band_ho_max_clusters(int axis, int across, int cluster_along, int cluster_across, int seg,
                                  int threads, int form, int staged, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const int long_axis = axis == 0 ? 1 : 0;
  const auto kernel = nst::rdma_band_ho_of(long_axis, form, false, staged != 0);
  if (kernel == nullptr ||
      !nst::rdma_band_ho_valid(across, cluster_along, cluster_across, seg, threads, staged != 0)) {
    return 0;
  }
  const int bytes = nst::rdma_band_ho_shared_bytes(form, staged != 0,
                                                   nst::rdma_band_ho_rows(across, cluster_across), seg);
  const nst::ClusterLaunch launch(dim3(cluster_along, cluster_across, 2), cluster_along, cluster_across,
                                  threads, bytes, nullptr);
  return nst::max_active_clusters(kernel, launch);
}

// n_sub HO subcycles on the two bands of `axis` (0: x, 1: y) and their
// patches into `state`, the (17, nx, ny) planes of the interior pass's
// output, in the order of coupled_cuda.ho_flatten; sources and dims as
// nst_rdma_stage's, with 17 planes; n_clusters clusters a band of
// cluster_along x cluster_across blocks of `threads` threads, each `seg`
// cells along the band and rdma_band_ho_rows(across, cluster_across)
// across it; staged: the consts copied into shared memory once a launch
// (else read from L2); cone: n_sub x 8 ints (RdmaCone). consts: the 37
// widened const-plane pointers of HoConsts (the a_{k} null but in the
// weighted form, the widths but in the metric form), row length ld = ny +
// 2hy; scalars and tables: HoScalars and HoTables. form: kHoWeighted,
// kHoMetric and, shifted by kFormWrapShift, the periodic axis along the
// band (kWrapY for the x bands, kWrapX for the y bands: an axis not split
// over ranks). Returns the CUDA error of the launch or its attributes; does
// not synchronise.
int nst_rdma_band_ho(const void* const* sources, const int* dims, int axis, const void* const* consts,
                     int cluster_along, int cluster_across, int seg, int threads, int staged,
                     int n_clusters, const int* cone, int n_sub, float* state, const float* scalars,
                     const float* tables, int form, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::RdmaHoSources src;
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
  const bool wraps = wrap == wrap_along;
  const int body = form & ((1 << nst::kFormWrapShift) - 1);
  if (form < 0 || (wrap != 0 && !wraps) || (wraps && (axis == 0 ? src.hy : src.hx) != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = nst::rdma_band_ho_of(bands.long_axis, body, wraps, staged != 0);
  const int window = cluster_along * seg;
  if (kernel == nullptr ||
      !nst::rdma_band_ho_valid(across, cluster_along, cluster_across, seg, threads, staged != 0) ||
      window <= 2 * n_sub || n_clusters < 1 || static_cast<long>(n_clusters) * (window - 2 * n_sub) < along ||
      !nst::rdma_cone_valid(cone, n_sub, bands, wraps)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::RdmaCone cn = {};
  std::memcpy(cn.r, cone, static_cast<size_t>(n_sub) * sizeof(cn.r[0]));
  nst::HoConsts k;
  std::memcpy(&k, consts, sizeof(k));
  if (((body & nst::kHoWeighted) != 0) != (k.a[0] != nullptr) ||
      ((body & nst::kHoMetric) != 0) != (k.dx != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::HoScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  nst::HoTables t;
  std::memcpy(&t, tables, sizeof(t));
  const int rows = nst::rdma_band_ho_rows(across, cluster_across);
  const int bytes = nst::rdma_band_ho_shared_bytes(body, staged != 0, rows, seg);
  err = nst::prepare_cluster_kernel(kernel, bytes, cluster_along * cluster_across);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ld = src.ny + 2 * src.hy;
  const nst::ClusterLaunch launch(dim3(n_clusters * cluster_along, cluster_across, 2), cluster_along,
                                  cluster_across, threads, bytes, static_cast<cudaStream_t>(stream));
  err = cudaLaunchKernelEx(&launch.config, kernel, src, bands, k, ld, seg, rows, n_sub, cn, state, s, t);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
