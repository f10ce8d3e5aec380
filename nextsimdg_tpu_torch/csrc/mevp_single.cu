// CG1 mEVP subcycles on Hopper in one call: a persistent cooperative kernel.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_pallas.py::mevp_subcycles_pallas,
// which runs all N subcycles in one call with the whole grid resident in
// one core's VMEM, over the 5 state planes and the solver's const set (7
// planes on a uniform mesh, 12 with the metric planes of a graded or
// spherical one). A 256^2 float32 plane is already more than an SM's
// shared memory, so the grid cannot be resident in one block. This kernel
// keeps the TPU kernel's contract instead: one call, one launch, all N
// subcycles. It is launched cooperatively with as many blocks as can be
// resident at once, and each subcycle is
//
//   a grid-stride loop over elements: stress_cell (mevp_body.cuh) writes
//       s11, s22, s12 and the node planes c_w, inv_drag in place;
//   grid.sync();
//   a grid-stride loop over nodes: velocity_cell writes u, v in place;
//   grid.sync() (except after the last subcycle).
//
// In place is safe for the same reason as in mevp.cu: each half writes only
// index (i, j) of planes that the same half reads only at (i, j), and reads
// its neighbours only in planes that the other half wrote before the last
// grid.sync(). The state planes and c_w/inv_drag are written during the
// launch by other blocks, so they are read with plain loads, never through
// the read-only (non-coherent) path; grid.sync() orders the writes before
// the reads. Only the const planes go through __ldg.
//
// The element and node code is that of mevp.cu's two kernels
// (stress_cell, velocity_cell) with the same --fmad=false, so this kernel
// equals N subcycles of K1's schedule, and of mevp_tiled.cu, bit for bit.
//
// What bounds it on the H100: the same ~116 bytes per element and subcycle
// as the two-launch schedule. At 512^2 the ~19 live planes (19 MiB) stay
// in the 50 MB L2; at 1024^2 (76 MiB) they stream from HBM, about
// 1024^2 x 116 B / 3.35 TB/s = 36 us per subcycle. What it removes is the
// host: 200 launches per step become one, at the cost of two grid-wide
// barriers per subcycle.
#include <cooperative_groups.h>

#include <cstring>

#include "mevp_body.cuh"

namespace cg = cooperative_groups;

namespace nst {

constexpr int kSingleThreads = kBlockX * kBlockY;  // one 8 x 32 patch per pass

struct SingleArgs {
  MevpState p;
  MevpConsts k;
  int nx, ny, n_sub;
  MevpScalars s;
};

template <bool kMetric>
__global__ void __launch_bounds__(kSingleThreads) mevp_single_kernel(SingleArgs a) {
  cg::grid_group grid = cg::this_grid();
  // The grid is cut into 8 x 32 patches (rows i, contiguous columns j);
  // block b takes patches b, b + gridDim.x, ...
  const int patches_j = (a.ny + kBlockX - 1) / kBlockX;
  const int patches = patches_j * ((a.nx + kBlockY - 1) / kBlockY);
  const int tx = threadIdx.x % kBlockX, ty = threadIdx.x / kBlockX;
  for (int sub = 0; sub < a.n_sub; ++sub) {
    for (int patch = blockIdx.x; patch < patches; patch += gridDim.x) {
      const int pi = patch / patches_j;
      const int i = pi * kBlockY + ty, j = (patch - pi * patches_j) * kBlockX + tx;
      if (i < a.nx && j < a.ny) stress_cell<kMetric>(a.p, a.k, i, j, a.nx, a.ny, a.s);
    }
    grid.sync();
    for (int patch = blockIdx.x; patch < patches; patch += gridDim.x) {
      const int pi = patch / patches_j;
      const int i = pi * kBlockY + ty, j = (patch - pi * patches_j) * kBlockX + tx;
      if (i < a.nx && j < a.ny) velocity_cell<kMetric>(a.p, a.k, i, j, a.nx, a.ny, a.s);
    }
    if (sub + 1 < a.n_sub) grid.sync();
  }
}

inline const void* single_kernel(bool metric) {
  return metric ? reinterpret_cast<const void*>(&mevp_single_kernel<true>)
                : reinterpret_cast<const void*>(&mevp_single_kernel<false>);
}

}  // namespace nst

extern "C" {

// The most blocks of mevp_single that can be resident at once on `device`
// (the cooperative launch's limit), or minus a CUDA error code.
int nst_mevp_single_max_blocks(int metric, int device) {
  cudaError_t err = cudaSetDevice(device);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, nst::single_kernel(metric != 0), nst::kSingleThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

// n_sub >= 1 subcycles in place on u, v, s11, s22, s12 (c_w and inv_drag are
// scratch planes), in one cooperative launch of `blocks` blocks (0: the
// most that can be resident). consts points to the 12 const-plane pointers
// in the order of MevpConsts, the last five null on a uniform mesh. A grid
// larger than the resident limit is refused by the launch with an error,
// which is returned; so is any other launch error. Launches on `stream`;
// does not synchronise.
int nst_mevp_single(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                    float* inv_drag, const void* const* consts, int nx, int ny, int n_sub,
                    int blocks, const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || n_sub < 1 || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::SingleArgs a;
  a.p = {u, v, s11, s22, s12, c_w, inv_drag};
  std::memcpy(&a.k, consts, sizeof(a.k));
  std::memcpy(&a.s, scalars, sizeof(a.s));
  a.nx = nx;
  a.ny = ny;
  a.n_sub = n_sub;
  const bool metric = a.k.inv_dx != nullptr;
  if (blocks == 0) {
    blocks = nst_mevp_single_max_blocks(metric, device);
    if (blocks < 0) return -blocks;
    if (blocks == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const int patches = ((ny + nst::kBlockX - 1) / nst::kBlockX) *
                        ((nx + nst::kBlockY - 1) / nst::kBlockY);
    if (blocks > patches) blocks = patches;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(nst::single_kernel(metric), dim3(blocks),
                                    dim3(nst::kSingleThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
