// CG1 mEVP subcycles on Hopper by ghost-zone tiles: H subcycles per launch.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_tiled.py::mevp_subcycles_tiled, which
// runs H subcycles per round on a halo'd block in VMEM and writes back the
// interior. Here one thread block owns a T x T tile of the grid and loads
// the w x w window (w = T + 2H) around it of the five state planes (u, v,
// s11, s22, s12) into shared memory. It runs min(H, remaining) subcycles on
// the window, each one a stress phase over the elements that are still
// valid, a barrier, a velocity phase over the nodes, and a barrier. Each
// subcycle invalidates one ring of the window on either side (elements
// [sub, w - 1 - sub), nodes [sub + 1, w - 1 - sub) along each axis), so
// after H subcycles the T x T interior is exact, and only the interior is
// written back.
//
// Fixed cell ownership. The block's threads cover the window `rows` rows at
// a time (rows = threads / w, the threads beyond rows x w idle): thread t
// owns column b = t mod w of rows a0, a0 + rows, ... (a0 = t / w), at most
// kTiledMaxCells (8) of them, for the whole launch. Its column's ring
// limits and domain test are worked out once per launch; per cell, phase
// and subcycle what remains is the row's. Consecutive threads hold
// consecutive cells of a row (coalesced loads, no bank conflicts); when w
// is a multiple of 32 a warp lies in one row, and the rows a subcycle's
// ring leaves out are whole warps that skip.
//
// c_w and inv_drag in registers. The velocity phase at node c reads only
// the c_w and inv_drag that the stress phase of the same subcycle wrote at
// element c, and the same thread owns both, so each thread keeps them in
// two arrays of 8 registers (the loop over its cells unrolled): the
// window holds 5 planes, not 7. A window 64 wide then takes 80 KB, and two
// blocks of 512 threads share an SM (at most 64 registers a thread).
// The momentum form is a template argument (mevp_body.cuh): the adaptive
// form keeps each cell's beta in a third array of registers, the weighted
// one reads a_node, a const plane like the others (the window stays at 5
// planes in every form).
//
// The per-step constant planes (7 on a uniform mesh, 12 with the metric
// planes of a graded or spherical one) are read-only for the launch and
// are read through the read-only path where they are used, from L1/L2;
// staging the 7 uniform ones in shared memory once per launch was measured
// slower (it leaves two blocks an SM only windows 48 wide; PERF.md).
//
// Blocks run in parallel and in no order, so a launch reads one set of
// state planes and writes another (ping-pong on the host): nothing is
// updated in place, and there is no cross-round prefetch or deferred
// write-back as in the TPU kernel's sequential grid.
//
// Walls: a load outside the domain is a zero, in every plane, exactly as
// at() in common.cuh. Cells outside the domain are never updated, so they
// stay zero, which is what the grid-wide kernels of mevp.cu read there;
// nx and ny need not be multiples of T, nor N of H. On a periodic axis (the
// periodic instances, kWrap, compiled in mevp_tiled_periodic.cu, on the
// launch's `wrap` axes) no window cell is outside: each loads and computes
// as its wrapped domain cell, and the metric planes are read at wrapped
// indices; only the tile's own cells are written back. The kernel template
// lives in mevp_tiled.cuh.
//
// Each element and node runs mevp_stress_body and mevp_velocity_body of
// mevp_body.cuh, the bodies of mevp.cu's two kernels, with the same
// arguments in the same order under --fmad=false, so this schedule equals
// K1's bit for bit. rdma_band (mevp_rdma.cu) runs the same bodies with the
// same arguments on fewer cells (the cone of its patch, not the whole
// window), and the cells it keeps equal this schedule's bit for bit too.
//
// What bounds it on the H100: the grid-wide schedule moves ~116 bytes per
// element per subcycle (mevp.cu); at 1024^2 its ~56 MB working set is more
// than the 50 MB L2, so 200 launches per step stream from HBM. Here a
// launch reads the state once per H subcycles (5 planes in, 5 out, plus
// the consts), so the bound moves to the arithmetic of the window,
// ((T + 2H)/T)^2 times the interior's work in the first subcycle of a
// round, shrinking ring by ring, and to how well the SM hides the latency
// of its barriers, const loads, divides and square roots. The tile, halo
// and threads are launch parameters (shared memory is sized at launch),
// chosen per grid size by measurement (mevp_tiled_cuda.py). The 80-wide
// window of the smaller grids has a kernel of its own with the width a
// compile-time constant, 2-7% faster on the H100 than the generic width;
// the 64-wide one of the large grids gained 0-2% and runs the generic one
// (PERF.md).
#include <cstring>

#include "mevp_tiled.cuh"

namespace nst {

// The kernel of a launch configuration, momentum form and periodic form
// (wrap != 0), or null where it has none: fewer threads than a window row,
// more than 8 window rows a thread, or an unknown form.
TiledKernel tiled_kernel(bool metric, int form, int tile, int halo, int threads, int wrap = 0) {
  const int w = tile + 2 * halo;
  if (tile < 1 || halo < 1 || threads < 32 || threads > kTiledMaxThreads || w > threads) {
    return nullptr;
  }
  const int rows = threads / w;
  if ((w + rows - 1) / rows > kTiledMaxCells) return nullptr;
  return wrap ? tiled_kernel_periodic(metric, form, w) : tiled_kernel_of_form<false>(metric, form, w);
}

}  // namespace nst

extern "C" {

int nst_mevp_tiled_shared_bytes(int tile, int halo) {
  const int w = tile + 2 * halo;
  return nst::kTiledStatePlanes * w * w * static_cast<int>(sizeof(float));
}

// Resident blocks per SM of a launch configuration (0 where it has no
// kernel or does not fit), from cudaOccupancyMaxActiveBlocksPerMultiprocessor;
// -1 - error where the runtime refuses.
int nst_mevp_tiled_max_blocks(int tile, int halo, int threads, int metric, int form, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const auto kernel = nst::tiled_kernel(metric != 0, form, tile, halo, threads);
  if (kernel == nullptr) return 0;
  const int bytes = nst_mevp_tiled_shared_bytes(tile, halo);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  int blocks = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, bytes);
  }
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err == cudaErrorInvalidValue ? 0 : -1 - static_cast<int>(err);
  }
  return blocks;
}

// One round: n_sub (<= halo) subcycles, by blocks of `threads` threads (at
// most 1024, at least one window row, at most 8 window rows each), from the
// *_in planes into the *_out planes, which must not alias them. consts
// points to the 13 const-plane pointers in the order of MevpConsts, the
// metric ones null on a uniform mesh, a_node null outside the weighted
// form; form: the momentum form's bits, and the periodic axes' shifted by
// kFormWrapShift (a periodic axis at least `halo` long). Launches on `stream`, returns
// cudaGetLastError() (or the error of the shared-memory attribute); does
// not synchronise.
int nst_mevp_tiled(const float* u_in, const float* v_in, const float* s11_in,
                   const float* s22_in, const float* s12_in, float* u_out,
                   float* v_out, float* s11_out, float* s22_out, float* s12_out,
                   const void* const* consts, int nx, int ny, int tile, int halo,
                   int n_sub, int threads, int form, const float* scalars, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::MevpConsts k;
  std::memcpy(&k, consts, sizeof(k));
  const int wrap = form >> nst::kFormWrapShift;
  form &= nst::kForms - 1;
  const auto kernel = nst::tiled_kernel(k.inv_dx != nullptr, form, tile, halo, threads, wrap);
  // A periodic axis takes at most its own extent of halo on either side.
  if (kernel == nullptr || halo < n_sub || n_sub < 1 || wrap > (nst::kWrapX | nst::kWrapY) ||
      ((wrap & nst::kWrapX) && halo > nx) || ((wrap & nst::kWrapY) && halo > ny) ||
      ((form & nst::kFormWeighted) != 0) != (k.a_node != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int bytes = nst_mevp_tiled_shared_bytes(tile, halo);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  nst::MevpScalars s;
  std::memcpy(&s, scalars, sizeof(s));
  const dim3 grid((ny + tile - 1) / tile, (nx + tile - 1) / tile);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      u_in, v_in, s11_in, s22_in, s12_in, u_out, v_out, s11_out, s22_out, s12_out,
      k, nx, ny, tile, halo, n_sub, s, wrap);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
