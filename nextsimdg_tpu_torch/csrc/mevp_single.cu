// CG1 mEVP subcycles on Hopper in one call: a cooperative kernel whose tiles
// stay resident in shared memory for all N subcycles.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_pallas.py::mevp_subcycles_pallas,
// which runs all N subcycles in one call with the whole grid resident in
// one core's VMEM, over the 5 state planes and the solver's const set (7
// planes on a uniform mesh, 12 with the metric planes of a graded or
// spherical one). One SM's shared memory holds far less than a 256^2 plane,
// but the 132 SMs together hold the 5 state planes of a 1024^2 grid. So the
// grid is cut into at most one tile of TR x TC cells per SM, and block b of
// one cooperative launch (every block resident, so a block may wait on
// another) owns tile b (tile_exchange.cuh):
//
//   it loads its tile's 5 state planes (u, v, s11, s22, s12) into shared
//       memory once, with a one-cell apron, and the first const planes of
//       resident_rank's order, as many as fit beside them: all of them up
//       to 600^2, else one or two, else none (the rest are read from global
//       memory, through __ldg);
//   each subcycle it runs the stress half on its elements, then the
//       velocity half on its nodes, out of shared memory; after each half
//       the tile's edge goes to the three neighbours that read it, by words
//       that carry the half's number (tile_exchange.cuh): after the stress
//       half s11, s22, s12 of its last row and column, after the velocity
//       half u, v of its first row and column; a block waits on those words
//       and on nothing else, so there is no grid-wide barrier;
//   it writes its 5 planes back once, at the end.
//
// Fixed cell ownership, as in mevp_tiled.cu: thread t owns column
// c = t mod TC of the tile rows r0, r0 + rows, ... (r0 = t / TC, rows =
// threads / TC), at most kSingleMaxCells of them, both as element (r, c)
// and as node (r, c), for the whole launch. The velocity half at node
// (i, j) reads the c_w and inv_drag that the stress half wrote at element
// (i, j), so they stay in the thread's registers and never reach shared
// memory. An empty asm volatile on each cell's row stops the compiler from
// hoisting the cells' 64-bit const addresses out of the subcycle loop,
// where they spill (2-4x slower in mevp_tiled; PERF.md).
//
// The momentum form is a template argument (mevp_body.cuh): the weighted
// form adds the a_node const plane (last in the resident order, so the
// "all planes" instance of the weighted form keeps 13 or 8 planes), the
// adaptive form each cell's beta in a third array of registers. The kernel
// template lives in mevp_single.cuh; this file instantiates the fixed-alpha
// forms and mevp_single_adaptive.cu the adaptive ones (32 instances in all,
// the longest compile of the library when in one file).
//
// Each element and node runs mevp_stress_body and mevp_velocity_body of
// mevp_body.cuh (forces_uniform, or forces_metric on the weighted stresses)
// with the operands of mevp.cu's stress_cell and velocity_cell, in the same
// order, under the same --fmad=false, so this kernel equals N subcycles of
// K1's schedule, and mevp_tiled, bit for bit. Beyond the domain the apron
// and the cells of a ragged last tile stay zero, which is what at() reads
// there.
//
// What bounds it on the H100: the ~122 float32 operations per element and
// subcycle at one to eight cells a thread, the const planes that do not fit
// beside the state (from L2, or from HBM where the 12 planes of a 1024^2
// spherical grid, 48 MB, outgrow what L2 keeps), and the latency of the edge
// exchange, twice a subcycle. The state never leaves the SMs during the
// launch: HBM sees it once in and once out. The grid-stride kernel this one
// replaced streamed ~116 bytes per element and subcycle through L2 or HBM
// and paid two grid.sync() per subcycle (PERF.md).
#include "mevp_single.cuh"

namespace nst {

inline const void* single_kernel(bool metric, int form, int n_resident, int wrap = 0) {
  if (wrap) return single_kernel_periodic(metric, form, n_resident);
  switch (form) {
    case 0: return single_kernel_of<0>(metric, n_resident);
    case kFormWeighted: return single_kernel_of<kFormWeighted>(metric, n_resident);
    default: return single_kernel_adaptive(metric, form, n_resident);
  }
}

}  // namespace nst

extern "C" {

// Dynamic shared memory of one block: the 5 state planes and n_resident
// const planes of a TR x TC tile, each with its one-cell apron.
int nst_mevp_single_shared_bytes(int tile_r, int tile_c, int n_resident) {
  return (nst::kSinglePlanes + n_resident) * (tile_r + 2) * (tile_c + 2) *
         static_cast<int>(sizeof(float));
}

// Blocks of mevp_single (metric or uniform, in a momentum form) with
// `threads` threads on TR x TC tiles with n_resident const planes in shared
// memory that can be resident at once on `device`: the most tiles a launch
// takes. Minus a CUDA error code where the runtime refuses.
int nst_mevp_single_max_blocks(int metric, int form, int tile_r, int tile_c, int n_resident,
                               int threads, int device) {
  const void* kernel = nst::single_kernel(metric != 0, form, n_resident);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return nst::cooperative_max_blocks(kernel, threads,
                                     nst_mevp_single_shared_bytes(tile_r, tile_c, n_resident), device);
}

// n_sub >= 1 subcycles in place on u, v, s11, s22, s12, in one cooperative
// launch of one block of `threads` threads per TR x TC tile (tile_r,
// tile_c), tiles_i x tiles_j of them covering the grid; each thread owns
// column t mod TC of at most 8 tile rows (threads / TC rows at a time).
// exchange: (tiles, 5, TR + TC) 64-bit words, zero. consts points to the 13
// const-plane pointers in the order of MevpConsts, the metric ones null on
// a uniform mesh, a_node null outside the weighted form; form: the
// momentum form's bits, and the periodic axes' (kWrapX, kWrapY) shifted by
// kFormWrapShift: the tiles must divide a periodic axis exactly, and the
// tiles along it form a ring. slots[p]: the shared-memory plane of const plane p,
// or -1 to read it from global memory: the first 0, 1, 2 or all of the
// planes in the order of resident_rank, at their place in it. A grid larger
// than can be resident is refused by the launch with an error, which is
// returned; so is any other launch error. Launches on `stream`; does not
// synchronise.
int nst_mevp_single(float* u, float* v, float* s11, float* s22, float* s12,
                    unsigned long long* exchange, const void* const* consts, int nx, int ny,
                    int n_sub, int tile_r, int tile_c, int tiles_i, int tiles_j, int threads,
                    int form, const int* slots, const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tile_c >= 1 ? threads / tile_c : 0;
  const int wrap = form >> nst::kFormWrapShift;
  form &= nst::kForms - 1;
  if (wrap > (nst::kWrapX | nst::kWrapY) || ((wrap & nst::kWrapX) && nx % tile_r != 0) ||
      ((wrap & nst::kWrapY) && ny % tile_c != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nx < 1 || ny < 1 || n_sub < 1 || tile_r < 1 || tile_c < 1 || tiles_i < 1 || tiles_j < 1 ||
      static_cast<long>(tiles_i) * tile_r < nx || static_cast<long>(tiles_i - 1) * tile_r >= nx ||
      static_cast<long>(tiles_j) * tile_c < ny || static_cast<long>(tiles_j - 1) * tile_c >= ny ||
      threads < 32 || threads > nst::kSingleMaxThreads || threads % 32 != 0 || rows < 1 ||
      (tile_r + rows - 1) / rows > nst::kSingleMaxCells) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::SingleArgs a;
  float* state[] = {u, v, s11, s22, s12};
  std::memcpy(a.state, state, sizeof(a.state));
  a.exchange = exchange;
  std::memcpy(&a.k, consts, sizeof(a.k));
  std::memcpy(&a.s, scalars, sizeof(a.s));
  a.nx = nx;
  a.ny = ny;
  a.n_sub = n_sub;
  a.tile_r = tile_r;
  a.tile_c = tile_c;
  a.tiles_j = tiles_j;
  a.wrap = wrap;
  const bool metric = a.k.inv_dx != nullptr;
  if (((form & nst::kFormWeighted) != 0) != (a.k.a_node != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // slots must be the first n_resident planes of the kernels' order.
  const int n_resident = static_cast<int>(
      std::count_if(slots, slots + nst::kMevpConstPlanes, [](int slot) { return slot >= 0; }));
  for (int p = 0; p < nst::kMevpConstPlanes; ++p) {
    const int rank = nst::resident_rank(metric, p);
    if (slots[p] != (rank < n_resident ? rank : -1)) return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* kernel = nst::single_kernel(metric, form, n_resident, wrap);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  return static_cast<int>(nst::cooperative_launch(
      kernel, tiles_i * tiles_j, threads,
      nst_mevp_single_shared_bytes(tile_r, tile_c, n_resident), args,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
