// Higher-order (CG2/dG1) mEVP subcycles on Hopper in one call: a cooperative
// kernel whose tiles stay resident in shared memory for all N subcycles.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py::ho_subcycles_pallas,
// which runs all N HO subcycles in one call with the 17 state planes (4 + 4
// CG2 velocity planes, 3 x 3 dG1 stress coefficients) and the 29 uniform
// const planes resident in one core's VMEM. One SM's shared memory holds
// far less than a 256^2 plane, but the 132 SMs together hold the 17 state
// planes up to ~640^2. So the grid is cut into at most one tile of
// TR x TC elements per SM, and block b of one cooperative launch (every
// block resident, so a block may wait on another) owns tile b:
//
//   it loads its tile's 17 state planes into shared memory once, with a
//       one-cell apron, and, where they fit beside them, its 29 const
//       planes (else the consts are read from global memory, through __ldg);
//   each subcycle it runs the stress half on its elements (ho_stress_body
//       of ho_body.cuh), then the velocity half on its node indices
//       (ho_velocity_update), out of shared memory;
//   it writes its 17 planes back once, at the end.
//
// Between the halves only the tile's edge crosses to another SM, through
// words that carry the number of the half that wrote them, polled by the
// three neighbours that read them (tile_exchange.cuh, shared with
// mevp_single.cu; its notes say why no fence is needed). Swapping
// after grid.sync() instead took 2.5x as long an exchange and a launch 34%
// longer at 256^2 (ho_single_sync_kernel, benchmarks.mevp_large --barriers;
// PERF.md).
//
// Each element and node index runs the bodies of ho_body.cuh, as ho_tiled.cu
// does, with the same --fmad=false, so the two schedules agree bit for bit.
//
// What bounds it on the H100: the ~900 float32 operations per element and
// subcycle, one element or node index per thread and half (at 256^2, 128
// tiles of 16 x 32 and 512 threads a block), and the latency of the edge
// exchange, twice a subcycle. The state never leaves the SMs during the
// launch: HBM sees the 17 state planes and the 29 consts once.
//
// Forms (template arguments of ho_single_kernel, ho_single.cuh): the
// A-weighted stress reads four more const planes, a_{k} (33 in all, in
// shared memory where they fit), and weights the ocean drag by them; the
// periodic form's tiles form a ring on the launch's periodic axes
// (TileView<17, true>: the apron beyond the last tile is the first tile's
// edge), the tiles dividing such an axis exactly. Their instances are
// compiled in ho_single_forms.cu, so that the closed unweighted ones here
// keep their code. On a graded or spherical mesh (the metric form) the
// element widths are four more const planes (33, or 37 A-weighted), in
// shared memory with the others where they fit; a force reads each
// neighbour element's widths (a neighbour tile's from global memory). Its
// instances are compiled in ho_single_metric.cu.
#include "ho_single.cuh"

namespace nst {

// n_barriers exchanges in a row over the tile grid and nothing else: each
// half, the edge threads write one word a cell of a TR x TC tile's edge,
// then every block copies its apron words from its three neighbours
// (alternating direction, as the halves do) and ends with a block barrier
// (kGridSync: grid.sync() between the two, the swap that ho_single_kernel
// was measured against). What the exchange costs (benchmarks.mevp_large
// --barriers).
template <bool kGridSync>
__global__ void __launch_bounds__(kHoSingleMaxThreads, 1)
ho_single_sync_kernel(unsigned long long* exchange, int tile_r, int tile_c, int tiles_j,
                      int n_barriers) {
  extern __shared__ float smem[];
  TileView<kHoStatePlanes> t;
  t.tile = tile_of_block(tiles_j);
  t.tr = tile_r;
  t.tc = tile_c;
  t.i0 = t.tile.ti * t.tr;
  t.j0 = t.tile.tj * t.tc;
  t.nx = t.tile.tiles_i * t.tr;
  t.ny = tiles_j * t.tc;
  t.pitch = t.tc + 2;
  t.edge = t.tr + t.tc;
  t.exchange = exchange;
  const int plane = (t.tr + 2) * t.pitch;
  const float one = 1.0f;
  for (int h = 1; h <= n_barriers; ++h) {
    const int dir = h % 2 ? 1 : -1;  // the stress half writes its last row and column
    const int p = h % 2 ? kHoS11 : 0;
    for (int x = threadIdx.x; x < t.edge; x += blockDim.x) {
      const int r = x < t.tc ? (dir > 0 ? t.tr - 1 : 0) : x - t.tc;
      const int c = x < t.tc ? x : (dir > 0 ? t.tc - 1 : 0);
      t.publish(r, c, dir, p, p + 1, &one, h);
    }
    if (kGridSync) cg::this_grid().sync();
    for (int x = threadIdx.x; x <= t.edge; x += blockDim.x) t.take(smem, plane, x, -dir, p, h);
    __syncthreads();
  }
}

HoSingleKernel ho_single_of(bool consts_shared, int form) {
  if ((form & kHoMetric) != 0) return ho_single_metric_of(consts_shared, form);
  if (form != 0) return ho_single_forms_of(consts_shared, form);
  return consts_shared ? ho_single_kernel<true, 0, false> : ho_single_kernel<false, 0, false>;
}

int ho_single_state_bytes(int tile_r, int tile_c) { return ho_single_bytes(tile_r, tile_c, false, 0); }

}  // namespace nst

extern "C" {

int nst_ho_n_table_floats() { return static_cast<int>(sizeof(nst::HoTables) / sizeof(float)); }

int nst_ho_n_scalars() { return static_cast<int>(sizeof(nst::HoScalars) / sizeof(float)); }

int nst_ho_n_consts() { return static_cast<int>(sizeof(nst::HoConsts) / sizeof(const float*)); }

// Dynamic shared memory of one block: the 17 state planes of a TR x TC tile
// and its apron, and the const planes of the form (29, 4 more with
// kHoWeighted and 4 more with kHoMetric) where consts_shared.
int nst_ho_single_shared_bytes(int tile_r, int tile_c, int consts_shared, int form) {
  return nst::ho_single_bytes(tile_r, tile_c, consts_shared != 0, form);
}

// Blocks of ho_single (the instance of consts_shared and form) with
// `threads` threads and `bytes` of shared memory that can be resident at
// once on `device`: the most tiles a launch takes. Minus a CUDA error code
// where the runtime refuses or there is no such instance.
int nst_ho_single_max_blocks(int consts_shared, int form, int threads, int bytes, int device) {
  const auto kernel = nst::ho_single_of(consts_shared != 0, form);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return nst::cooperative_max_blocks(reinterpret_cast<const void*>(kernel), threads, bytes, device);
}

// n_sub >= 1 subcycles in place on the (17, nx, ny) state, in one
// cooperative launch of one block of `threads` threads (at most 512) per
// TR x TC tile (tile_r, tile_c), tiles_i x tiles_j of them covering the
// grid. exchange: (tiles, 17, TR + TC) 64-bit words, zero. consts points to
// the 37 const-plane pointers in the order of HoConsts, the a_{k} null
// outside the weighted form, the widths null outside the metric form;
// scalars and tables to HoScalars and HoTables. consts_shared keeps the
// consts in shared memory. form: kHoWeighted, kHoMetric, and the periodic
// axes' bits (kWrapX, kWrapY) shifted by kFormWrapShift: the
// tiles must divide a periodic axis exactly, and the tiles along it form a
// ring. A grid larger than can be resident is refused by the launch with an
// error, which is returned; so is any other launch error. Launches on
// `stream`; does not synchronise.
int nst_ho_single(float* state, const void* const* consts, unsigned long long* exchange, int nx,
                  int ny, int n_sub, int tile_r, int tile_c, int tiles_i, int tiles_j,
                  int threads, int consts_shared, int form, const float* scalars,
                  const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wrap = form >> nst::kFormWrapShift;
  if (wrap > (nst::kWrapX | nst::kWrapY) || ((wrap & nst::kWrapX) && nx % tile_r != 0) ||
      ((wrap & nst::kWrapY) && ny % tile_c != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nx < 1 || ny < 1 || n_sub < 1 || tile_r < 1 || tile_c < 1 || tile_r + tile_c > 4096 ||
      tiles_i < 1 || tiles_j < 1 || static_cast<long>(tiles_i) * tile_r < nx ||
      static_cast<long>(tiles_i - 1) * tile_r >= nx || static_cast<long>(tiles_j) * tile_c < ny ||
      static_cast<long>(tiles_j - 1) * tile_c >= ny || threads < 32 ||
      threads > nst::kHoSingleMaxThreads || threads % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::HoSingleArgs a;
  a.state = state;
  a.exchange = exchange;
  std::memcpy(&a.k, consts, sizeof(a.k));
  std::memcpy(&a.s, scalars, sizeof(a.s));
  std::memcpy(&a.t, tables, sizeof(a.t));
  a.nx = nx;
  a.ny = ny;
  a.n_sub = n_sub;
  a.tile_r = tile_r;
  a.tile_c = tile_c;
  a.tiles_j = tiles_j;
  a.wrap = wrap;
  if (((form & nst::kHoWeighted) != 0) != (a.k.a[0] != nullptr) ||
      ((form & nst::kHoMetric) != 0) != (a.k.dx != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = nst::ho_single_of(consts_shared != 0, form);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  return static_cast<int>(nst::cooperative_launch(
      reinterpret_cast<const void*>(kernel), tiles_i * tiles_j, threads,
      nst_ho_single_shared_bytes(tile_r, tile_c, consts_shared, form), args,
      static_cast<cudaStream_t>(stream)));
}

// One launch of n_barriers exchanges (ho_single_sync_kernel; grid_sync: by
// grid.sync()) over tiles_i x tiles_j tiles of TR x TC, blocks of `threads`
// threads holding `bytes` of shared memory each (at least the state planes
// of a tile). exchange: (tiles, 17, TR + TC) 64-bit words, zero. Returns the
// CUDA error of the launch; does not synchronise.
int nst_ho_single_syncs(unsigned long long* exchange, int tile_r, int tile_c, int tiles_i,
                        int tiles_j, int threads, int bytes, int n_barriers, int grid_sync,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile_r < 1 || tile_c < 1 || tiles_i < 1 || tiles_j < 1 || threads < 32 ||
      threads > nst::kHoSingleMaxThreads || bytes < nst::ho_single_state_bytes(tile_r, tile_c) ||
      n_barriers < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  void* args[] = {&exchange, &tile_r, &tile_c, &tiles_j, &n_barriers};
  const auto kernel = grid_sync ? reinterpret_cast<const void*>(nst::ho_single_sync_kernel<true>)
                                : reinterpret_cast<const void*>(nst::ho_single_sync_kernel<false>);
  return static_cast<int>(nst::cooperative_launch(kernel, tiles_i * tiles_j, threads, bytes, args,
                                                static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
