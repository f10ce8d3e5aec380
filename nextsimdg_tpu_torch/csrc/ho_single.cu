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
#include <cooperative_groups.h>

#include <cstring>

#include "ho_body.cuh"
#include "tile_exchange.cuh"

namespace cg = cooperative_groups;

namespace nst {

// 512 threads at one block an SM leave the bodies 128 registers.
constexpr int kHoSingleMaxThreads = 512;

struct HoSingleArgs {
  float* state;                  // (17, nx, ny), updated in place
  unsigned long long* exchange;  // (tiles, 17, TR + TC): each tile's edges, zero at launch
  HoConsts k;
  int nx, ny, n_sub;
  int tile_r, tile_c, tiles_j;  // TR x TC tiles, tiles_j of them along j
  HoScalars s;
  HoTables t;
};

template <bool kConstsShared>
__global__ void __launch_bounds__(kHoSingleMaxThreads, 1) ho_single_kernel(HoSingleArgs a) {
  extern __shared__ float smem[];
  TileView<kHoStatePlanes> t;
  t.tile = tile_of_block(a.tiles_j);
  t.tr = a.tile_r;
  t.tc = a.tile_c;
  t.i0 = t.tile.ti * t.tr;
  t.j0 = t.tile.tj * t.tc;
  t.nx = a.nx;
  t.ny = a.ny;
  t.pitch = t.tc + 2;
  t.edge = t.tr + t.tc;
  t.exchange = a.exchange;
  const int tr = t.tr, tc = t.tc, ny = a.ny, pitch = t.pitch;
  const int plane = (tr + 2) * pitch, owned = tr * tc;
  float* konst = smem + kHoStatePlanes * plane;  // (29, TR, TC) where kConstsShared
  const long gplane = static_cast<long>(a.nx) * ny;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const auto global = [&](int r, int c) { return static_cast<long>(t.i0 + r) * ny + (t.j0 + c); };

  // The load: the tile and its apron at TR and TC, zeros beyond the domain
  // and in the apron at -1 (the stresses there arrive before they are read).
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int x = tid; x < plane; x += n_threads) {
    const int r = region_row(x, inv_pitch) - 1, c = x - (r + 1) * pitch - 1;
    const bool in = r >= 0 && c >= 0 && t.inside(r, c);
    const long ij = global(r, c);
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) smem[p * plane + x] = in ? a.state[p * gplane + ij] : 0.0f;
  }
  const float inv_tc = 1.0f / static_cast<float>(tc);
  if (kConstsShared) {
    for (int x = tid; x < owned; x += n_threads) {
      const int r = region_row(x, inv_tc), c = x - r * tc;
      const bool in = t.inside(r, c);
      const long ij = global(r, c);
      konst[x] = in ? __ldg(a.k.strength + ij) : 0.0f;
#pragma unroll
      for (int q = 0; q < kHoPlaneConsts; ++q) {
#pragma unroll
        for (int p = 0; p < kHoPlanes; ++p) {
          konst[(1 + kHoPlanes * q + p) * owned + x] =
              in ? __ldg(ho_const_plane(a.k, q, p) + ij) : 0.0f;
        }
      }
    }
  }
  __syncthreads();

  for (int sub = 0; sub < a.n_sub; ++sub) {
    // Stress half, element (r, c) of the tile: node indices r..r+1, c..c+1,
    // at TR or TC the apron. The last row and column go to the exchange.
    const int stress_half = 2 * sub + 1;
    for (int x = tid; x < owned; x += n_threads) {
      const int r = region_row(x, inv_tc), c = x - r * tc;
      if (!t.inside(r, c)) continue;
      const int e = t.cell(r, c);
      float u[kHoNodes], v[kHoNodes];
      ho_gather([&](int p, int di, int dj) { return smem[p * plane + e + di * pitch + dj]; }, u);
      ho_gather([&](int p, int di, int dj) { return smem[(kHoPlanes + p) * plane + e + di * pitch + dj]; },
                v);
      float sig[3 * kHoCoeffs];  // s11, s22, s12: planes kHoS11 .. kHoS12 + 2
      float* s11 = sig;
      float* s22 = sig + kHoCoeffs;
      float* s12 = sig + 2 * kHoCoeffs;
#pragma unroll
      for (int q = 0; q < 3 * kHoCoeffs; ++q) sig[q] = smem[(kHoS11 + q) * plane + e];
      const float strength = kConstsShared ? konst[x] : __ldg(a.k.strength + global(r, c));
      ho_stress_body(a.t, a.s, u, v, s11, s22, s12, strength);
#pragma unroll
      for (int q = 0; q < 3 * kHoCoeffs; ++q) smem[(kHoS11 + q) * plane + e] = sig[q];
      t.publish(r, c, 1, kHoS11, kHoStatePlanes, sig, stress_half);
    }
    // The stresses of the tiles before this one into the apron at -1.
    for (int x = tid; x < (t.edge + 1) * 3 * kHoCoeffs; x += n_threads) {
      t.take(smem, plane, x, -1, kHoS11, stress_half);
    }
    __syncthreads();

    // Velocity half, node index (r, c) of the tile: elements r-1..r,
    // c-1..c, at -1 the apron. The first row and column go to the exchange.
    const bool last = sub + 1 == a.n_sub;
    const int velocity_half = 2 * sub + 2;
    for (int x = tid; x < owned; x += n_threads) {
      const int r = region_row(x, inv_tc), c = x - r * tc;
      if (!t.inside(r, c)) continue;
      const int e = t.cell(r, c);
      float uv[2 * kHoPlanes];
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) uv[p] = smem[p * plane + e];
      const auto load = [&](int di, int dj, float* s11, float* s22, float* s12) {
        const int f = e + di * pitch + dj;
#pragma unroll
        for (int q = 0; q < kHoCoeffs; ++q) {
          s11[q] = smem[(kHoS11 + q) * plane + f];
          s22[q] = smem[(kHoS22 + q) * plane + f];
          s12[q] = smem[(kHoS12 + q) * plane + f];
        }
      };
      if (kConstsShared) {
        ho_velocity_update(a.t, a.s,
                           [&](int q, int p) { return konst[(1 + kHoPlanes * q + p) * owned + x]; },
                           load, uv);
      } else {
        ho_velocity_body(a.t, a.s, a.k, global(r, c), load, uv);
      }
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) smem[p * plane + e] = uv[p];
      if (!last) t.publish(r, c, -1, 0, 2 * kHoPlanes, uv, velocity_half);
    }
    if (last) break;
    // The velocities of the tiles after this one into the apron at TR and TC.
    for (int x = tid; x < (t.edge + 1) * 2 * kHoPlanes; x += n_threads) {
      t.take(smem, plane, x, 1, 0, velocity_half);
    }
    __syncthreads();
  }

  // Write the tile back (its cells inside the domain).
  __syncthreads();
  for (int x = tid; x < owned; x += n_threads) {
    const int r = region_row(x, inv_tc), c = x - r * tc;
    if (!t.inside(r, c)) continue;
    const long ij = global(r, c);
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) a.state[p * gplane + ij] = smem[p * plane + t.cell(r, c)];
  }
}

// n_barriers exchanges in a row over the tile grid and nothing else: each
// half, the edge threads write one word a cell of a TR x TC tile's edge,
// then every block copies its apron words from its three neighbours
// (alternating direction, as the halves do) and ends with a block barrier
// (kGridSync: grid.sync() between the two, the swap that the kernel above
// measured against). What the exchange costs (benchmarks.mevp_large
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

using HoSingleKernel = void (*)(HoSingleArgs);

HoSingleKernel ho_single_of(bool consts_shared) {
  return consts_shared ? ho_single_kernel<true> : ho_single_kernel<false>;
}

int ho_single_state_bytes(int tile_r, int tile_c) {
  return kHoStatePlanes * (tile_r + 2) * (tile_c + 2) * static_cast<int>(sizeof(float));
}

}  // namespace nst

extern "C" {

int nst_ho_n_table_floats() { return static_cast<int>(sizeof(nst::HoTables) / sizeof(float)); }

int nst_ho_n_scalars() { return static_cast<int>(sizeof(nst::HoScalars) / sizeof(float)); }

// Dynamic shared memory of one block: the 17 state planes of a TR x TC tile
// and its apron, and the 29 const planes of the tile where consts_shared.
int nst_ho_single_shared_bytes(int tile_r, int tile_c, int consts_shared) {
  return nst::ho_single_state_bytes(tile_r, tile_c) +
         (consts_shared ? nst::kHoConstPlanes * tile_r * tile_c * static_cast<int>(sizeof(float))
                        : 0);
}

// Blocks of ho_single (the variant of consts_shared) with
// `threads` threads and `bytes` of shared memory that can be resident at
// once on `device`: the most tiles a launch takes. Minus a CUDA error code
// where the runtime refuses.
int nst_ho_single_max_blocks(int consts_shared, int threads, int bytes, int device) {
  return nst::cooperative_max_blocks(reinterpret_cast<const void*>(nst::ho_single_of(consts_shared)),
                                     threads, bytes, device);
}

// n_sub >= 1 subcycles in place on the (17, nx, ny) state, in one
// cooperative launch of one block of `threads` threads (at most 512) per
// TR x TC tile (tile_r, tile_c), tiles_i x tiles_j of them covering the
// grid. exchange: (tiles, 17, TR + TC) 64-bit words, zero. consts points to the 29 const-plane pointers in the order of
// HoConsts; scalars and tables to HoScalars and HoTables. consts_shared
// keeps the consts in shared memory. A grid larger than can be resident is refused
// by the launch with an error, which is returned; so is any other launch
// error. Launches on `stream`; does not synchronise.
int nst_ho_single(float* state, const void* const* consts, unsigned long long* exchange, int nx,
                  int ny, int n_sub, int tile_r, int tile_c, int tiles_i, int tiles_j,
                  int threads, int consts_shared, const float* scalars,
                  const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
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
  void* args[] = {&a};
  const auto kernel = reinterpret_cast<const void*>(nst::ho_single_of(consts_shared));
  return static_cast<int>(nst::cooperative_launch(
      kernel, tiles_i * tiles_j, threads, nst_ho_single_shared_bytes(tile_r, tile_c, consts_shared),
      args, static_cast<cudaStream_t>(stream)));
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
