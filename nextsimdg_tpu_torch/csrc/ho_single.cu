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
// Between the halves only the tile's edge crosses to another SM. The stress
// half at element (i, j) reads the velocity at node indices i..i+1,
// j..j+1 (ho_gather), so the velocity of a tile's first row and column is
// read by the tiles before it along i, along j and diagonally; the velocity
// half at node index (i, j) reads the stresses of elements i-1..i, j-1..j
// (ho_node_forces), so a tile's last row and column of stresses is read by
// the tiles after it. The thread that computes an edge cell writes it at
// once to the tile's slot of a global exchange buffer, each value in one
// 64-bit word with the number of the half beside it (a relaxed store: the
// word is written whole or not at all). After its half a thread copies its
// share of the apron from the neighbours' slots, each word polled until it
// carries the half's number, and one block barrier ends the half. So a
// block waits on exactly the values it reads, from its three neighbours
// only, and pays no fence, no flag and no barrier over the grid: one trip
// through L2 per half. (The host zeroes the buffer before each launch; the
// halves are numbered from 1.) Swapping after grid.sync() instead took
// 2.5x as long an exchange and a launch 34% longer at 256^2
// (ho_single_sync_kernel, benchmarks.mevp_large --barriers; PERF.md).
//
// A value needs no fence: it travels in the same word as its half number,
// and a poll takes only the word of the half it waits for. Reusing a slot
// needs none either. A slot is written again only after its readers have
// copied it: a tile writes its stress edge of subcycle s + 1 after it has
// read the velocity edge of subcycle s of the tiles that read its stresses,
// which they write after they have read them; likewise for the velocity
// edge. Each link of that chain is a store that follows, in program order
// and after a block barrier, a poll loop that has exited. So a reader could
// see the next half's word in its slot only if a store became visible
// before the loads that its execution depends on had returned: the load
// buffering that the PTX ISA's memory consistency model rules out by its
// "No Thin Air" axiom (section "Memory Consistency Model", "Axioms"; the
// poll loop is a control dependency from the load to every later store).
// Should that ever fail, a reader would spin, never read a wrong value. In
// place on the state is safe for the same reason: the tiles that load a
// tile's first row and column into their apron at the start read its
// stress edge of the first subcycle before it writes anything back.
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
#include <cuda/atomic>

#include <cstring>

#include "ho_body.cuh"

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

// Where a block sits in the tile grid, and its three neighbours after it
// (dir = 1: +i, +j, +i+j) or before it (dir = -1).
struct HoTile {
  int ti, tj, tiles_i, tiles_j;
  __device__ __forceinline__ int neighbour(int n, int dir) const {
    const int di = n == 1 ? 0 : dir, dj = n == 0 ? 0 : dir;
    const int i = ti + di, j = tj + dj;
    return i >= 0 && i < tiles_i && j >= 0 && j < tiles_j ? i * tiles_j + j : -1;
  }
};

__device__ __forceinline__ HoTile ho_tile(int tiles_j) {
  const int b = static_cast<int>(blockIdx.x);
  return {b / tiles_j, b % tiles_j, static_cast<int>(gridDim.x) / tiles_j, tiles_j};
}

// The exchange: edge cell e of plane p of a tile's slot, as one 64-bit word
// of the value and the number of the half (1, 2, ...) that wrote it.
__device__ __forceinline__ void ho_publish(unsigned long long* slot, int edge, int p, int e,
                                           float value, int half) {
  const unsigned long long word =
      static_cast<unsigned long long>(static_cast<unsigned>(half)) << 32 | __float_as_uint(value);
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(slot[p * edge + e])
      .store(word, cuda::memory_order_relaxed);
}

// The value of that word once the half `half` has written it.
__device__ __forceinline__ float ho_take(unsigned long long* slot, int edge, int p, int e,
                                         int half) {
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device> word(slot[p * edge + e]);
  unsigned long long w;
  do {
    w = word.load(cuda::memory_order_relaxed);
  } while (static_cast<int>(w >> 32) != half);
  return __uint_as_float(static_cast<unsigned>(w));
}

// A block's view of its tile: TR x TC cells from (i0, j0), at cell(r, c) of
// each shared plane for r in [-1, TR], c in [-1, TC] (the tile and its
// apron), and the exchange slots.
struct HoTileView {
  HoTile tile;
  int tr, tc, i0, j0, nx, ny, pitch, edge;
  unsigned long long* exchange;
  __device__ __forceinline__ int cell(int r, int c) const { return (r + 1) * pitch + (c + 1); }
  __device__ __forceinline__ unsigned long long* slot(int b) const {
    return exchange + static_cast<long>(b) * kHoStatePlanes * edge;
  }
  __device__ __forceinline__ bool inside(int r, int c) const {
    const int i = i0 + r, j = j0 + c;
    return i >= 0 && i < nx && j >= 0 && j < ny;
  }
  // Publish planes [p0, p1) of cell (r, c), values[p - p0], for the half:
  // on the last row (dir 1, the stress half) or the first (dir -1, the
  // velocity half) at e = c, on the last or first column at e = TC + r.
  __device__ __forceinline__ void publish(int r, int c, int dir, int p0, int p1,
                                          const float* values, int half) const {
    const int line_r = dir > 0 ? tr - 1 : 0, line_c = dir > 0 ? tc - 1 : 0;
    unsigned long long* mine = slot(static_cast<int>(blockIdx.x));
#pragma unroll
    for (int p = p0; p < p1; ++p) {
      if (r == line_r) ho_publish(mine, edge, p, c, values[p - p0], half);
      if (c == line_c) ho_publish(mine, edge, p, tc + r, values[p - p0], half);
    }
  }
  // Word x of the half's apron copy: plane p0 + x / (TR + TC + 1) at apron
  // cell k = x % (TR + TC + 1) (k < TC: along the apron row, k < TR + TC:
  // down the apron column, TR + TC: the corner), from the neighbour that
  // wrote it: dir -1, the stresses of the tiles before (row and column -1);
  // dir 1, the velocities of the tiles after (row TR, column TC). Cells
  // beyond the domain stay zero; nobody writes them. One word a thread, so
  // that a block's polls are in flight together.
  __device__ __forceinline__ void take(float* smem, int plane, int x, int dir, int p0,
                                       int half) const {
    const int p = p0 + x / (edge + 1), k = x % (edge + 1);
    const int n = k < tc ? 0 : k < edge ? 1 : 2;
    const int r = k < tc ? (dir < 0 ? -1 : tr) : k < edge ? k - tc : (dir < 0 ? -1 : tr);
    const int c = k < tc ? k : k < edge ? (dir < 0 ? -1 : tc) : (dir < 0 ? -1 : tc);
    if (!inside(r, c)) return;
    const int from = k < edge ? k : (dir < 0 ? tc - 1 : 0);
    smem[p * plane + cell(r, c)] = ho_take(slot(tile.neighbour(n, dir)), edge, p, from, half);
  }
};

template <bool kConstsShared>
__global__ void __launch_bounds__(kHoSingleMaxThreads, 1) ho_single_kernel(HoSingleArgs a) {
  extern __shared__ float smem[];
  HoTileView t;
  t.tile = ho_tile(a.tiles_j);
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
  HoTileView t;
  t.tile = ho_tile(tiles_j);
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

// One cooperative launch of `kernel` over `blocks` blocks of `threads`
// threads with `bytes` of dynamic shared memory; the error of the launch or
// of its attribute (a grid that cannot be resident is refused).
cudaError_t ho_single_launch(const void* kernel, int blocks, int threads, int bytes, void** args,
                             cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args, bytes, stream);
  }
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
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
  cudaError_t err = cudaSetDevice(device);
  const auto kernel = reinterpret_cast<const void*>(nst::ho_single_of(consts_shared));
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, bytes);
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return -static_cast<int>(err);
  }
  return per_sm * sms;
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
  return static_cast<int>(nst::ho_single_launch(
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
  return static_cast<int>(nst::ho_single_launch(kernel, tiles_i * tiles_j, threads, bytes, args,
                                                static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
