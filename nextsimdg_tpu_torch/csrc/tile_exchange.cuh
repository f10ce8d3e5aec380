// Resident tiles of one cooperative launch, and the exchange of their edges.
//
// The single-launch schedules ho_single.cu (HO) and mevp_single.cu (CG1) cut
// the grid into at most one tile of TR x TC cells per SM. Block b of one
// cooperative launch (every block resident, so a block may wait on another)
// owns tile b for all N subcycles, with its state planes in shared memory
// and a one-cell apron around them. Between the two halves of a subcycle
// only the tile's edge crosses to another SM: the stress half at element
// (i, j) reads the velocity at nodes i..i+1, j..j+1, so a tile's first row
// and column of velocities is read by the tiles before it along i, along j
// and diagonally; the velocity half at node (i, j) reads the stresses of
// elements i-1..i, j-1..j, so a tile's last row and column of stresses is
// read by the tiles after it.
//
// The thread that computes an edge cell writes it at once to the tile's
// slot of a global exchange buffer, each value in one 64-bit word with the
// number of the half beside it (a relaxed store: the word is written whole
// or not at all). After its half a thread copies its share of the apron
// from the neighbours' slots, each word polled until it carries the half's
// number, and one block barrier ends the half. So a block waits on exactly
// the values it reads, from its three neighbours only, and pays no fence,
// no flag and no barrier over the grid: one trip through L2 per half. (The
// host zeroes the buffer before each launch; the halves are numbered from
// 1.) Swapping after grid.sync() instead took 2.5x as long an exchange on
// ho_single's 256^2 tiles (benchmarks.mevp_large --barriers; PERF.md).
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
// Should that ever fail, a reader would spin, never read a wrong value.
// Updating the state in place is safe for the same reason: the tiles that
// load a tile's first row and column into their apron at the start read its
// stress edge of the first subcycle before it writes anything back.
#pragma once

#include <cuda/atomic>

#include "common.cuh"

namespace nst {

// Where a block sits in the tile grid, and its three neighbours after it
// (dir = 1: +i, +j, +i+j) or before it (dir = -1). On a periodic axis
// (wrap: kWrapX, kWrapY; 0 for a closed domain) the tiles form a ring: the
// last tile's neighbour after it is the first. With one tile along such an
// axis a tile is its own neighbour, and it publishes its edge words before
// it polls them (each half's owned cells, then the apron copy), so it waits
// on its own threads only; with two, the tiles before and after it are
// the same tile, whose slot holds both edges in separate planes.
struct TileGrid {
  int ti, tj, tiles_i, tiles_j;
  __device__ __forceinline__ int neighbour(int n, int dir) const {
    const int di = n == 1 ? 0 : dir, dj = n == 0 ? 0 : dir;
    const int i = ti + di, j = tj + dj;
    return i >= 0 && i < tiles_i && j >= 0 && j < tiles_j ? i * tiles_j + j : -1;
  }
  // The same with the tiles in a ring along the periodic axes of `wrap`.
  __device__ __forceinline__ int neighbour_wrap(int n, int dir, int wrap) const {
    const int di = n == 1 ? 0 : dir, dj = n == 0 ? 0 : dir;
    int i = ti + di, j = tj + dj;
    if (wrap & kWrapX) i = wrap_index(i, tiles_i);
    if (wrap & kWrapY) j = wrap_index(j, tiles_j);
    return i >= 0 && i < tiles_i && j >= 0 && j < tiles_j ? i * tiles_j + j : -1;
  }
};

__device__ __forceinline__ TileGrid tile_of_block(int tiles_j) {
  const int b = static_cast<int>(blockIdx.x);
  return {b / tiles_j, b % tiles_j, static_cast<int>(gridDim.x) / tiles_j, tiles_j};
}

// The exchange: edge cell e of plane p of a tile's slot, as one 64-bit word
// of the value and the number of the half (1, 2, ...) that wrote it.
__device__ __forceinline__ void publish_word(unsigned long long* slot, int edge, int p, int e,
                                             float value, int half) {
  const unsigned long long word =
      static_cast<unsigned long long>(static_cast<unsigned>(half)) << 32 | __float_as_uint(value);
  cuda::atomic_ref<unsigned long long, cuda::thread_scope_device>(slot[p * edge + e])
      .store(word, cuda::memory_order_relaxed);
}

// The value of that word once the half `half` has written it.
__device__ __forceinline__ float take_word(unsigned long long* slot, int edge, int p, int e,
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
// apron), and the exchange slots of kPlanes planes of TR + TC words.
// kWrap: the periodic form, on the axes of `wrap` (read only there).
template <int kPlanes, bool kWrap = false>
struct TileView {
  TileGrid tile;
  int tr, tc, i0, j0, nx, ny, pitch, edge;
  unsigned long long* exchange;
  int wrap;
  __device__ __forceinline__ int cell(int r, int c) const { return (r + 1) * pitch + (c + 1); }
  __device__ __forceinline__ unsigned long long* slot(int b) const {
    return exchange + static_cast<long>(b) * kPlanes * edge;
  }
  // Whether cell (r, c) is a domain cell: in the periodic form every cell
  // of a periodic axis is (the tiles divide such an axis exactly, so the
  // apron beyond the last tile is the first tile's edge).
  __device__ __forceinline__ bool inside(int r, int c) const {
    const int i = i0 + r, j = j0 + c;
    if constexpr (kWrap) {
      return ((wrap & kWrapX) || (i >= 0 && i < nx)) && ((wrap & kWrapY) || (j >= 0 && j < ny));
    } else {
      return i >= 0 && i < nx && j >= 0 && j < ny;
    }
  }
  // The domain index of cell (r, c), wrapped on the periodic axes.
  __device__ __forceinline__ int index(int r, int c) const {
    int i = i0 + r, j = j0 + c;
    if constexpr (kWrap) wrap_ij(i, j, nx, ny, wrap);
    return i * ny + j;
  }
  __device__ __forceinline__ int neighbour(int n, int dir) const {
    if constexpr (kWrap) {
      return tile.neighbour_wrap(n, dir, wrap);
    } else {
      return tile.neighbour(n, dir);
    }
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
      if (r == line_r) publish_word(mine, edge, p, c, values[p - p0], half);
      if (c == line_c) publish_word(mine, edge, p, tc + r, values[p - p0], half);
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
    smem[p * plane + cell(r, c)] = take_word(slot(neighbour(n, dir)), edge, p, from, half);
  }
};

// One cooperative launch of `kernel` over `blocks` blocks of `threads`
// threads with `bytes` of dynamic shared memory; the error of the launch or
// of its attribute (a grid that cannot be resident is refused).
inline cudaError_t cooperative_launch(const void* kernel, int blocks, int threads, int bytes,
                                      void** args, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) {
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(threads), args, bytes, stream);
  }
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return err != cudaSuccess ? err : last;
}

// Blocks of `kernel` with `threads` threads and `bytes` of shared memory
// that can be resident at once on `device`: the most tiles a launch takes.
// Minus a CUDA error code where the runtime refuses.
inline int cooperative_max_blocks(const void* kernel, int threads, int bytes, int device) {
  cudaError_t err = cudaSetDevice(device);
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

}  // namespace nst
