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
#include <algorithm>
#include <cstring>

#include "mevp_body.cuh"
#include "tile_exchange.cuh"

namespace nst {

constexpr int kSingleMaxThreads = 1024;
constexpr int kSinglePlanes = 5;    // u, v, s11, s22, s12: the state and an exchange slot
constexpr int kSingleMaxCells = 8;  // tile rows a thread owns, at most
constexpr int kSU = 0, kSV = 1, kS11 = 2;

// Const plane p's place in the order in which the host keeps const planes in
// shared memory (mevp_single_cuda.RESIDENT_ORDER, among the 12 metric or the
// 7 uniform consts): the velocity half reads half_dx and half_dy at four
// elements each, dt_m and the ocean current are read by both halves, the
// others once a subcycle. A kernel keeps the first kResident in shared
// memory, at that place, and reads the others from global memory.
__host__ __device__ constexpr int resident_rank(bool metric, int p) {
  return metric ? (p == kHalfDx ? 0 : p == kHalfDy ? 1 : p == kDtM ? 2 : p == kUo ? 3 : p == kVo ? 4
                   : p == kStrength ? 5 : p == kActive ? 6 : p == kBu ? 7 : p == kBv ? 8
                   : p == kInvDx ? 9 : p == kInvDy ? 10 : 11)
                : (p == kDtM ? 0 : p == kUo ? 1 : p == kVo ? 2 : p == kStrength ? 3 : p == kActive ? 4
                   : p == kBu ? 5 : p == kBv ? 6 : kMevpConstPlanes);
}

struct SingleArgs {
  float* state[kSinglePlanes];   // u, v, s11, s22, s12, each (nx, ny), updated in place
  unsigned long long* exchange;  // (tiles, 5, TR + TC): each tile's edges, zero at launch
  MevpConsts k;
  int nx, ny, n_sub;
  int tile_r, tile_c, tiles_j;  // TR x TC tiles, tiles_j of them along j
  MevpScalars s;
};

template <bool kMetric, int kResident>
__global__ void __launch_bounds__(kSingleMaxThreads, 1) mevp_single_kernel(SingleArgs a) {
  extern __shared__ float smem[];
  TileView<kSinglePlanes> t;
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
  const int tr = t.tr, tc = t.tc, nx = a.nx, ny = a.ny, pitch = t.pitch;
  const int plane = (tr + 2) * pitch;
  float* const su = smem;
  float* const sv = su + plane;
  float* const s11 = sv + plane;
  float* const s22 = s11 + plane;
  float* const s12 = s22 + plane;
  float* const konst = smem + kSinglePlanes * plane;  // the resident const planes, same layout
  const auto shared = [](int p) { return resident_rank(kMetric, p) < kResident; };
  const int tid = threadIdx.x, n_threads = blockDim.x;

  // The load: every cell of the tile and its apron that lies in the domain,
  // zeros elsewhere. The state's apron at -1 (stresses) stays zero until the
  // exchange fills it, before it is read; the consts' apron at -1 holds the
  // half_dx and half_dy that the velocity half weighs those stresses by.
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int x = tid; x < plane; x += n_threads) {
    const int r = region_row(x, inv_pitch) - 1, c = x - (r + 1) * pitch - 1;
    const bool in = t.inside(r, c), state_in = in && r >= 0 && c >= 0;
    const int ij = in ? (t.i0 + r) * ny + (t.j0 + c) : 0;
#pragma unroll
    for (int p = 0; p < kSinglePlanes; ++p) smem[p * plane + x] = state_in ? a.state[p][ij] : 0.0f;
#pragma unroll
    for (int p = 0; p < kMevpConstPlanes; ++p) {
      if (shared(p)) konst[resident_rank(kMetric, p) * plane + x] = in ? __ldg(mevp_const_plane(a.k, p) + ij) : 0.0f;
    }
  }
  __syncthreads();

  // This thread's cells: column c of rows r0, r0 + rows, ... below r_end.
  const int rows = n_threads / tc;
  const int r0 = tid / tc, c = tid - r0 * tc, j = t.j0 + c;
  const int r_end = r0 < rows && j < ny ? min(tr, nx - t.i0) : 0;
  const auto owned = [&](auto fn) {
#pragma unroll
    for (int q = 0; q < kSingleMaxCells; ++q) {
      int r = r0 + q * rows;
      // Opaque to the compiler, so that the cells' addresses are not all
      // hoisted out of the subcycle loop into registers (they spill).
      asm volatile("" : "+r"(r));
      if (r < r_end) fn(q, r);
    }
  };
  // Const plane p at the cell of shared index e and domain index ij.
  const auto cst = [&](int p, int e, int ij) {
    return shared(p) ? konst[resident_rank(kMetric, p) * plane + e] : __ldg(mevp_const_plane(a.k, p) + ij);
  };
  // The stresses s around the node at e, times metric plane p of their own
  // element (0 beyond the domain, as weighted() of mevp_body.cuh).
  const auto weighted = [&](const float* s, int p, int e, int ij, int i) {
    if (!shared(p)) return weighted_tile(s, mevp_const_plane(a.k, p), e, pitch, ij, i, j, nx, ny);
    const float* w = konst + resident_rank(kMetric, p) * plane;
    return Around{s[e] * w[e], s[e - pitch] * w[e - pitch], s[e - 1] * w[e - 1],
                  s[e - pitch - 1] * w[e - pitch - 1]};
  };

  float cw[kSingleMaxCells], inv[kSingleMaxCells];
  for (int sub = 0; sub < a.n_sub; ++sub) {
    // Stress half, element (r, c): nodes r..r+1, c..c+1 (at TR or TC the
    // apron). The last row and column go to the exchange.
    const int stress_half = 2 * sub + 1;
    owned([&](int q, int r) {
      const int e = t.cell(r, c), ij = (t.i0 + r) * ny + j;
      const StressOut o = mevp_stress_body(
          su[e], su[e + pitch], su[e + 1], su[e + pitch + 1], sv[e], sv[e + pitch], sv[e + 1],
          sv[e + pitch + 1], s11[e], s22[e], s12[e], cst(kStrength, e, ij), cst(kDtM, e, ij),
          cst(kActive, e, ij), cst(kUo, e, ij), cst(kVo, e, ij),
          kMetric ? cst(kInvDx, e, ij) : a.s.inv_dx, kMetric ? cst(kInvDy, e, ij) : a.s.inv_dy,
          a.s);
      s11[e] = o.s11;
      s22[e] = o.s22;
      s12[e] = o.s12;
      cw[q] = o.c_w;
      inv[q] = o.inv_drag;
      const float sig[3] = {o.s11, o.s22, o.s12};
      t.publish(r, c, 1, kS11, kSinglePlanes, sig, stress_half);
    });
    // The stresses of the tiles before this one into the apron at -1.
    for (int x = tid; x < (t.edge + 1) * 3; x += n_threads) t.take(smem, plane, x, -1, kS11, stress_half);
    __syncthreads();

    // Velocity half, node (r, c): elements r-1..r, c-1..c (at -1 the
    // apron), and the c_w and inv_drag of element (r, c) from above. The
    // first row and column go to the exchange.
    const bool last = sub + 1 == a.n_sub;
    const int velocity_half = 2 * sub + 2;
    owned([&](int q, int r) {
      const int e = t.cell(r, c), i = t.i0 + r, ij = i * ny + j;
      float2 f;
      float inv_w;
      if (kMetric) {
        f = forces_metric(weighted(s11, kHalfDy, e, ij, i), weighted(s12, kHalfDx, e, ij, i),
                          weighted(s12, kHalfDy, e, ij, i), weighted(s22, kHalfDx, e, ij, i));
        inv_w = cst(kInvW, e, ij);
      } else {
        const Around a11 = {s11[e], s11[e - pitch], s11[e - 1], s11[e - pitch - 1]};
        const Around a22 = {s22[e], s22[e - pitch], s22[e - 1], s22[e - pitch - 1]};
        const Around a12 = {s12[e], s12[e - pitch], s12[e - 1], s12[e - pitch - 1]};
        f = forces_uniform(a11, a22, a12, a.s);
        inv_w = a.s.inv_w;
      }
      const float2 uv = mevp_velocity_body(
          f, inv_w, su[e], sv[e], cst(kUo, e, ij), cst(kVo, e, ij), cw[q], cst(kDtM, e, ij),
          cst(kBu, e, ij), cst(kBv, e, ij), inv[q], a.s);
      su[e] = uv.x;
      sv[e] = uv.y;
      if (!last) {
        const float vel[2] = {uv.x, uv.y};
        t.publish(r, c, -1, kSU, kSV + 1, vel, velocity_half);
      }
    });
    if (last) break;
    // The velocities of the tiles after this one into the apron at TR and TC.
    for (int x = tid; x < (t.edge + 1) * 2; x += n_threads) t.take(smem, plane, x, 1, kSU, velocity_half);
    __syncthreads();
  }

  // Write the tile back: each thread its own cells, which it wrote last.
  owned([&](int, int r) {
    const int e = t.cell(r, c), ij = (t.i0 + r) * ny + j;
#pragma unroll
    for (int p = 0; p < kSinglePlanes; ++p) a.state[p][ij] = smem[p * plane + e];
  });
}

// The kernel for a mesh (metric or uniform) with the first n_resident of
// its const planes in shared memory: none, one, two or all of them (null for
// another count).
inline const void* single_kernel(bool metric, int n_resident) {
  if (metric) {
    return n_resident == 0   ? reinterpret_cast<const void*>(&mevp_single_kernel<true, 0>)
           : n_resident == 1 ? reinterpret_cast<const void*>(&mevp_single_kernel<true, 1>)
           : n_resident == 2 ? reinterpret_cast<const void*>(&mevp_single_kernel<true, 2>)
           : n_resident == kMevpConstPlanes ? reinterpret_cast<const void*>(&mevp_single_kernel<true, kMevpConstPlanes>)
                                            : nullptr;
  }
  return n_resident == 0   ? reinterpret_cast<const void*>(&mevp_single_kernel<false, 0>)
         : n_resident == 1 ? reinterpret_cast<const void*>(&mevp_single_kernel<false, 1>)
         : n_resident == 2 ? reinterpret_cast<const void*>(&mevp_single_kernel<false, 2>)
         : n_resident == 7 ? reinterpret_cast<const void*>(&mevp_single_kernel<false, 7>)
                           : nullptr;
}

}  // namespace nst

extern "C" {

// Dynamic shared memory of one block: the 5 state planes and n_resident
// const planes of a TR x TC tile, each with its one-cell apron.
int nst_mevp_single_shared_bytes(int tile_r, int tile_c, int n_resident) {
  return (nst::kSinglePlanes + n_resident) * (tile_r + 2) * (tile_c + 2) *
         static_cast<int>(sizeof(float));
}

// Blocks of mevp_single (metric or uniform) with `threads` threads on TR x
// TC tiles with n_resident const planes in shared memory that can be
// resident at once on `device`: the most tiles a launch takes. Minus a
// CUDA error code where the runtime refuses.
int nst_mevp_single_max_blocks(int metric, int tile_r, int tile_c, int n_resident, int threads,
                               int device) {
  const void* kernel = nst::single_kernel(metric != 0, n_resident);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return nst::cooperative_max_blocks(kernel, threads,
                                     nst_mevp_single_shared_bytes(tile_r, tile_c, n_resident), device);
}

// n_sub >= 1 subcycles in place on u, v, s11, s22, s12, in one cooperative
// launch of one block of `threads` threads per TR x TC tile (tile_r,
// tile_c), tiles_i x tiles_j of them covering the grid; each thread owns
// column t mod TC of at most 8 tile rows (threads / TC rows at a time).
// exchange: (tiles, 5, TR + TC) 64-bit words, zero. consts points to the 12
// const-plane pointers in the order of MevpConsts, the last five null on a
// uniform mesh. slots[p]: the shared-memory plane of const plane p, or -1
// to read it from global memory: the first 0, 1, 2 or all of the planes in
// the order of resident_rank, at their place in it. A grid larger
// than can be resident is refused by the launch with an error, which is
// returned; so is any other launch error. Launches on `stream`; does not
// synchronise.
int nst_mevp_single(float* u, float* v, float* s11, float* s22, float* s12,
                    unsigned long long* exchange, const void* const* consts, int nx, int ny,
                    int n_sub, int tile_r, int tile_c, int tiles_i, int tiles_j, int threads,
                    const int* slots, const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tile_c >= 1 ? threads / tile_c : 0;
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
  const bool metric = a.k.inv_dx != nullptr;
  // slots must be the first n_resident planes of the kernels' order.
  const int n_resident = static_cast<int>(
      std::count_if(slots, slots + nst::kMevpConstPlanes, [](int slot) { return slot >= 0; }));
  for (int p = 0; p < nst::kMevpConstPlanes; ++p) {
    const int rank = nst::resident_rank(metric, p);
    if (slots[p] != (rank < n_resident ? rank : -1)) return static_cast<int>(cudaErrorInvalidValue);
  }
  if (nst::single_kernel(metric, n_resident) == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&a};
  return static_cast<int>(nst::cooperative_launch(
      nst::single_kernel(metric, n_resident), tiles_i * tiles_j, threads,
      nst_mevp_single_shared_bytes(tile_r, tile_c, n_resident), args,
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
