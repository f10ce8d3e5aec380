// The whole CG1 dynamics phase on Hopper in one call: N mEVP subcycles, the
// CG1 -> dG1 velocity sampling, the CFL substep count k and k limited
// SSP-RK2 dG1 substeps of the 3 tracers, in one cooperative launch whose
// tiles stay resident in shared memory throughout.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas,
// which runs the same phase in one call with the whole grid resident in one
// core's VMEM, computing k from the resident final velocity and running the
// k substeps as a loop inside the kernel (coupled_pallas.py:113-128). Before
// this kernel the port ran that phase as 2N + 1 + 2k launches (K1's split
// schedule: mevp_stress and mevp_velocity, dg1_sample_cfl, dg1_rk_stage),
// with the two max speeds copied to the host to fix k: one host sync a step.
//
// The design is mevp_single's (mevp_single.cu, tile_exchange.cuh), carried
// on past the subcycles. Block b of one cooperative launch (every block
// resident, so a block may wait on another) owns tile b of at most one tile
// an SM, and keeps in shared memory, each plane with a one-cell apron:
//
//   the 5 mEVP state planes and, where they fit, the 7 const planes;
//   two buffers of the 9 tracer planes (3 dG1 coefficients of hice, cice
//       and hsnow): psi0, the substep's base and its result, and psi1, its
//       first stage's result;
//   in the coastline form the two face masks.
//
// 1. The N subcycles run mevp_single's loop (mevp_single.cuh), whose edges
//    pass in words tagged with the half's number (1 .. 2N), the last
//    velocity half's too, so that the apron at TR and TC holds the
//    neighbours' final velocity.
// 2. Each thread samples its elements' final velocity at the 4 volume and
//    the 2 + 2 face points, as dg1_sample_cfl does, and the block reduces
//    the max |vx| and max |vy|. Its pair goes to a global array in words
//    tagged 2N + 1; every block polls all the pairs and reduces them the
//    same way, so every block holds the same speeds and computes the same
//    k, with no atomic and no grid.sync(). A max is exact in any order, so
//    the speeds equal dg1_sample_cfl's bit for bit, and k is computed from
//    them with the host's float32 operations (fused_substeps), so it equals
//    the host's k for the same speeds. Block 0 writes (speed_x, speed_y, k)
//    for the checks; nothing on the step reads it.
// 3. k substeps at dt / k of two stages each: dg1_stage_cell of
//    dg1_body.cuh on every owned element and tracer (each face's flux on
//    both sides of it: the operations of dg1_rk_stage's shared face flux on
//    the same values, so the stage equals K1's dg1_rk_stage bit for bit, as
//    transport_tiled's does), the positivity limiter, the face masks. After
//    each stage (but the last) the tile's first and last rows and columns
//    of the 9 new planes go to its four neighbours in tagged words
//    (2N + 2, 2N + 3, ...). Unlike the mEVP halves, which alternate
//    direction and so hand each slot back before it is written again, a
//    stage sends both ways at once: a tile may write stage s + 2's edge
//    only after its readers have taken stage s's, which it knows once it
//    has read their stage s + 1 edge, so the tracer words are two slots a
//    tile, one per parity of the stage. Every tag rises through the launch
//    and each region is written once per tag, so a stale word never
//    matches (tile_exchange.cuh's argument, unchanged).
// 4. Each thread writes its cells of the 5 state planes (in place) and of
//    the tracers (to psi_out) once.
//
// Forms (template instances): the uniform closed RectMesh, the CG1 solver
// with fixed alpha and unweighted stresses, dG1 rk2 with the positivity
// limiter; the consts resident (up to ~400^2 on the H100's 132 SMs) or read
// from L2 (kResident 0); without face masks (this file) or with them
// (fused_dynamics_masked.cu); auto_substeps on or off (k_fixed, at run time).
// The host (fused_dynamics_cuda.py) sends every other form to the split
// schedules and refuses a grid whose tiles cannot all be resident.
//
// What bounds it on the H100: K4's subcycles (~122 float32 operations per
// element and subcycle, the two edge exchanges a subcycle through L2), then
// 2k stages of ~800 operations per element out of shared memory with one
// exchange each. HBM sees the state and tracers once in and once out.
#include "fused_dynamics.cuh"

#include <cstring>

namespace nst {

inline const void* fused_kernel(bool masks, int n_resident) {
  return masks ? fused_kernel_masked(n_resident) : fused_kernel_of<false>(n_resident);
}

inline int fused_shared_bytes(int tile_r, int tile_c, int n_resident, bool masks) {
  return (kSinglePlanes + n_resident + 2 * kFusedPlanes + (masks ? 2 : 0)) * (tile_r + 2) *
         (tile_c + 2) * static_cast<int>(sizeof(float));
}

// k of each (speed_x, speed_y) pair, by fused_substeps (the check of its
// arithmetic against the host's).
__global__ void fused_substeps_kernel(const float* speeds, int* k, int n, FusedArgs f) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < n) k[x] = fused_substeps(speeds[2 * x], speeds[2 * x + 1], f);
}

// The CFL part of the arguments: dt, the float32 roundings, the k bounds.
inline void fused_cfl_args(FusedArgs& f, double dt, const float* cfl, int k_fixed, int k_floor,
                           int k_max) {
  f.dt = dt;
  f.dt_f = cfl[0];
  f.dx_min = cfl[1];
  f.dy_min = cfl[2];
  f.c_stab = cfl[3];
  f.k_fixed = k_fixed;
  f.k_floor = k_floor;
  f.k_max = k_max;
}

}  // namespace nst

extern "C" {

// Dynamic shared memory of one block of fused_dynamics: the 5 state planes,
// n_resident const planes, 2 x 9 tracer planes and (masks) 2 face masks of a
// TR x TC tile, each with its one-cell apron.
int nst_fused_dynamics_shared_bytes(int tile_r, int tile_c, int n_resident, int masks) {
  return nst::fused_shared_bytes(tile_r, tile_c, n_resident, masks != 0);
}

// Blocks of fused_dynamics in a form with `threads` threads on TR x TC
// tiles that can be resident at once on `device`: the most tiles a launch
// takes. Minus a CUDA error code where the runtime refuses.
int nst_fused_dynamics_max_blocks(int n_resident, int masks, int tile_r, int tile_c, int threads,
                                  int device) {
  const void* kernel = nst::fused_kernel(masks != 0, n_resident);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return nst::cooperative_max_blocks(
      kernel, threads, nst::fused_shared_bytes(tile_r, tile_c, n_resident, masks != 0), device);
}

// The whole dynamics phase in one cooperative launch of one block of
// `threads` threads per TR x TC tile (tile_r, tile_c), tiles_i x tiles_j of
// them covering the nx x ny grid (each thread owns column t mod TC of at
// most 8 tile rows): n_sub >= 0 CG1 subcycles in place on u, v, s11, s22,
// s12 (consts: the 13 MevpConsts pointers, the 7 uniform ones set, the
// metric ones and a_node null; scalars: MevpScalars with this dt), the CFL
// count and k SSP-RK2 dG1 substeps from psi_in to psi_out ((3, 3, nx, ny),
// distinct), the face masks face_x, face_y where both are set (else every
// face is open but the walls). n_resident: 7 (the consts in shared memory)
// or 0. exchange: zero, (tiles, 5, TR + TC) mEVP words, then (tiles, 2, 9,
// 2 (TR + TC)) tracer words, then (tiles, 2) words of the speeds. info: 3
// floats, (speed_x, speed_y, k). dt: the outer step; cfl: float32 dt, min
// dx, min dy, c_stab; k_fixed > 0 runs that many substeps, 0 the CFL count
// clamped to [k_floor, k_max]; tables: DgTables<1>. A grid larger than can
// be resident is refused by the launch with an error, which is returned; so
// is any other launch error. Launches on `stream`; does not synchronise.
int nst_fused_dynamics(float* u, float* v, float* s11, float* s22, float* s12,
                       unsigned long long* exchange, const void* const* consts,
                       const float* psi_in, float* psi_out, const float* face_x,
                       const float* face_y, float* info, int nx, int ny, int n_sub, int tile_r,
                       int tile_c, int tiles_i, int tiles_j, int threads, int n_resident,
                       double dt, int k_fixed, int k_floor, int k_max, const float* cfl,
                       const float* scalars, const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = tile_c >= 1 ? threads / tile_c : 0;
  if (nx < 1 || ny < 1 || n_sub < 0 || tile_r < 1 || tile_c < 1 || tiles_i < 1 || tiles_j < 1 ||
      static_cast<long>(tiles_i) * tile_r < nx || static_cast<long>(tiles_i - 1) * tile_r >= nx ||
      static_cast<long>(tiles_j) * tile_c < ny || static_cast<long>(tiles_j - 1) * tile_c >= ny ||
      threads < 32 || threads > nst::kFusedMaxThreads || threads % 32 != 0 || rows < 1 ||
      (tile_r + rows - 1) / rows > nst::kSingleMaxCells || k_fixed < 0 || k_max < 1 ||
      psi_in == psi_out || (face_x == nullptr) != (face_y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::FusedArgs f;
  float* state[] = {u, v, s11, s22, s12};
  std::memcpy(f.m.state, state, sizeof(f.m.state));
  std::memcpy(&f.m.k, consts, sizeof(f.m.k));
  std::memcpy(&f.m.s, scalars, sizeof(f.m.s));
  // The uniform form: the metric planes and a_node null, the 7 others set.
  if (f.m.k.inv_dx != nullptr || f.m.k.a_node != nullptr || f.m.k.strength == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  f.m.nx = nx;
  f.m.ny = ny;
  f.m.n_sub = n_sub;
  f.m.tile_r = tile_r;
  f.m.tile_c = tile_c;
  f.m.tiles_j = tiles_j;
  f.m.wrap = 0;
  const long tiles = static_cast<long>(tiles_i) * tiles_j, edge = tile_r + tile_c;
  f.m.exchange = exchange;
  f.tracer_words = exchange + tiles * nst::kSinglePlanes * edge;
  f.partials = f.tracer_words + tiles * 2 * nst::kFusedPlanes * 2 * edge;
  f.psi_in = psi_in;
  f.psi_out = psi_out;
  f.face_x = face_x;
  f.face_y = face_y;
  f.info = info;
  std::memcpy(&f.tb, tables, sizeof(f.tb));
  nst::fused_cfl_args(f, dt, cfl, k_fixed, k_floor, k_max);
  const bool masks = face_x != nullptr;
  const void* kernel = nst::fused_kernel(masks, n_resident);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  void* args[] = {&f};
  return static_cast<int>(nst::cooperative_launch(
      kernel, static_cast<int>(tiles), threads,
      nst::fused_shared_bytes(tile_r, tile_c, n_resident, masks), args,
      static_cast<cudaStream_t>(stream)));
}

// k[x] of the n speed pairs speeds[2x], speeds[2x + 1] (device arrays) by
// the kernel's own CFL arithmetic, with the arguments of nst_fused_dynamics.
// Launches on `stream`; does not synchronise.
int nst_fused_substeps(const float* speeds, int* k, int n, double dt, int k_fixed, int k_floor,
                       int k_max, const float* cfl, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n < 1 || k_fixed < 0 || k_max < 1) return static_cast<int>(cudaErrorInvalidValue);
  nst::FusedArgs f = {};
  nst::fused_cfl_args(f, dt, cfl, k_fixed, k_floor, k_max);
  nst::fused_substeps_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      speeds, k, n, f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
