// The whole CG1 dynamics phase on Hopper in one call: N mEVP subcycles, the
// CG1 -> dG velocity sampling, the CFL substep count k and k limited SSP-RK
// dG substeps of the 3 tracers, in one cooperative launch whose tiles stay
// resident in shared memory throughout. Steps 1-4 below describe the
// headline's form (dG1 rk2); the forms after them add to it.
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
// Forms. The headline's (a closed mesh, the CG1 solver with fixed alpha and
// unweighted stresses, dG1 rk2 with the positivity limiter) is
// fused_dynamics_kernel: the consts resident (up to ~400^2 on the H100's
// 132 SMs) or read from L2 (kResident 0), without face masks (this file) or
// with them (fused_dynamics_masked.cu), auto_substeps on or off (k_fixed,
// at run time). Every other form of a uniform mesh is
// fused_dynamics_forms_kernel (fused_dynamics_dg*.cu), the same steps with:
//
//   periodic axes (a.wrap, at run time): mevp_single's ring of tiles
//       (tile_exchange.cuh), whose apron beyond a periodic axis holds the
//       other side's cells, for the mEVP and the tracer edges alike, and no
//       wall face on that axis; a one-tile axis is its own neighbour;
//   A-weighted stresses (at run time): c_w times the a_node plane, an eighth
//       const plane, resident with the others or read from L2; a plane of
//       ones where the stresses are not weighted (c_w * 1 is c_w exactly);
//   adaptive alpha (compiled): beta in registers, as mevp_single keeps it;
//   the degree (compiled: dG0, dG1, dG2) with any scheme (at run time: rk1,
//       rk2, rk3 with their stage blends; rk3 a third tracer buffer), the
//       CFL speeds at the degree's points;
//   the TVB limiter (compiled, dG1 and dG2; tolerances M dx^2, M dy^2):
//       each stage unlimited, its edge elements' means to the exchange,
//       then dg_tvb_limit (the minmod slope limiter, then positivity) on
//       every owned element, then the limited higher coefficients to the
//       exchange: one more tagged exchange a stage;
//   the coastline (at run time): its face masks, or planes of ones (a flux
//       times 1 is the flux), resident beside the tracers;
//   the consts resident or not (compiled; at dG2 always: instances reading
//       them from L2 would hold 325^2 where these hold 300^2, for twice the
//       dG2 instances).
//
// The host (fused_dynamics_cuda.py) sends a graded or spherical mesh, a
// rank grid, the HO solver and free drift to the other schedules, and
// refuses a grid whose tiles cannot all be resident.
//
// What bounds it on the H100: K4's subcycles (~122 float32 operations per
// element and subcycle, the two edge exchanges a subcycle through L2), then
// 2k stages of ~800 operations per element out of shared memory with one
// exchange each. HBM sees the state and tracers once in and once out.
#include "fused_dynamics.cuh"

#include <cstring>

namespace nst {

// A launch's form: degree, TVB, the momentum form's bits (kFormWeighted,
// kFormAdaptive), the periodic axes and the scheme's stages, as the host
// packs them (fused_dynamics_cuda.Form.c_form).
struct FusedForm {
  int degree, tvb, mevp, wrap, n_stages;
  bool headline() const { return degree == 1 && !tvb && mevp == 0 && wrap == 0 && n_stages == 2; }
  bool valid() const {
    return degree >= 0 && degree <= 2 && (tvb == 0 || (tvb == 1 && degree > 0)) && mevp >= 0 &&
           mevp < kForms && wrap >= 0 && wrap <= (kWrapX | kWrapY) && n_stages >= 1 &&
           n_stages <= kMaxStages;
  }
  int planes() const { return (degree == 0 ? 1 : degree == 1 ? 3 : 6) * kFusedTracers; }
  int buffers() const { return n_stages == kMaxStages ? 3 : 2; }
  int max_threads() const { return degree == 2 ? FusedShape<2>::kMaxThreads : kFusedMaxThreads; }
  int all_consts() const { return headline() ? kFusedConsts : kFormConsts; }
};

inline FusedForm fused_form(const int* form) {
  return {form[0], form[1], form[2], form[3], form[4]};
}

// The kernel of a form, with or without the face masks, its consts
// resident (all) or not; null for another count or an unknown form.
inline const void* fused_kernel(const FusedForm& form, bool masks, int n_resident) {
  if (!form.valid()) return nullptr;
  if (form.headline()) return masks ? fused_kernel_masked(n_resident) : fused_kernel_of<false>(n_resident);
  const bool adaptive = (form.mevp & kFormAdaptive) != 0;
  if (!masks) return nullptr;  // the other forms read the face masks (ones without a coastline)
  switch (form.degree * 2 + form.tvb) {
    case 0: return fused_forms_dg0(adaptive, n_resident);
    case 2: return fused_forms_dg1(adaptive, n_resident);
    case 3: return fused_forms_dg1_tvb(adaptive, n_resident);
    case 4: return fused_forms_dg2(adaptive, n_resident);
    case 5: return fused_forms_dg2_tvb(adaptive, n_resident);
    default: return nullptr;
  }
}

inline int fused_shared_bytes(int tile_r, int tile_c, int n_resident, bool masks, const FusedForm& form) {
  return (kSinglePlanes + n_resident + form.buffers() * form.planes() + (masks ? 2 : 0)) * (tile_r + 2) *
         (tile_c + 2) * static_cast<int>(sizeof(float));
}

// k of each (speed_x, speed_y) pair, by fused_substeps (the check of its
// arithmetic against the host's).
__global__ void fused_substeps_kernel(const float* speeds, int* k, int n, FusedArgs f) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  if (x < n) k[x] = fused_substeps(speeds[2 * x], speeds[2 * x + 1], f);
}

// The CFL part of the arguments: dt, the float32 roundings, the k bounds.
template <class Args>
inline void fused_cfl_args(Args& f, double dt, const float* cfl, int k_fixed, int k_floor, int k_max) {
  f.dt = dt;
  f.dt_f = cfl[0];
  f.dx_min = cfl[1];
  f.dy_min = cfl[2];
  f.c_stab = cfl[3];
  f.k_fixed = k_fixed;
  f.k_floor = k_floor;
  f.k_max = k_max;
}

// The fields every form's arguments share.
template <class Args>
inline void fused_common_args(Args& f, float* const* state, unsigned long long* exchange,
                              const void* const* consts, const float* psi_in, float* psi_out,
                              const float* face_x, const float* face_y, float* info, int nx, int ny,
                              int n_sub, int tile_r, int tile_c, int tiles_j, long tiles, int planes,
                              const float* scalars, const float* tables, int wrap) {
  std::memcpy(f.m.state, state, sizeof(f.m.state));
  std::memcpy(&f.m.k, consts, sizeof(f.m.k));
  std::memcpy(&f.m.s, scalars, sizeof(f.m.s));
  f.m.nx = nx;
  f.m.ny = ny;
  f.m.n_sub = n_sub;
  f.m.tile_r = tile_r;
  f.m.tile_c = tile_c;
  f.m.tiles_j = tiles_j;
  f.m.wrap = wrap;
  const long edge = tile_r + tile_c;
  f.m.exchange = exchange;
  f.tracer_words = exchange + tiles * kSinglePlanes * edge;
  f.partials = f.tracer_words + tiles * 2 * planes * 2 * edge;
  f.psi_in = psi_in;
  f.psi_out = psi_out;
  f.face_x = face_x;
  f.face_y = face_y;
  f.info = info;
  std::memcpy(&f.tb, tables, sizeof(f.tb));
}

// One launch of the other forms at degree kDeg (arguments checked).
template <int kDeg>
cudaError_t fused_forms_launch(const void* kernel, FusedFormArgs<kDeg>& f, const FusedForm& form,
                               const float* rk, int tiles, int threads, int bytes, cudaStream_t stream) {
  f.n_stages = form.n_stages;
  for (int s = 0; s < kMaxStages; ++s) {
    f.a[s] = rk[s];
    f.b[s] = rk[kMaxStages + s];
  }
  f.tol_x = rk[2 * kMaxStages];
  f.tol_y = rk[2 * kMaxStages + 1];
  void* args[] = {&f};
  return cooperative_launch(kernel, tiles, threads, bytes, args, stream);
}

}  // namespace nst

extern "C" {

// Dynamic shared memory of one block of fused_dynamics in a form (form: 5
// ints, FusedForm): the 5 state planes, n_resident const planes, 2 (rk3: 3)
// tracer buffers of 3K planes and (masks) 2 face masks of a TR x TC tile,
// each with its one-cell apron. -1 for an unknown form.
int nst_fused_dynamics_shared_bytes(int tile_r, int tile_c, int n_resident, int masks, const int* form) {
  const nst::FusedForm f = nst::fused_form(form);
  return f.valid() ? nst::fused_shared_bytes(tile_r, tile_c, n_resident, masks != 0, f) : -1;
}

// Blocks of fused_dynamics in a form with `threads` threads on TR x TC
// tiles that can be resident at once on `device`: the most tiles a launch
// takes. Minus a CUDA error code where the runtime refuses.
int nst_fused_dynamics_max_blocks(int n_resident, int masks, int tile_r, int tile_c, int threads,
                                  const int* form, int device) {
  const nst::FusedForm f = nst::fused_form(form);
  const void* kernel = nst::fused_kernel(f, masks != 0, n_resident);
  if (kernel == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  return nst::cooperative_max_blocks(
      kernel, threads, nst::fused_shared_bytes(tile_r, tile_c, n_resident, masks != 0, f), device);
}

// The whole dynamics phase in one cooperative launch of one block of
// `threads` threads per TR x TC tile (tile_r, tile_c), tiles_i x tiles_j of
// them covering the nx x ny grid (each thread owns column t mod TC of at
// most 8 tile rows; on a periodic axis the tiles divide it): n_sub >= 0
// CG1 subcycles in place on u, v, s11, s22, s12 (consts: the 13 MevpConsts
// pointers, the 7 uniform ones set, the metric ones null, a_node null in the
// headline's form and set in the others (ones where the stresses are not
// A-weighted); scalars: MevpScalars with this dt), the CFL count and k
// SSP-RK substeps from psi_in to psi_out ((K, 3, nx, ny), distinct), the
// face masks face_x, face_y where both are set (else every face is open but
// the walls; the other forms take them always, ones without a coastline). form: degree, TVB (0, 1), the momentum form's bits, the
// periodic axes (kWrapX, kWrapY) and the scheme's stages (1-3); rk: the
// stages' blends a[3], b[3], then the TVB tolerances M dx^2, M dy^2 (read
// in the other forms only). n_resident: 0 or all of the form's consts (7 in
// the headline's form, 8 in the others). exchange: zero, (tiles, 5, TR +
// TC) mEVP words, then (tiles, 2, 3K, 2 (TR + TC)) tracer words, then
// (tiles, 2) words of the speeds. info: 3 floats, (speed_x, speed_y, k).
// dt: the outer step; cfl: float32 dt, min dx, min dy, c_stab; k_fixed > 0
// runs that many substeps, 0 the CFL count clamped to [k_floor, k_max];
// tables: DgTables of the degree. A grid larger than can be resident is
// refused by the launch with an error, which is returned; so is any other
// launch error. Launches on `stream`; does not synchronise.
int nst_fused_dynamics(float* u, float* v, float* s11, float* s22, float* s12,
                       unsigned long long* exchange, const void* const* consts,
                       const float* psi_in, float* psi_out, const float* face_x,
                       const float* face_y, float* info, int nx, int ny, int n_sub, int tile_r,
                       int tile_c, int tiles_i, int tiles_j, int threads, int n_resident,
                       double dt, int k_fixed, int k_floor, int k_max, const float* cfl,
                       const float* scalars, const float* tables, const int* form_bits,
                       const float* rk, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const nst::FusedForm form = nst::fused_form(form_bits);
  const int rows = tile_c >= 1 ? threads / tile_c : 0;
  const bool px = (form.wrap & nst::kWrapX) != 0, py = (form.wrap & nst::kWrapY) != 0;
  if (!form.valid() || nx < 1 || ny < 1 || n_sub < 0 || tile_r < 1 || tile_c < 1 || tiles_i < 1 ||
      tiles_j < 1 || static_cast<long>(tiles_i) * tile_r < nx ||
      static_cast<long>(tiles_i - 1) * tile_r >= nx || static_cast<long>(tiles_j) * tile_c < ny ||
      static_cast<long>(tiles_j - 1) * tile_c >= ny || (px && nx % tile_r != 0) ||
      (py && ny % tile_c != 0) || threads < 32 || threads > form.max_threads() || threads % 32 != 0 ||
      rows < 1 || (tile_r + rows - 1) / rows > nst::kSingleMaxCells || k_fixed < 0 || k_max < 1 ||
      psi_in == psi_out || (face_x == nullptr) != (face_y == nullptr) ||
      (n_resident != 0 && n_resident != form.all_consts())) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::MevpConsts k;
  std::memcpy(&k, consts, sizeof(k));
  // The uniform consts set, the metric planes null, a_node as the form reads it.
  if (k.inv_dx != nullptr || k.strength == nullptr || (k.a_node != nullptr) != !form.headline()) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool masks = face_x != nullptr;
  const void* kernel = nst::fused_kernel(form, masks, n_resident);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  float* state[] = {u, v, s11, s22, s12};
  const long tiles = static_cast<long>(tiles_i) * tiles_j;
  const int bytes = nst::fused_shared_bytes(tile_r, tile_c, n_resident, masks, form);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto common = [&](auto& f) {
    nst::fused_common_args(f, state, exchange, consts, psi_in, psi_out, face_x, face_y, info, nx, ny,
                           n_sub, tile_r, tile_c, tiles_j, tiles, form.planes(), scalars, tables,
                           form.wrap);
    nst::fused_cfl_args(f, dt, cfl, k_fixed, k_floor, k_max);
  };
  const auto forms = [&](auto& f) {
    common(f);
    return static_cast<int>(nst::fused_forms_launch(kernel, f, form, rk, static_cast<int>(tiles), threads,
                                                    bytes, s));
  };
  if (form.headline()) {
    nst::FusedArgs f;
    common(f);
    void* args[] = {&f};
    return static_cast<int>(nst::cooperative_launch(kernel, static_cast<int>(tiles), threads, bytes, args, s));
  }
  switch (form.degree) {
    case 0: {
      nst::FusedFormArgs<0> f;
      return forms(f);
    }
    case 1: {
      nst::FusedFormArgs<1> f;
      return forms(f);
    }
    default: {
      nst::FusedFormArgs<2> f;
      return forms(f);
    }
  }
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
