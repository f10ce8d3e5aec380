// The halo forms of the CG1 mEVP halves: one mEVP subcycle of a rank block
// of a rank grid as two launches, each behind a width-1 strip exchange.
//
// Replaces the mEVP part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas as
// the JAX package runs its subcycle on a rank grid on the width-1 ("xla")
// schedule (nextsimdg_tpu/dynamics/mevp.py MEVPSolver under shard_map: every
// neighbour shift of the subcycle a width-1 ppermute,
// nextsimdg_tpu/dynamics/stencil.py). Here the host exchanges the strips
// that a half reads beyond the rank's block once before it (coupled_cuda.py
// spmd_xla_subcycles), and one launch computes the block:
//
//   mevp_stress_halo    (elements): the stress half of mevp.cu's mevp_stress
//                       on the own elements; nodes i + 1 and j + 1 beyond the
//                       block come from the +1 neighbours' first row of u and
//                       v and their first column, extended by one row, so
//                       that its last cell is the diagonal rank's corner.
//   mevp_velocity_halo  (nodes): the velocity half of mevp_velocity on the own
//                       nodes; elements i - 1 and j - 1 beyond the block come
//                       from the -1 neighbours' last row and column of s11,
//                       s22 and s12 (and on a graded or spherical mesh of
//                       half_dx and half_dy, exchanged once a step).
//
// Both reuse mevp_body.cuh's mevp_stress_body and mevp_velocity_body (and
// its forces) unchanged, in the order of the single domain's kernels, so a
// block equals the single domain's block bit for bit. A closed global
// wall's strips are zeros, which is the implicit wall of the single domain
// (every read beyond a wall is a zero); a periodic axis needs no form of
// its own: its wrap arrives in the strips, through the exchange's ring of
// ranks. So the instances are the metric and momentum forms only.
//
// Why strips and not a block widened by one ring (the halo form of
// dg1_rk_stage): each half reads one row and one column beyond the block,
// so the strips are 2 (stress) or 3 (velocity) rows and columns a subcycle,
// where widening copies the 5 state planes whole (16 MB each at config 5's
// 2048^2 blocks) every subcycle. One thread an element or node, planes in
// global memory, in place as mevp.cu's halves (a half never writes what it
// reads of a neighbour).
//
// What bounds it on the H100: at a 2048^2 block each half moves about 17
// planes (0.085 ms at 3.35 TB/s); the metric forms took 0.095 ms (stress)
// and 0.115 ms (velocity) of device time there (chip_smoke.py, H100 80GB
// HBM3 at 700 W), where padding the planes a half reads beyond the block
// by one ring, as a widened-block design must, took 0.047 and 0.067 ms.
//
// In sources of their own so that mevp.cu's instances keep their code:
// this one the closed uniform form 0 and the entry points,
// mevp_spmd_forms.cu the others.
#include <cstring>

#include "mevp_spmd.cuh"

namespace nst {

HaloKernel halo_kernel(int half, bool metric, int form) {
  if (!metric && form == 0) return halo_kernel_of<false, 0>(half);
  return mevp_halo_forms_of(half, metric, form);
}

int launch_halo(int half, float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                float* inv_drag, float* beta, const void* const* consts, const float* strip_x,
                const float* strip_y, const float* metric_x, const float* metric_y, int nx, int ny,
                int form, const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MevpState p = {u, v, s11, s22, s12, c_w, inv_drag, beta};
  MevpConsts k;
  MevpScalars s;
  std::memcpy(&k, consts, sizeof(k));
  std::memcpy(&s, scalars, sizeof(s));
  const bool metric = k.inv_dx != nullptr;
  const HaloKernel kernel = form >= 0 && form < kForms ? halo_kernel(half, metric, form) : nullptr;
  if (kernel == nullptr || nx < 1 || ny < 1 || strip_x == nullptr || strip_y == nullptr ||
      ((form & kFormWeighted) != 0) != (k.a_node != nullptr) ||
      ((form & kFormAdaptive) != 0) != (beta != nullptr) ||
      (half == 1 && metric) != (metric_x != nullptr) ||
      (metric_x == nullptr) != (metric_y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const MevpHalo h = {strip_x, strip_y, metric_x, metric_y};
  const auto s_ = static_cast<cudaStream_t>(stream);
  kernel<<<plane_grid(nx, ny), plane_block(), 0, s_>>>(p, k, h, nx, ny, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

// Each entry point launches one halo half on `stream` (the caller's PyTorch
// stream) in place on the rank's own (nx, ny) planes and returns
// cudaGetLastError(); it does not synchronise. consts: the 13 const-plane
// pointers of MevpConsts, as nst_mevp_stress takes them (the block's own);
// form: the momentum form's bits (kFormWeighted, kFormAdaptive), no
// periodic bits; strip_x, strip_y: MevpHalo's x and y (the stress half's
// +1 strips of u and v, 2 x ny and 2 x (nx + 1) floats); beta: the adaptive
// form's node plane, null in the others.
int nst_mevp_stress_halo(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                         float* inv_drag, float* beta, const void* const* consts,
                         const float* strip_x, const float* strip_y, int nx, int ny, int form,
                         const float* scalars, int device, void* stream) {
  return nst::launch_halo(0, u, v, s11, s22, s12, c_w, inv_drag, beta, consts, strip_x, strip_y,
                          nullptr, nullptr, nx, ny, form, scalars, device, stream);
}

// The velocity half: strip_x, strip_y the -1 strips of s11, s22 and s12
// (3 x ny and 3 x (nx + 1) floats); metric_x, metric_y those of half_dx and
// half_dy (2 x ny and 2 x (nx + 1)) on a graded or spherical mesh, null on
// a uniform one. c_w, inv_drag and beta are read (written by the stress
// half).
int nst_mevp_velocity_halo(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                           float* inv_drag, float* beta, const void* const* consts,
                           const float* strip_x, const float* strip_y, const float* metric_x,
                           const float* metric_y, int nx, int ny, int form, const float* scalars,
                           int device, void* stream) {
  return nst::launch_halo(1, u, v, s11, s22, s12, c_w, inv_drag, beta, consts, strip_x, strip_y,
                          metric_x, metric_y, nx, ny, form, scalars, device, stream);
}

}  // extern "C"
