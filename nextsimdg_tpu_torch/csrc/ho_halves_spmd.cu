// The higher-order (CG2 velocity, dG1 stress) mEVP subcycle of a rank
// block of a rank grid as two launches, each behind a width-1 strip
// exchange: the two halves of the subcycle that ho_single and ho_tiled run
// inside one launch, as grid-wide halo kernels.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py::ho_subcycles_pallas as
// the JAX package runs its subcycle on a rank grid on the width-1 ("xla")
// schedule (nextsimdg_tpu/dynamics/mevp_ho.py MEVPSolverHO under shard_map:
// every shift of the CG2 gather and scatter a width-1 ppermute). Here the
// host exchanges the strips that a half reads beyond the rank's block once
// before it (coupled_cuda.py spmd_xla_ho_subcycles), and one launch
// computes the block, one thread an element or node index, the 17 state
// planes in global memory:
//
//   ho_stress    (elements): ho_gather of the 8 CG2 velocity planes
//                (node indices i..i+1, j..j+1; beyond the block the +1
//                neighbours' first row and their first column extended by
//                one row, whose last cell is the diagonal rank's corner),
//                then ho_stress_body: the element's 9 dG1 stress
//                coefficients, in place.
//   ho_velocity  (node indices): ho_node_forces on the four elements around
//                the node (i-1..i, j-1..j; beyond the block the -1
//                neighbours' last row and column of the 9 stress planes,
//                and in the metric form of the widths dx and dy, exchanged
//                once a step), then ho_velocity_body: the node's 8 velocity
//                values, in place.
//
// The bodies are ho_body.cuh's, unchanged and in ho_single's order, so a
// block equals the single domain's block bit for bit. A closed global
// wall's strips are zeros (the single domain's reads beyond its edge); a
// periodic axis arrives through the exchange's ring of ranks, so the
// instances are the forms only: unweighted and A-weighted (kHoWeighted),
// uniform and metric (kHoMetric). In place is safe as in ho_single's
// phases: the stress half writes only stresses and reads velocities, the
// velocity half the other way round. In sources of their own: this one the
// unweighted uniform form and the entry points, ho_halves_spmd_forms.cu the
// others.
//
// What bounds it on the H100: at a 2048^2 block the stress half moves 29
// planes and the velocity half 55 (0.145 and 0.275 ms at 3.35 TB/s); their
// metric forms took 0.174 and 0.331 ms of device time there (chip_smoke.py,
// H100 80GB HBM3 at 700 W), at 56-64 registers without spills.
#include <cstring>

#include "ho_halves_spmd.cuh"

namespace nst {

int launch_ho_halo(int half, float* state, const void* const* consts, const float* strip_x,
                   const float* strip_y, const float* width_x, const float* width_y, int nx,
                   int ny, int form, const float* scalars, const float* tables, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || form < 0 || form > (kHoWeighted | kHoMetric) || strip_x == nullptr ||
      strip_y == nullptr || (width_x == nullptr) != (width_y == nullptr) ||
      (half == 1 && (form & kHoMetric) != 0) != (width_x != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HoHaloArgs a;
  a.state = state;
  std::memcpy(&a.k, consts, sizeof(a.k));
  a.strip_x = strip_x;
  a.strip_y = strip_y;
  a.width_x = width_x;
  a.width_y = width_y;
  a.nx = nx;
  a.ny = ny;
  std::memcpy(&a.s, scalars, sizeof(a.s));
  std::memcpy(&a.t, tables, sizeof(a.t));
  if (((form & kHoWeighted) != 0) != (a.k.a[0] != nullptr) ||
      ((form & kHoMetric) != 0) != (a.k.dx != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const HoHaloKernel kernel =
      form == 0 ? ho_halo_kernel_of<0>(half) : ho_halo_forms_of(half, form);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  kernel<<<plane_grid(nx, ny), plane_block(), 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

// Each entry point launches one HO half on `stream` in place on the rank's
// own (17, nx, ny) state and returns cudaGetLastError(); it does not
// synchronise. consts: the 37 const-plane pointers of HoConsts (the block's
// own; the a_{k} null outside the weighted form, the widths outside the
// metric form); form: kHoWeighted and kHoMetric, no periodic bits; scalars
// and tables: HoScalars and HoTables. The stress half's strip_x, strip_y:
// the +1 strips of the 8 velocity planes (8 x ny and 8 x (nx + 1) floats).
int nst_ho_stress(float* state, const void* const* consts, const float* strip_x,
                  const float* strip_y, int nx, int ny, int form, const float* scalars,
                  const float* tables, int device, void* stream) {
  return nst::launch_ho_halo(0, state, consts, strip_x, strip_y, nullptr, nullptr, nx, ny, form,
                             scalars, tables, device, stream);
}

// The velocity half: strip_x, strip_y the -1 strips of the 9 stress planes
// (9 x ny and 9 x (nx + 1) floats); width_x, width_y those of dx and dy
// (2 x ny and 2 x (nx + 1)) in the metric form, null in the others.
int nst_ho_velocity(float* state, const void* const* consts, const float* strip_x,
                    const float* strip_y, const float* width_x, const float* width_y, int nx,
                    int ny, int form, const float* scalars, const float* tables, int device,
                    void* stream) {
  return nst::launch_ho_halo(1, state, consts, strip_x, strip_y, width_x, width_y, nx, ny, form,
                             scalars, tables, device, stream);
}

}  // extern "C"
