// The A-weighted and metric forms of the HO halves' halo kernels
// (ho_halves_spmd.cuh): the four a_{k} const planes weight the ocean drag,
// and on a graded or spherical mesh the strain reads the element's
// reciprocal widths and the forces each element's widths (beyond the block
// from the -1 neighbours' strips). Replaces, with ho_halves_spmd.cu, the TPU
// kernel nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py::ho_subcycles_pallas
// on the JAX package's width-1 ("xla") schedule of a rank grid in those
// forms; compiled beside ho_halves_spmd.cu, which dispatches to them.
#include "ho_halves_spmd.cuh"

namespace nst {

HoHaloKernel ho_halo_forms_of(int half, int form) {
  switch (form) {
    case kHoWeighted: return ho_halo_kernel_of<kHoWeighted>(half);
    case kHoMetric: return ho_halo_kernel_of<kHoMetric>(half);
    case kHoWeighted | kHoMetric: return ho_halo_kernel_of<kHoWeighted | kHoMetric>(half);
    default: return nullptr;
  }
}

}  // namespace nst
