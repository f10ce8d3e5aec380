// The metric and momentum forms of the CG1 mEVP halves' halo forms
// (mevp_spmd.cuh): a rank block of a graded or spherical mesh (the metric
// const planes, and half_dx and half_dy of the -1 neighbours' strips), and
// the A-weighted and adaptive subcycle bodies. Replaces, with mevp_spmd.cu,
// the mEVP part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas on
// the JAX package's width-1 ("xla") schedule of a rank grid in those forms;
// compiled beside mevp_spmd.cu, which dispatches to them.
#include "mevp_spmd.cuh"

namespace nst {

template <bool kMetric>
HaloKernel halo_form_of(int half, int form) {
  switch (form) {
    case 0:
      // The uniform form 0 is mevp_spmd.cu's (not instantiated here).
      if constexpr (kMetric) return halo_kernel_of<true, 0>(half);
      return nullptr;
    case kFormWeighted: return halo_kernel_of<kMetric, kFormWeighted>(half);
    case kFormAdaptive: return halo_kernel_of<kMetric, kFormAdaptive>(half);
    case kFormWeighted | kFormAdaptive:
      return halo_kernel_of<kMetric, kFormWeighted | kFormAdaptive>(half);
    default: return nullptr;
  }
}

HaloKernel mevp_halo_forms_of(int half, bool metric, int form) {
  return metric ? halo_form_of<true>(half, form) : halo_form_of<false>(half, form);
}

}  // namespace nst
