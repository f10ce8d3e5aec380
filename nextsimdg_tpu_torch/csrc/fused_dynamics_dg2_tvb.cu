// The dG2 forms of fused_dynamics with the TVB limiter (rk3 by default):
// fused_dynamics.cuh's fused_dynamics_forms_kernel, which replaces, with
// fused_dynamics.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas.
// Its 2 instances: fixed or adaptive alpha, the consts resident (dG2's tiles
// always keep them); each axis
// closed or periodic, the stresses A-weighted or not and the coastline or
// none at run time. Compiled beside the other sources, in parallel.
#include "fused_dynamics.cuh"

namespace nst {

const void* fused_forms_dg2_tvb(bool adaptive, int n_resident) {
  return fused_forms_kernel_of<2, true>(adaptive, n_resident);
}

}  // namespace nst
