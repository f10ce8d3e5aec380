// The dG0 forms of fused_dynamics (rk1 by default; no limiter acts at dG0):
// fused_dynamics.cuh's fused_dynamics_forms_kernel, which replaces, with
// fused_dynamics.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas.
// Its 4 instances: fixed or adaptive alpha, the consts resident or not; each axis
// closed or periodic, the stresses A-weighted or not and the coastline or
// none at run time. Compiled beside the other sources, in parallel.
#include "fused_dynamics.cuh"

namespace nst {

const void* fused_forms_dg0(bool adaptive, int n_resident) {
  return fused_forms_kernel_of<0, false>(adaptive, n_resident);
}

}  // namespace nst
