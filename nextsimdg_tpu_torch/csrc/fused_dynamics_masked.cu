// The coastline form of fused_dynamics (fused_dynamics.cuh), which replaces,
// with fused_dynamics.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas
// with its two face-mask const planes: the masks are resident beside the
// tracers and multiply every face flux. Compiled beside fused_dynamics.cu's
// form without masks, in parallel.
#include "fused_dynamics.cuh"

namespace nst {

const void* fused_kernel_masked(int n_resident) { return fused_kernel_of<true>(n_resident); }

}  // namespace nst
