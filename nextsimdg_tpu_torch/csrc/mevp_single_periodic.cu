// The periodic instances of mevp_single (mevp_single.cuh), which replaces,
// with mevp_single.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_pallas.py::mevp_subcycles_pallas in
// its periodic form: the tiles along a periodic axis form a ring. The
// fixed-alpha forms here, the adaptive ones in
// mevp_single_periodic_adaptive.cu, compiled in parallel.
#include "mevp_single.cuh"

namespace nst {

const void* single_kernel_periodic(bool metric, int form, int n_resident) {
  switch (form) {
    case 0: return single_kernel_of<0, true>(metric, n_resident);
    case kFormWeighted: return single_kernel_of<kFormWeighted, true>(metric, n_resident);
    default: return single_kernel_periodic_adaptive(metric, form, n_resident);
  }
}

}  // namespace nst
