// The periodic instances of mevp_single's adaptive-alpha forms
// (mevp_single.cuh), which replaces, with mevp_single.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_pallas.py::mevp_subcycles_pallas in
// its periodic form.
#include "mevp_single.cuh"

namespace nst {

const void* single_kernel_periodic_adaptive(bool metric, int form, int n_resident) {
  switch (form) {
    case kFormAdaptive: return single_kernel_of<kFormAdaptive, true>(metric, n_resident);
    case kFormWeighted | kFormAdaptive:
      return single_kernel_of<kFormWeighted | kFormAdaptive, true>(metric, n_resident);
    default: return nullptr;
  }
}

}  // namespace nst
