// The adaptive-alpha forms of mevp_single, which replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_pallas.py::mevp_subcycles_pallas
// (mevp_single.cuh holds the kernel template): the instances of
// kFormAdaptive and kFormWeighted | kFormAdaptive, compiled beside
// mevp_single.cu's fixed-alpha ones so that nvcc builds the two halves of
// the kernel's 32 instances in parallel.
#include "mevp_single.cuh"

namespace nst {

const void* single_kernel_adaptive(bool metric, int form, int n_resident) {
  switch (form) {
    case kFormAdaptive: return single_kernel_of<kFormAdaptive>(metric, n_resident);
    case kFormWeighted | kFormAdaptive: return single_kernel_of<kFormWeighted | kFormAdaptive>(metric, n_resident);
    default: return nullptr;
  }
}

}  // namespace nst
