// The A-weighted and periodic instances of ho_single (ho_single.cuh), which
// replaces, with ho_single.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py::ho_subcycles_pallas in
// those forms: the four a_{k} const planes weight the ocean drag, and the
// tiles along a periodic axis form a ring. Compiled beside ho_single.cu,
// which dispatches to them.
#include "ho_single.cuh"

namespace nst {

template <bool kConstsShared>
HoSingleKernel ho_single_form(int form) {
  switch (form) {
    case kHoWeighted: return ho_single_kernel<kConstsShared, kHoWeighted, false>;
    case kWrapX << kFormWrapShift:
    case kWrapY << kFormWrapShift:
    case (kWrapX | kWrapY) << kFormWrapShift: return ho_single_kernel<kConstsShared, 0, true>;
    case kHoWeighted | kWrapX << kFormWrapShift:
    case kHoWeighted | kWrapY << kFormWrapShift:
    case kHoWeighted | (kWrapX | kWrapY) << kFormWrapShift:
      return ho_single_kernel<kConstsShared, kHoWeighted, true>;
    default: return nullptr;
  }
}

HoSingleKernel ho_single_forms_of(bool consts_shared, int form) {
  return consts_shared ? ho_single_form<true>(form) : ho_single_form<false>(form);
}

}  // namespace nst
