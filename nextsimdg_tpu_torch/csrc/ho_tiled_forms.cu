// The A-weighted and periodic instances of ho_tiled (ho_tiled.cuh), which
// replaces, with ho_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py::ho_subcycles_tiled in
// those forms: the four a_{k} const planes weight the ocean drag, and the
// ghost-zone windows wrap on the launch's periodic axes. Compiled beside
// ho_tiled.cu, which dispatches to them.
#include "ho_tiled.cuh"

namespace nst {

template <int kS>
HoTiledKernel ho_tiled_form(int form) {
  switch (form) {
    case kHoWeighted: return ho_tiled_kernel<kS, kHoWeighted, false>;
    case kWrapX << kFormWrapShift:
    case kWrapY << kFormWrapShift:
    case (kWrapX | kWrapY) << kFormWrapShift: return ho_tiled_kernel<kS, 0, true>;
    case kHoWeighted | kWrapX << kFormWrapShift:
    case kHoWeighted | kWrapY << kFormWrapShift:
    case kHoWeighted | (kWrapX | kWrapY) << kFormWrapShift:
      return ho_tiled_kernel<kS, kHoWeighted, true>;
    default: return nullptr;
  }
}

HoTiledKernel ho_tiled_forms_of(int sub, int form) {
  return sub == 48 ? ho_tiled_form<48>(form) : ho_tiled_form<0>(form);
}

}  // namespace nst
