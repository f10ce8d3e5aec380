// The metric instances of ho_single (ho_single.cuh), which replaces, with
// ho_single.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py::ho_subcycles_pallas on a
// graded or spherical mesh, where its element widths ride the kernel as
// four more const planes (dx, dy, inv_dx, inv_dy): unweighted or A-weighted,
// closed or periodic on either axis (the ring of a 360 degree lon-lat mesh).
// Compiled beside ho_single.cu, which dispatches to them.
#include "ho_single.cuh"

namespace nst {

template <bool kConstsShared>
HoSingleKernel ho_single_metric_form(int form) {
  constexpr int kWeightedMetric = kHoWeighted | kHoMetric;
  switch (form) {
    case kHoMetric: return ho_single_kernel<kConstsShared, kHoMetric, false>;
    case kWeightedMetric: return ho_single_kernel<kConstsShared, kWeightedMetric, false>;
    case kHoMetric | kWrapX << kFormWrapShift:
    case kHoMetric | kWrapY << kFormWrapShift:
    case kHoMetric | (kWrapX | kWrapY) << kFormWrapShift:
      return ho_single_kernel<kConstsShared, kHoMetric, true>;
    case kWeightedMetric | kWrapX << kFormWrapShift:
    case kWeightedMetric | kWrapY << kFormWrapShift:
    case kWeightedMetric | (kWrapX | kWrapY) << kFormWrapShift:
      return ho_single_kernel<kConstsShared, kWeightedMetric, true>;
    default: return nullptr;
  }
}

HoSingleKernel ho_single_metric_of(bool consts_shared, int form) {
  return consts_shared ? ho_single_metric_form<true>(form) : ho_single_metric_form<false>(form);
}

}  // namespace nst
