// The metric instances of ho_tiled (ho_tiled.cuh), which replaces, with
// ho_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_tiled.py::ho_subcycles_tiled on a
// graded or spherical mesh, where its element widths ride the kernel as
// four more const planes (dx, dy, inv_dx, inv_dy): unweighted or
// A-weighted, closed or periodic on either axis (the ring of a 360 degree
// lon-lat mesh). Compiled beside ho_tiled.cu, which dispatches to them.
#include "ho_tiled.cuh"

namespace nst {

template <int kS>
HoTiledKernel ho_tiled_metric_form(int form) {
  constexpr int kWeightedMetric = kHoWeighted | kHoMetric;
  switch (form) {
    case kHoMetric: return ho_tiled_kernel<kS, kHoMetric, false>;
    case kWeightedMetric: return ho_tiled_kernel<kS, kWeightedMetric, false>;
    case kHoMetric | kWrapX << kFormWrapShift:
    case kHoMetric | kWrapY << kFormWrapShift:
    case kHoMetric | (kWrapX | kWrapY) << kFormWrapShift: return ho_tiled_kernel<kS, kHoMetric, true>;
    case kWeightedMetric | kWrapX << kFormWrapShift:
    case kWeightedMetric | kWrapY << kFormWrapShift:
    case kWeightedMetric | (kWrapX | kWrapY) << kFormWrapShift:
      return ho_tiled_kernel<kS, kWeightedMetric, true>;
    default: return nullptr;
  }
}

HoTiledKernel ho_tiled_metric_of(int sub, int form) {
  return sub == 48 ? ho_tiled_metric_form<48>(form) : ho_tiled_metric_form<0>(form);
}

}  // namespace nst
