// The metric forms of the HO rdma_band (mevp_rdma_ho.cuh): a rank block of a
// graded or spherical mesh, whose element widths (dx, dy, inv_dx, inv_dy)
// are four more widened const planes read by offset, unweighted or
// A-weighted, closed or wrapping along the band (the 360 degree ring).
// Replaces, with mevp_rdma_ho.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma in its HO
// instantiation on the 33 and 37 const planes of a LocalMeshView; compiled
// beside mevp_rdma_ho.cu, which dispatches to them.
#include "mevp_rdma_ho.cuh"

namespace nst {

RdmaBandHoKernel rdma_band_ho_metric_of(int long_axis, int form, bool wrap) {
  constexpr int kWeightedMetric = kHoWeighted | kHoMetric;
  switch (form) {
    case kHoMetric:
      return wrap ? rdma_band_ho_select<kHoMetric, true>(long_axis)
                  : rdma_band_ho_select<kHoMetric, false>(long_axis);
    case kWeightedMetric:
      return wrap ? rdma_band_ho_select<kWeightedMetric, true>(long_axis)
                  : rdma_band_ho_select<kWeightedMetric, false>(long_axis);
    default: return nullptr;
  }
}

}  // namespace nst
