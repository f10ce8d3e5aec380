// The metric forms of the HO rdma_band (mevp_rdma_ho.cuh), with staged
// consts: a rank block of a graded or spherical mesh, whose element widths
// (dx, dy, inv_dx, inv_dy) are four more widened const planes, unweighted
// or A-weighted, closed or wrapping along the band (the 360 degree ring).
// Replaces, with mevp_rdma_ho.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma in its HO
// instantiation on the 33 and 37 const planes of a LocalMeshView; compiled
// beside mevp_rdma_ho.cu, which dispatches to them.
#include "mevp_rdma_ho.cuh"

namespace nst {

RdmaBandHoKernel rdma_band_ho_metric_of(int long_axis, int form, bool wrap) {
  return rdma_band_ho_form_select<true, true>(long_axis, form, wrap);
}

}  // namespace nst
