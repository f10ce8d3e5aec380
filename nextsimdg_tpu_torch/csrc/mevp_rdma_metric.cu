// The metric round of rdma_band (mevp_rdma.cuh): a rank block of a graded or
// spherical mesh, whose 5 metric planes are read by offset from the rank's
// widened const planes, in every momentum form, closed or wrapping along the
// band. Replaces, with mevp_rdma.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma on the 12 and
// 13 const planes of a LocalMeshView; compiled beside mevp_rdma.cu, which
// dispatches to them.
#include "mevp_rdma.cuh"

namespace nst {

RdmaBandKernel rdma_band_metric_of(int long_axis, int threads, int form, bool wrap) {
  return wrap ? rdma_band_form_select<true, true>(long_axis, threads, form)
              : rdma_band_form_select<true, false>(long_axis, threads, form);
}

}  // namespace nst
