// The momentum forms and the ring of rdma_band (mevp_rdma.cuh) on a uniform
// mesh: the A-weighted and the adaptive subcycle bodies, and the band that
// wraps along a periodic axis not split over ranks. Replaces, with
// mevp_rdma.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma in those
// forms (its body_fn and its periodic rings); compiled beside mevp_rdma.cu,
// which dispatches to them.
#include "mevp_rdma.cuh"

namespace nst {

RdmaBandKernel rdma_band_forms_of(int long_axis, int threads, int form, bool wrap) {
  if (wrap) return rdma_band_form_select<false, true>(long_axis, threads, form);
  // The closed uniform form 0 is mevp_rdma.cu's (not instantiated here).
  switch (form) {
    case kFormWeighted: return rdma_band_select<false, kFormWeighted, false>(long_axis, threads);
    case kFormAdaptive: return rdma_band_select<false, kFormAdaptive, false>(long_axis, threads);
    case kFormWeighted | kFormAdaptive:
      return rdma_band_select<false, kFormWeighted | kFormAdaptive, false>(long_axis, threads);
    default: return nullptr;
  }
}

}  // namespace nst
