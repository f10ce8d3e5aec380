// The A-weighted form and the ring of the HO rdma_band (mevp_rdma_ho.cuh)
// on a uniform mesh, with staged consts: the four a_{k} const planes weight
// the ocean drag, and the band wraps along a periodic axis not split over
// ranks. Replaces, with mevp_rdma_ho.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma in its HO
// instantiation in those forms; compiled beside mevp_rdma_ho.cu, which
// dispatches to them.
#include "mevp_rdma_ho.cuh"

namespace nst {

RdmaBandHoKernel rdma_band_ho_forms_of(int long_axis, int form, bool wrap) {
  switch (form) {
    // The closed unweighted form is mevp_rdma_ho.cu's (not instantiated here).
    case 0: return wrap ? rdma_band_ho_select<0, true, true>(long_axis) : nullptr;
    case kHoWeighted:
      return wrap ? rdma_band_ho_select<kHoWeighted, true, true>(long_axis)
                  : rdma_band_ho_select<kHoWeighted, false, true>(long_axis);
    default: return nullptr;
  }
}

}  // namespace nst
