// Every form of the HO rdma_band (mevp_rdma_ho.cuh) with its consts in
// global memory, read by offset from the rank's widened const planes at
// their use (kStaged false: blocks of up to 256 threads, three an SM): the
// launches whose 29-37 const planes do not fit beside the 17 state planes
// in a block's shared memory (ghost widths above 32), or whose blocks ran
// faster so than with staged consts (the 2048^2 blocks, h = 32:
// mevp_rdma_cuda.HO_BANDS). Replaces, with mevp_rdma_ho.cu, the
// TPU kernel nextsimdg_tpu/dynamics/kernels/mevp_rdma.py::mevp_round_rdma
// in its HO instantiation at those widths; compiled beside mevp_rdma_ho.cu,
// which dispatches to them.
#include "mevp_rdma_ho.cuh"

namespace nst {

RdmaBandHoKernel rdma_band_ho_l2_of(int long_axis, int form, bool wrap) {
  return (form & kHoMetric) != 0 ? rdma_band_ho_form_select<true, false>(long_axis, form, wrap)
                                 : rdma_band_ho_form_select<false, false>(long_axis, form, wrap);
}

}  // namespace nst
