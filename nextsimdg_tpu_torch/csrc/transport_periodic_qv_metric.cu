// The periodic metric instances of dg1_rk_stage (dg1_stage.cuh) in the HO
// path's qv form, which replace, with transport.cu, the RK stages of the TPU
// kernel nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas
// for the higher-order solver's staged transport on a periodic graded or
// spherical mesh (the 360 degree lon-lat ring): the coupled step's 3
// tracers and face masks, the velocity from the CG2 quadrature samples, the
// transport's 5 metric planes, the windows wrapped on the launch's periodic
// axes; positivity-limited, or unlimited for the TVB form (dg1_limit
// follows, with its tolerance planes). In a source of their own so that the
// build's sources take similar times; transport_periodic_qv.cu dispatches
// to them.
#include "dg1_stage.cuh"

namespace nst {

template <int kDeg>
cudaError_t run_stage_periodic_qv_metric(const StageArgs<kDeg>& g, bool blend, int mode,
                                         cudaStream_t s) {
  constexpr int T = kStageTracers;
  if (mode == kStageLimited) {
    return blend ? launch_stage<kDeg, T, true, true, true, true, true>(g, s)
                 : launch_stage<kDeg, T, true, true, false, true, true>(g, s);
  }
  if constexpr (kDeg == 0) {
    return cudaErrorInvalidValue;  // dG0 has no slopes to limit
  } else {
    if (mode != kStageUnlimited) return cudaErrorInvalidValue;
    return blend ? launch_stage<kDeg, T, true, true, true, false, true>(g, s)
                 : launch_stage<kDeg, T, true, true, false, false, true>(g, s);
  }
}

template cudaError_t run_stage_periodic_qv_metric<0>(const StageArgs<0>&, bool, int, cudaStream_t);
template cudaError_t run_stage_periodic_qv_metric<1>(const StageArgs<1>&, bool, int, cudaStream_t);
template cudaError_t run_stage_periodic_qv_metric<2>(const StageArgs<2>&, bool, int, cudaStream_t);

}  // namespace nst
