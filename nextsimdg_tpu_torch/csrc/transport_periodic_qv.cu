// The periodic instances of dg1_rk_stage (dg1_stage.cuh) in the HO path's qv
// form, which replace, with transport.cu, the RK stages of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas
// for the higher-order solver's staged transport on a periodic mesh: the
// coupled step's 3 tracers and face masks, the velocity from the CG2
// quadrature samples, the windows wrapped on the launch's periodic axes;
// positivity-limited, or unlimited for the TVB form (dg1_limit follows).
// Compiled beside transport_periodic.cu, which dispatches to them; those of
// a graded or spherical mesh are compiled in transport_periodic_qv_metric.cu.
#include "dg1_stage.cuh"

namespace nst {

template <int kDeg>
cudaError_t run_stage_periodic_qv(const StageArgs<kDeg>& g, bool metric, bool blend, int mode,
                                  cudaStream_t s) {
  constexpr int T = kStageTracers;
  if (metric) return run_stage_periodic_qv_metric<kDeg>(g, blend, mode, s);
  if (mode == kStageLimited) {
    return blend ? launch_stage<kDeg, T, false, true, true, true, true>(g, s)
                 : launch_stage<kDeg, T, false, true, false, true, true>(g, s);
  }
  if constexpr (kDeg == 0) {
    return cudaErrorInvalidValue;  // dG0 has no slopes to limit
  } else {
    if (mode != kStageUnlimited) return cudaErrorInvalidValue;
    return blend ? launch_stage<kDeg, T, false, true, true, false, true>(g, s)
                 : launch_stage<kDeg, T, false, true, false, false, true>(g, s);
  }
}

template cudaError_t run_stage_periodic_qv<0>(const StageArgs<0>&, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_periodic_qv<1>(const StageArgs<1>&, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_periodic_qv<2>(const StageArgs<2>&, bool, bool, int, cudaStream_t);

}  // namespace nst
