// The periodic instances of dg1_rk_stage (dg1_stage.cuh), which replaces,
// with transport.cu and transport_tvb.cu, the RK stages of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas
// on a periodic mesh: the windows wrap on the launch's periodic axes and no
// face is a wall. Compiled beside transport.cu, which dispatches to them;
// the HO path's qv form of the coupled step's stages is compiled in
// transport_periodic_qv.cu.
#include "dg1_stage.cuh"

namespace nst {

template <int kDeg>
cudaError_t run_stage_periodic(const StageArgs<kDeg>& g, bool metric, bool qv, bool blend, int mode,
                               cudaStream_t s) {
  constexpr int T = kStageTracers;
  if (mode == kStageRun) {  // one tracer, the qv form, no masks, no limiter
    if (!qv) return cudaErrorInvalidValue;
    if (metric) {
      return blend ? launch_stage<kDeg, 1, true, true, true, false, true>(g, s)
                   : launch_stage<kDeg, 1, true, true, false, false, true>(g, s);
    }
    return blend ? launch_stage<kDeg, 1, false, true, true, false, true>(g, s)
                 : launch_stage<kDeg, 1, false, true, false, false, true>(g, s);
  }
  if (qv) return run_stage_periodic_qv<kDeg>(g, metric, blend, mode, s);  // the HO path
  if (mode == kStageUnlimited) {
    if constexpr (kDeg == 0) {
      return cudaErrorInvalidValue;
    } else {
      if (metric) {
        return blend ? launch_stage<kDeg, T, true, false, true, false, true>(g, s)
                     : launch_stage<kDeg, T, true, false, false, false, true>(g, s);
      }
      return blend ? launch_stage<kDeg, T, false, false, true, false, true>(g, s)
                   : launch_stage<kDeg, T, false, false, false, false, true>(g, s);
    }
  }
  if (metric) {
    return blend ? launch_stage<kDeg, T, true, false, true, true, true>(g, s)
                 : launch_stage<kDeg, T, true, false, false, true, true>(g, s);
  }
  return blend ? launch_stage<kDeg, T, false, false, true, true, true>(g, s)
               : launch_stage<kDeg, T, false, false, false, true, true>(g, s);
}

template cudaError_t run_stage_periodic<0>(const StageArgs<0>&, bool, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_periodic<1>(const StageArgs<1>&, bool, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_periodic<2>(const StageArgs<2>&, bool, bool, bool, int, cudaStream_t);

}  // namespace nst
