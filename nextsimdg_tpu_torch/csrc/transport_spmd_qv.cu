// The halo form of dg1_rk_stage (dg1_stage.cuh) in the HO path's qv form:
// one SSP-RK stage of a rank block widened by one ring, the velocity from
// the CG2 quadrature samples widened with it (their ring the neighbour
// ranks' own samples). Replaces, with transport_spmd.cu (which dispatches to
// these instances and describes the form), the RK stages of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas as
// the JAX package's staged spmd transport runs the higher-order solver's
// tracers: positivity-limited, or (dG1, dG2) the TVB form's unlimited
// stage, on a uniform or a graded or spherical mesh.
#include "dg1_stage.cuh"

namespace nst {

template <int kDeg>
cudaError_t run_stage_halo_qv(const StageArgs<kDeg>& g, bool metric, bool blend, int mode,
                              cudaStream_t s) {
  constexpr int T = kStageTracers;
  if (mode == kStageLimited) {
    if (metric) {
      return blend ? launch_stage<kDeg, T, true, true, true, true, false, true>(g, s)
                   : launch_stage<kDeg, T, true, true, false, true, false, true>(g, s);
    }
    return blend ? launch_stage<kDeg, T, false, true, true, true, false, true>(g, s)
                 : launch_stage<kDeg, T, false, true, false, true, false, true>(g, s);
  }
  if constexpr (kDeg == 0) {
    return cudaErrorInvalidValue;  // dG0 has no slopes to limit
  } else {
    if (mode != kStageUnlimited) return cudaErrorInvalidValue;
    if (metric) {
      return blend ? launch_stage<kDeg, T, true, true, true, false, false, true>(g, s)
                   : launch_stage<kDeg, T, true, true, false, false, false, true>(g, s);
    }
    return blend ? launch_stage<kDeg, T, false, true, true, false, false, true>(g, s)
                 : launch_stage<kDeg, T, false, true, false, false, false, true>(g, s);
  }
}

template cudaError_t run_stage_halo_qv<0>(const StageArgs<0>&, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_halo_qv<1>(const StageArgs<1>&, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_halo_qv<2>(const StageArgs<2>&, bool, bool, int, cudaStream_t);

}  // namespace nst
