// The halo form of dg1_rk_stage (dg1_stage.cuh): one SSP-RK stage of a rank
// block of a rank grid, on the block widened by one ring of ghost cells.
//
// Replaces the RK stages of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas as
// the JAX package's staged spmd transport runs them on a rank grid
// (nextsimdg_tpu/dynamics/transport.py DGTransport.rhs under shard_map: every
// neighbour shift a width-1 ppermute, only the block at a global first row
// or column closing its wall face; the path of TVB on a graded or spherical
// mesh, and of transport_backend "xla"). Here the host widens psi by one
// ring through the exchange before each stage (the velocity or the qv
// samples, the face masks and the metric planes once a step), and each
// launch computes the block's own elements from the widened block: the
// fluxes of the faces between the block and the ring use the ring's
// coefficients, velocity, face masks and face lengths, which are the
// neighbour rank's own, so each face's flux is the single domain's. The
// global walls come as the widened block's indices (transport_tiled's
// wall[4]): the first wall's element's left (bottom) face and the last
// wall's element's right (top) face carry no flux, as the single domain's
// domain edges. A periodic axis needs no form of its own: its wrap arrives
// in the ring, through the exchange's ring of ranks. base and out are the
// block's own, unwidened.
//
// The instances: the coupled step's 3 tracers with face masks, positivity-
// limited or (dG1, dG2) the TVB form's unlimited stage (dg1_limit's halo
// form follows), on a uniform or a graded or spherical mesh, dG0 to dG2;
// this source the CG1 velocity's, transport_spmd_qv.cu the HO path's qv
// form. In sources of their own so that the closed instances keep their
// code; the kernel's copies are 4 bytes wide (the own block starts one cell
// into a widened row, so no 16-byte copy is aligned).
#include <cstring>

#include "dg1_stage.cuh"

namespace nst {

template <int kDeg>
cudaError_t run_stage_halo(const StageArgs<kDeg>& g, bool metric, bool qv, bool blend, int mode,
                           cudaStream_t s) {
  constexpr int T = kStageTracers;
  if (qv) return run_stage_halo_qv<kDeg>(g, metric, blend, mode, s);
  if (mode == kStageLimited) {
    if (metric) {
      return blend ? launch_stage<kDeg, T, true, false, true, true, false, true>(g, s)
                   : launch_stage<kDeg, T, true, false, false, true, false, true>(g, s);
    }
    return blend ? launch_stage<kDeg, T, false, false, true, true, false, true>(g, s)
                 : launch_stage<kDeg, T, false, false, false, true, false, true>(g, s);
  }
  if constexpr (kDeg == 0) {
    return cudaErrorInvalidValue;  // dG0 has no slopes: its stage limits in place
  } else {
    if (mode != kStageUnlimited) return cudaErrorInvalidValue;
    if (metric) {
      return blend ? launch_stage<kDeg, T, true, false, true, false, false, true>(g, s)
                   : launch_stage<kDeg, T, true, false, false, false, false, true>(g, s);
    }
    return blend ? launch_stage<kDeg, T, false, false, true, false, false, true>(g, s)
                 : launch_stage<kDeg, T, false, false, false, false, false, true>(g, s);
  }
}

template cudaError_t run_stage_halo<0>(const StageArgs<0>&, bool, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_halo<1>(const StageArgs<1>&, bool, bool, bool, int, cudaStream_t);
template cudaError_t run_stage_halo<2>(const StageArgs<2>&, bool, bool, bool, int, cudaStream_t);

template <int kDeg>
int halo_stage_call(const float* psi, const float* base, const float* u, const float* v,
                    const float* face_x, const float* face_y, const void* const* metric,
                    const void* const* qv, float* out, int nx, int ny, int mode, const int* walls,
                    float a, float b, float dt, const float* tables, cudaStream_t stream) {
  StageArgs<kDeg> g = stage_args<kDeg>(psi, base, u, v, face_x, face_y, metric, qv, out, nx, ny,
                                       mode, 0, a, b, dt, tables);
  for (int w = 0; w < 4; ++w) g.wall[w] = walls[w];
  return static_cast<int>(
      run_stage_halo<kDeg>(g, metric != nullptr, qv != nullptr, a != 0.0f, mode, stream));
}

}  // namespace nst

extern "C" {

// One SSP-RK stage of a rank block in the halo form, at `degree` (0, 1 or
// 2; tables: its DgTables): psi (K, 3, nx, ny), the velocity u, v (or the
// qv planes), face_x, face_y and the metric planes are the block widened by
// one ring (nx, ny the widened shape); base and out (K, 3, nx - 2, ny - 2)
// the block's own, out may alias base, not psi; base is read only where
// a != 0. mode kStageLimited (positivity-limited) or kStageUnlimited (dG1
// and dG2, the TVB form's stage: dg1_limit's halo form follows). walls: 4
// ints, the widened block's row of the last x wall's elements, the row of
// the first's, then the columns of y's, -1 for none (no face there is a
// wall). metric, qv: as nst_dg1_rk_stage's. Returns cudaGetLastError();
// does not synchronise.
int nst_dg1_rk_stage_halo(const float* psi, const float* base, const float* u, const float* v,
                          const float* face_x, const float* face_y, const void* const* metric,
                          const void* const* qv, float* out, int nx, int ny, int n_tracers,
                          int degree, int mode, const int* walls, float a, float b, float dt,
                          const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool form_ok = (mode == nst::kStageLimited || (mode == nst::kStageUnlimited && degree > 0)) &&
                       n_tracers == nst::kStageTracers && face_x && face_y && walls &&
                       (qv != nullptr || (u && v));
  if (nx < 3 || ny < 3 || !form_ok || degree < 0 || degree > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (degree) {
    case 0:
      return nst::halo_stage_call<0>(psi, base, u, v, face_x, face_y, metric, qv, out, nx, ny,
                                     mode, walls, a, b, dt, tables, s);
    case 1:
      return nst::halo_stage_call<1>(psi, base, u, v, face_x, face_y, metric, qv, out, nx, ny,
                                     mode, walls, a, b, dt, tables, s);
    default:
      return nst::halo_stage_call<2>(psi, base, u, v, face_x, face_y, metric, qv, out, nx, ny,
                                     mode, walls, a, b, dt, tables, s);
  }
}

}  // extern "C"
