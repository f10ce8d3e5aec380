// The TVB slope limiter of the DG transport on Hopper (dG1, dG2): the
// staged transport's TVB form.
//
// Replaces the TVB part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas,
// whose limited stages run transport.step(..., limit=True): with tvb_m set,
// limit_positivity(limit_slopes(stage)) after every SSP-RK stage
// (nextsimdg_tpu/dynamics/transport.py, limit_slopes). The limiter of an
// element reads its four neighbours' means after the stage, which other
// blocks of a grid-wide launch compute, so here a TVB stage is two
// launches:
//
//   dg1_rk_stage   its unlimited 3-tracer instances (kLimit false, with the
//                  face masks; every form of transport.cu's limited ones):
//                  out = a*base + b*(psi + dt*rhs(psi)), not limited.
//   dg1_limit      (elements) in place on that output: per element and
//                  tracer, the minmod of each linear moment against the
//                  forward and backward mean differences unless within
//                  the tolerance M dx^2, at dG2 the quadratic moments zeroed
//                  where a linear moment was cut, then the positivity
//                  limiter (dg_tvb_limit of dg1_body.cuh, whose operations
//                  are the plain version's). It reads the neighbours' means
//                  and writes only an element's own higher moments, which
//                  no other thread reads, so it runs in place. Closed walls
//                  take zero-gradient ghosts; periodic axes wrap. The
//                  tolerance is a launch scalar on a uniform mesh and the
//                  transport's (nx, ny) planes on a graded or spherical one.
//
// What bounds dg1_limit on the H100: its bytes, K planes a tracer read and
// K - 1 written, the 4 neighbour means mostly from L1/L2: ~1 us at 256^2
// dG1 on the data sheet's 3.35 TB/s; the launch itself at that size.
//
// The unlimited stage instances live here, and not in transport.cu, so
// that nvcc compiles the two sources in parallel.
#include <cstring>

#include "dg1_limit.cuh"
#include "dg1_stage.cuh"

namespace nst {

template <int kDeg>
cudaError_t run_stage_unlimited(const StageArgs<kDeg>& g, bool metric, bool qv, bool blend,
                                cudaStream_t s) {
  constexpr int T = kStageTracers;
  if (metric) {
    if (qv) {
      return blend ? launch_stage<kDeg, T, true, true, true, false>(g, s)
                   : launch_stage<kDeg, T, true, true, false, false>(g, s);
    }
    return blend ? launch_stage<kDeg, T, true, false, true, false>(g, s)
                 : launch_stage<kDeg, T, true, false, false, false>(g, s);
  }
  if (qv) {
    return blend ? launch_stage<kDeg, T, false, true, true, false>(g, s)
                 : launch_stage<kDeg, T, false, true, false, false>(g, s);
  }
  return blend ? launch_stage<kDeg, T, false, false, true, false>(g, s)
               : launch_stage<kDeg, T, false, false, false, false>(g, s);
}

template cudaError_t run_stage_unlimited<1>(const StageArgs<1>&, bool, bool, bool, cudaStream_t);
template cudaError_t run_stage_unlimited<2>(const StageArgs<2>&, bool, bool, bool, cudaStream_t);

template <int kDeg>
int limit_call(float* psi, const float* tol_x, const float* tol_y, float tol_x0, float tol_y0,
               int nx, int ny, int n_tracers, int wrap, const float* tables,
               cudaStream_t stream) {
  LimitArgs<kDeg> g = {};
  g.psi = psi;
  g.tol_x = tol_x;
  g.tol_y = tol_y;
  g.nx = nx;
  g.ny = ny;
  g.n_tracers = n_tracers;
  g.wrap = wrap;
  g.tol_x0 = tol_x0;
  g.tol_y0 = tol_y0;
  std::memcpy(&g.tb, tables, sizeof(g.tb));
  const auto kernel = tol_x != nullptr ? dg1_limit_kernel<kDeg, true> : dg1_limit_kernel<kDeg, false>;
  kernel<<<plane_grid(nx, ny), plane_block(), 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

// TVB, then positivity, in place on psi (K, n_tracers, nx, ny) at `degree`
// (1 or 2; tables: its DgTables): the tolerances tol_x0 and tol_y0 on a
// uniform mesh (tol_x and tol_y null), else the (nx, ny) planes tol_x and
// tol_y (both given); wrap: the periodic axes (kWrapX, kWrapY), closed
// axes taking zero-gradient ghosts. Returns cudaGetLastError(); does not
// synchronise.
int nst_dg1_limit(float* psi, const float* tol_x, const float* tol_y, float tol_x0, float tol_y0,
                  int nx, int ny, int n_tracers, int degree, int wrap, const float* tables,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || n_tracers < 1 || (degree != 1 && degree != 2) || wrap < 0 ||
      wrap > (nst::kWrapX | nst::kWrapY) || (tol_x == nullptr) != (tol_y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return degree == 1 ? nst::limit_call<1>(psi, tol_x, tol_y, tol_x0, tol_y0, nx, ny, n_tracers,
                                          wrap, tables, s)
                     : nst::limit_call<2>(psi, tol_x, tol_y, tol_x0, tol_y0, nx, ny, n_tracers,
                                          wrap, tables, s);
}

}  // extern "C"
