// The halo form of dg1_limit (dg1_limit.cuh): the TVB limiter pass of a rank
// block of a rank grid, whose neighbours' means come from the block widened
// by one ring of ghost cells.
//
// Replaces the TVB part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas as
// the JAX package's staged spmd transport runs it on a rank grid
// (nextsimdg_tpu/dynamics/transport.py DGTransport.limit_slopes under
// shard_map: the neighbours' means through width-1 ppermute shifts, the
// mean differences zeroed only at the global walls, then the positivity
// limiter). Here the host widens the stage's means (coefficient 0 of each
// tracer) by one ring through the exchange, and one launch limits the
// block's own elements in place on its unwidened coefficients: a thread an
// element, the four neighbours' means from the widened plane, the
// differences zeroed at the global walls given as the widened block's
// indices, the tolerances two scalars (a uniform mesh) or the block's own
// two planes (graded, spherical, the ring: each element reads only its
// own). It reads the means, which it never writes, and writes only an
// element's own higher moments, so it runs in place. In a source of its own
// so that the single domain's instances keep their code.
#include <cstring>

#include "dg1_limit.cuh"

namespace nst {

template <int kDeg>
int limit_halo_call(float* psi, const float* means, const float* tol_x, const float* tol_y,
                    float tol_x0, float tol_y0, int nx, int ny, int n_tracers, const int* walls,
                    const float* tables, cudaStream_t stream) {
  LimitArgs<kDeg> g = {};
  g.psi = psi;
  g.means = means;
  g.tol_x = tol_x;
  g.tol_y = tol_y;
  g.nx = nx;
  g.ny = ny;
  g.n_tracers = n_tracers;
  g.tol_x0 = tol_x0;
  g.tol_y0 = tol_y0;
  for (int w = 0; w < 4; ++w) g.wall[w] = walls[w];
  std::memcpy(&g.tb, tables, sizeof(g.tb));
  const auto kernel =
      tol_x != nullptr ? dg1_limit_halo_kernel<kDeg, true> : dg1_limit_halo_kernel<kDeg, false>;
  kernel<<<plane_grid(nx, ny), plane_block(), 0, stream>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

// TVB, then positivity, in place on a rank block's own psi (K, n_tracers,
// nx, ny) at `degree` (1 or 2; tables: its DgTables), the neighbours' means
// from `means` (n_tracers, nx + 2, ny + 2), the stage's means widened by
// one ring; walls: 4 ints, the widened block's row of the last x wall's
// elements, the row of the first's, then the columns of y's, -1 for none;
// the tolerances tol_x0 and tol_y0 on a uniform mesh (tol_x and tol_y
// null), else the block's (nx, ny) planes tol_x and tol_y (both given).
// Returns cudaGetLastError(); does not synchronise.
int nst_dg1_limit_halo(float* psi, const float* means, const float* tol_x, const float* tol_y,
                       float tol_x0, float tol_y0, int nx, int ny, int n_tracers, int degree,
                       const int* walls, const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || n_tracers < 1 || (degree != 1 && degree != 2) || means == nullptr ||
      walls == nullptr || (tol_x == nullptr) != (tol_y == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  return degree == 1 ? nst::limit_halo_call<1>(psi, means, tol_x, tol_y, tol_x0, tol_y0, nx, ny,
                                               n_tracers, walls, tables, s)
                     : nst::limit_halo_call<2>(psi, means, tol_x, tol_y, tol_x0, tol_y0, nx, ny,
                                               n_tracers, walls, tables, s);
}

}  // extern "C"
