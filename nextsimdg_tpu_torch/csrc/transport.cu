// dG1 tracer transport on Hopper: CFL speeds and one limited SSP-RK stage.
//
// Replaces the transport part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas
// (velocity_from_cg, cfl_substeps and k limited DGTransport.step calls on
// the stacked (K=3, T, nx, ny) tracers, all resident on one core):
//
//   dg1_sample_cfl (elements): samples the CG1 velocity at the 2x2 volume
//                  points and the 2 points of the element's left and bottom
//                  faces, reduces max |vx| and max |vy| per block and folds
//                  them into two device scalars with atomicMax on the float
//                  bits (valid because the values are >= 0). The host turns
//                  them into k with the same torch operations as the plain
//                  cfl_substeps, so equal speeds give an equal k. It samples
//                  the first ex x ey elements of node planes of nx x ny
//                  nodes with a row stride ld: on a rank block, the block's
//                  own elements inside its velocity widened by the halo
//                  exchange, so that the nodes beyond the block are its
//                  neighbours' and not zeros.
//   dg1_rk_stage   (elements): out = lim(a*base + b*(psi + dt*rhs(psi))), or
//                  lim(psi + dt*rhs(psi)) when a == 0, for all T tracers x 3
//                  dofs. It re-samples the velocity from u and v instead of
//                  reading 12 quadrature planes, zeroes the global x = 0 and
//                  y = 0 wall faces, multiplies the fluxes by the face_x and
//                  face_y planes (all ones without a coastline), on a graded
//                  or spherical mesh reads the transport's 5 metric planes,
//                  and applies the dG1 corner positivity limiter. It reads
//                  its neighbours' psi, so `out` must not alias `psi` (it
//                  may alias `base`).
//
// The tables, the velocity sampling and the per-element stage math live in
// dg1_body.cuh, shared with the tiled schedule of transport_tiled.cu.
//
// What bounds it on the H100: a stage reads u, v, the two face planes and
// 9 coefficient planes with a 5-point stencil, and writes 9 (about 88 bytes
// per element when the neighbours hit in cache); the whole phase at 256^2
// stays in L2, so again launch latency bounds it (2 stages per substep).
// Keeping k on the device and fusing the stages is left for later.
#include <cstring>

#include "dg1_body.cuh"

namespace nst {

__device__ __forceinline__ Corners load_corners(const float* u, const float* v,
                                                int i, int j, int nx, int ny) {
  Corners c;
  c.u00 = at(u, i, j, nx, ny);
  c.u10 = at(u, i + 1, j, nx, ny);
  c.u01 = at(u, i, j + 1, nx, ny);
  c.u11 = at(u, i + 1, j + 1, nx, ny);
  c.v00 = at(v, i, j, nx, ny);
  c.v10 = at(v, i + 1, j, nx, ny);
  c.v01 = at(v, i, j + 1, nx, ny);
  c.v11 = at(v, i + 1, j + 1, nx, ny);
  return c;
}

__device__ __forceinline__ void load_coeffs(const float* psi, int t, int n_tracers,
                                            int i, int j, int nx, int ny,
                                            float c[kDofs]) {
  const long plane = static_cast<long>(nx) * ny;
#pragma unroll
  for (int k = 0; k < kDofs; ++k) {
    c[k] = (i >= 0 && i < nx && j >= 0 && j < ny)
               ? psi[(k * n_tracers + t) * plane + static_cast<long>(i) * ny + j]
               : 0.0f;
  }
}

__global__ void dg1_sample_cfl_kernel(const float* __restrict__ u,
                                      const float* __restrict__ v, int ex, int ey,
                                      int nx, int ny, int ld, Dg1Tables tb,
                                      unsigned int* __restrict__ speeds) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  float sx = 0.0f, sy = 0.0f;
  if (i < ex && j < ey) {
    const auto node = [&](const float* f, int a, int b) {
      return (a < nx && b < ny) ? f[a * ld + b] : 0.0f;
    };
    Corners c;
    c.u00 = node(u, i, j);
    c.u10 = node(u, i + 1, j);
    c.u01 = node(u, i, j + 1);
    c.u11 = node(u, i + 1, j + 1);
    c.v00 = node(v, i, j);
    c.v10 = node(v, i + 1, j);
    c.v01 = node(v, i, j + 1);
    c.v11 = node(v, i + 1, j + 1);
#pragma unroll
    for (int q = 0; q < kVol; ++q) {
      sx = fmaxf(sx, fabsf(bilinear(tb.w_vol[q], c.u00, c.u10, c.u01, c.u11)));
      sy = fmaxf(sy, fabsf(bilinear(tb.w_vol[q], c.v00, c.v10, c.v01, c.v11)));
    }
#pragma unroll
    for (int e = 0; e < kEdge; ++e) {
      sx = fmaxf(sx, fabsf(along_face(tb.w_edge[e], c.u00, c.u01)));
      sy = fmaxf(sy, fabsf(along_face(tb.w_edge[e], c.v00, c.v10)));
    }
  }
  // Block max: warp shuffles, then one value per warp through shared memory.
#pragma unroll
  for (int offset = 16; offset > 0; offset >>= 1) {
    sx = fmaxf(sx, __shfl_down_sync(0xffffffffu, sx, offset));
    sy = fmaxf(sy, __shfl_down_sync(0xffffffffu, sy, offset));
  }
  __shared__ float warp_x[kBlockX * kBlockY / 32];
  __shared__ float warp_y[kBlockX * kBlockY / 32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if ((tid & 31) == 0) {
    warp_x[tid >> 5] = sx;
    warp_y[tid >> 5] = sy;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kBlockX * kBlockY / 32; ++w) {
      sx = fmaxf(sx, warp_x[w]);
      sy = fmaxf(sy, warp_y[w]);
    }
    atomicMax(&speeds[0], __float_as_uint(sx));
    atomicMax(&speeds[1], __float_as_uint(sy));
  }
}

template <bool kMetric>
__global__ void dg1_rk_stage_kernel(
    const float* __restrict__ psi, const float* base, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ face_x,
    const float* __restrict__ face_y, Dg1MetricPlanes m, float* out, int nx, int ny,
    int n_tracers, float a, float b, float dt, Dg1Tables tb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ij = i * ny + j;
  const long plane = static_cast<long>(nx) * ny;

  const Dg1Velocity q = sample_velocity(tb, load_corners(u, v, i, j, nx, ny));
  Dg1Faces f;
  f.left_wall = i == 0;
  f.has_right = i + 1 < nx;
  f.bottom_wall = j == 0;
  f.has_top = j + 1 < ny;
  f.fx_left = face_x[ij];
  f.fx_right = f.has_right ? face_x[ij + ny] : 0.0f;
  f.fy_bottom = face_y[ij];
  f.fy_top = f.has_top ? face_y[ij + 1] : 0.0f;
  Dg1Metric g = {};
  if (kMetric) g = load_metric(m, ij, ny, f.has_right, f.has_top);

  for (int t = 0; t < n_tracers; ++t) {
    float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs], p0[kDofs];
    load_coeffs(psi, t, n_tracers, i, j, nx, ny, p);
    load_coeffs(psi, t, n_tracers, i - 1, j, nx, ny, p_l);
    load_coeffs(psi, t, n_tracers, i + 1, j, nx, ny, p_r);
    load_coeffs(psi, t, n_tracers, i, j - 1, nx, ny, p_b);
    load_coeffs(psi, t, n_tracers, i, j + 1, nx, ny, p_t);
#pragma unroll
    for (int k = 0; k < kDofs; ++k) {
      p0[k] = a != 0.0f ? base[(k * n_tracers + t) * plane + ij] : 0.0f;
    }
    float val[kDofs];
    dg1_stage_cell<kMetric>(tb, q, f, g, p, p_l, p_r, p_b, p_t, p0, a, b, dt, val);
#pragma unroll
    for (int k = 0; k < kDofs; ++k) out[(k * n_tracers + t) * plane + ij] = val[k];
  }
}

}  // namespace nst

extern "C" {

int nst_dg1_n_table_floats() { return sizeof(nst::Dg1Tables) / sizeof(float); }

// `speeds` is two float32 zeros on the device; they receive max |vx| and
// max |vy| over the first ex x ey elements of the nx x ny node planes u
// and v (row stride ld). Returns cudaGetLastError(); does not synchronise.
int nst_dg1_sample_cfl(const float* u, const float* v, float* speeds, int ex,
                       int ey, int nx, int ny, int ld, const float* tables,
                       int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (ex > nx || ey > ny || ny > ld) return static_cast<int>(cudaErrorInvalidValue);
  nst::Dg1Tables tb;
  std::memcpy(&tb, tables, sizeof(tb));
  nst::dg1_sample_cfl_kernel<<<nst::plane_grid(ex, ey), nst::plane_block(), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      u, v, ex, ey, nx, ny, ld, tb, reinterpret_cast<unsigned int*>(speeds));
  return static_cast<int>(cudaGetLastError());
}

// psi, base, out: (3, n_tracers, nx, ny); out may alias base, not psi.
// metric: null on a uniform mesh, else the 5 plane pointers in the order
// of Dg1MetricPlanes.
int nst_dg1_rk_stage(const float* psi, const float* base, const float* u,
                     const float* v, const float* face_x, const float* face_y,
                     const void* const* metric, float* out, int nx, int ny,
                     int n_tracers, float a, float b, float dt, const float* tables,
                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::Dg1Tables tb;
  std::memcpy(&tb, tables, sizeof(tb));
  nst::Dg1MetricPlanes m = {};
  if (metric != nullptr) std::memcpy(&m, metric, sizeof(m));
  const auto kernel = metric != nullptr ? nst::dg1_rk_stage_kernel<true>
                                        : nst::dg1_rk_stage_kernel<false>;
  kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
           static_cast<cudaStream_t>(stream)>>>(
      psi, base, u, v, face_x, face_y, m, out, nx, ny, n_tracers, a, b, dt, tb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
