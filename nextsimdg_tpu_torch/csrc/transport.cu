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
//                  cfl_substeps, so equal speeds give an equal k.
//   dg1_rk_stage   (elements): out = lim(a*base + b*(psi + dt*rhs(psi))), or
//                  lim(psi + dt*rhs(psi)) when a == 0, for all T tracers x 3
//                  dofs. It re-samples the velocity from u and v instead of
//                  reading 12 quadrature planes, zeroes the global x = 0 and
//                  y = 0 wall faces, multiplies the fluxes by the face_x and
//                  face_y planes (all ones without a coastline) and applies
//                  the dG1 corner positivity limiter. It reads its neighbours'
//                  psi, so `out` must not alias `psi` (it may alias `base`).
//
// The dG1 and 2-point Gauss table entries arrive in Dg1Tables, packed by
// coupled_cuda.py from the port's DGTransport, so the kernel and the plain
// version share one source. The sums run densely over every table entry in
// the plain version's ascending order: with --fmad=false a zero entry adds
// an exact zero and a unit entry multiplies exactly, which is what the
// plain version's skipped terms amount to.
//
// What bounds it on the H100: a stage reads u, v, the two face planes and
// 9 coefficient planes with a 5-point stencil, and writes 9 (about 88 bytes
// per element when the neighbours hit in cache); the whole phase at 256^2
// stays in L2, so again launch latency bounds it (2 stages per substep).
// Keeping k on the device and fusing the stages is left for later.
#include <cstring>

#include "common.cuh"

namespace nst {

constexpr int kDofs = 3;   // dG1
constexpr int kVol = 4;    // 2x2 Gauss volume points
constexpr int kEdge = 2;   // 2 Gauss points per face

// Table entries, in the order that coupled_cuda.py packs them.
struct Dg1Tables {
  float w_vol[kVol][4];          // bilinear weights of nodes 00, 10, 01, 11
  float w_edge[kEdge][2];        // (1 - s, s) along a face
  float psi_vol[kDofs][kVol];    // basis at volume points
  float wgx[kVol][kDofs];        // w_q dphi_k/dx at volume points (q, k)
  float wgy[kVol][kDofs];
  float psi_x0[kDofs][kEdge];    // traces on the left, right, bottom, top faces
  float psi_x1[kDofs][kEdge];
  float psi_y0[kDofs][kEdge];
  float psi_y1[kDofs][kEdge];
  float wa_x0[kDofs][kEdge];     // traces times edge weights
  float wa_x1[kDofs][kEdge];
  float wa_y0[kDofs][kEdge];
  float wa_y1[kDofs][kEdge];
  float inv_mass[kDofs];
  float inv_dx, inv_dy;          // volume term
  float dx, dy;                  // edge terms divide by the widths
};

struct Corners {
  float u00, u10, u01, u11, v00, v10, v01, v11;
};

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

__device__ __forceinline__ float bilinear(const float w[4], float f00, float f10,
                                          float f01, float f11) {
  return f00 * w[0] + f10 * w[1] + f01 * w[2] + f11 * w[3];
}

__device__ __forceinline__ float along_face(const float w[2], float f0, float f1) {
  return f0 * w[0] + f1 * w[1];
}

// sum_k table[k][e] * c[k], ascending k.
__device__ __forceinline__ float trace(const float table[kDofs][kEdge], int e,
                                       const float c[kDofs]) {
  float acc = table[0][e] * c[0];
#pragma unroll
  for (int k = 1; k < kDofs; ++k) acc = acc + table[k][e] * c[k];
  return acc;
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
                                      const float* __restrict__ v, int nx, int ny,
                                      Dg1Tables tb,
                                      unsigned int* __restrict__ speeds) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  float sx = 0.0f, sy = 0.0f;
  if (i < nx && j < ny) {
    const Corners c = load_corners(u, v, i, j, nx, ny);
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

__global__ void dg1_rk_stage_kernel(
    const float* __restrict__ psi, const float* base, const float* __restrict__ u,
    const float* __restrict__ v, const float* __restrict__ face_x,
    const float* __restrict__ face_y, float* out, int nx, int ny, int n_tracers,
    float a, float b, float dt, Dg1Tables tb) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= nx || j >= ny) return;
  const int ij = i * ny + j;
  const long plane = static_cast<long>(nx) * ny;

  // The velocity at this element's quadrature points and on its four faces
  // (the right face is element (i+1, j)'s left face, the top face element
  // (i, j+1)'s bottom face; beyond nx or ny they are walls).
  const Corners c = load_corners(u, v, i, j, nx, ny);
  float vx[kVol], vy[kVol];
#pragma unroll
  for (int q = 0; q < kVol; ++q) {
    vx[q] = bilinear(tb.w_vol[q], c.u00, c.u10, c.u01, c.u11);
    vy[q] = bilinear(tb.w_vol[q], c.v00, c.v10, c.v01, c.v11);
  }
  const bool has_right = i + 1 < nx, has_top = j + 1 < ny;
  float vn_left[kEdge], vn_right[kEdge], vn_bottom[kEdge], vn_top[kEdge];
#pragma unroll
  for (int e = 0; e < kEdge; ++e) {
    vn_left[e] = along_face(tb.w_edge[e], c.u00, c.u01);
    vn_right[e] = along_face(tb.w_edge[e], c.u10, c.u11);
    vn_bottom[e] = along_face(tb.w_edge[e], c.v00, c.v10);
    vn_top[e] = along_face(tb.w_edge[e], c.v01, c.v11);
  }
  const float fx_left = face_x[ij];
  const float fx_right = has_right ? face_x[ij + ny] : 0.0f;
  const float fy_bottom = face_y[ij];
  const float fy_top = has_top ? face_y[ij + 1] : 0.0f;

  for (int t = 0; t < n_tracers; ++t) {
    float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs];
    load_coeffs(psi, t, n_tracers, i, j, nx, ny, p);
    load_coeffs(psi, t, n_tracers, i - 1, j, nx, ny, p_l);
    load_coeffs(psi, t, n_tracers, i + 1, j, nx, ny, p_r);
    load_coeffs(psi, t, n_tracers, i, j - 1, nx, ny, p_b);
    load_coeffs(psi, t, n_tracers, i, j + 1, nx, ny, p_t);

    // Volume term, streamed over the quadrature points.
    float acc_x[kDofs], acc_y[kDofs];
#pragma unroll
    for (int q = 0; q < kVol; ++q) {
      float pq = tb.psi_vol[0][q] * p[0];
#pragma unroll
      for (int k = 1; k < kDofs; ++k) pq = pq + tb.psi_vol[k][q] * p[k];
      const float fx = vx[q] * pq;
      const float fy = vy[q] * pq;
#pragma unroll
      for (int k = 0; k < kDofs; ++k) {
        acc_x[k] = q == 0 ? tb.wgx[q][k] * fx : acc_x[k] + tb.wgx[q][k] * fx;
        acc_y[k] = q == 0 ? tb.wgy[q][k] * fy : acc_y[k] + tb.wgy[q][k] * fy;
      }
    }

    // Upwind normal fluxes on the four faces.
    float g_left[kEdge], g_right[kEdge], g_bottom[kEdge], g_top[kEdge];
#pragma unroll
    for (int e = 0; e < kEdge; ++e) {
      // Left face (i): upwind between element (i-1, j) and this one; the
      // global i = 0 face is a wall.
      float up = vn_left[e] >= 0.0f ? trace(tb.psi_x1, e, p_l) : trace(tb.psi_x0, e, p);
      g_left[e] = i == 0 ? 0.0f : vn_left[e] * up;
      g_left[e] = g_left[e] * fx_left;
      // Right face (i+1): this element against element (i+1, j).
      up = vn_right[e] >= 0.0f ? trace(tb.psi_x1, e, p) : trace(tb.psi_x0, e, p_r);
      g_right[e] = has_right ? (vn_right[e] * up) * fx_right : 0.0f;
      // Bottom face (j), with the global j = 0 wall.
      up = vn_bottom[e] >= 0.0f ? trace(tb.psi_y1, e, p_b) : trace(tb.psi_y0, e, p);
      g_bottom[e] = j == 0 ? 0.0f : vn_bottom[e] * up;
      g_bottom[e] = g_bottom[e] * fy_bottom;
      // Top face (j+1).
      up = vn_top[e] >= 0.0f ? trace(tb.psi_y1, e, p) : trace(tb.psi_y0, e, p_t);
      g_top[e] = has_top ? (vn_top[e] * up) * fy_top : 0.0f;
    }

    float val[kDofs];
#pragma unroll
    for (int k = 0; k < kDofs; ++k) {
      const float volume = acc_x[k] * tb.inv_dx + acc_y[k] * tb.inv_dy;
      float in_x = tb.wa_x1[k][0] * g_right[0];
      float out_x = tb.wa_x0[k][0] * g_left[0];
      float in_y = tb.wa_y1[k][0] * g_top[0];
      float out_y = tb.wa_y0[k][0] * g_bottom[0];
#pragma unroll
      for (int e = 1; e < kEdge; ++e) {
        in_x = in_x + tb.wa_x1[k][e] * g_right[e];
        out_x = out_x + tb.wa_x0[k][e] * g_left[e];
        in_y = in_y + tb.wa_y1[k][e] * g_top[e];
        out_y = out_y + tb.wa_y0[k][e] * g_bottom[e];
      }
      const float edge_x = (in_x - out_x) / tb.dx;
      const float edge_y = (in_y - out_y) / tb.dy;
      const float rhs = tb.inv_mass[k] * (volume - edge_x - edge_y);
      val[k] = p[k] + dt * rhs;
      if (a != 0.0f) {
        val[k] = a * base[(k * n_tracers + t) * plane + ij] + b * val[k];
      }
    }

    // dG1 positivity limiter: the linear polynomial's minimum is at a
    // corner, mean - (|s1| + |s2|)/2.
    const float mean = val[0];
    const float mins = mean - 0.5f * (fabsf(val[1]) + fabsf(val[2]));
    const float deficit = mean - mins;
    const float theta =
        mins < 0.0f ? fminf(fmaxf(mean / (deficit > 0.0f ? deficit : 1.0f), 0.0f), 1.0f)
                    : 1.0f;
    out[(0 * n_tracers + t) * plane + ij] = mean;
    out[(1 * n_tracers + t) * plane + ij] = val[1] * theta;
    out[(2 * n_tracers + t) * plane + ij] = val[2] * theta;
  }
}

}  // namespace nst

extern "C" {

int nst_dg1_n_table_floats() { return sizeof(nst::Dg1Tables) / sizeof(float); }

// `speeds` is two float32 zeros on the device; they receive max |vx| and
// max |vy|. Returns cudaGetLastError(); does not synchronise.
int nst_dg1_sample_cfl(const float* u, const float* v, float* speeds, int nx,
                       int ny, const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::Dg1Tables tb;
  std::memcpy(&tb, tables, sizeof(tb));
  nst::dg1_sample_cfl_kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
                               static_cast<cudaStream_t>(stream)>>>(
      u, v, nx, ny, tb, reinterpret_cast<unsigned int*>(speeds));
  return static_cast<int>(cudaGetLastError());
}

// psi, base, out: (3, n_tracers, nx, ny); out may alias base, not psi.
int nst_dg1_rk_stage(const float* psi, const float* base, const float* u,
                     const float* v, const float* face_x, const float* face_y,
                     float* out, int nx, int ny, int n_tracers, float a, float b,
                     float dt, const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::Dg1Tables tb;
  std::memcpy(&tb, tables, sizeof(tb));
  nst::dg1_rk_stage_kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
                             static_cast<cudaStream_t>(stream)>>>(
      psi, base, u, v, face_x, face_y, out, nx, ny, n_tracers, a, b, dt, tb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
