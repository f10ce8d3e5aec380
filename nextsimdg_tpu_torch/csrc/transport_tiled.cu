// dG1 tracer transport on Hopper by ghost-zone tiles: whole substeps per launch.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled,
// which runs up to K_CAP limited SSP-RK substeps per round on a halo'd block
// in VMEM, re-sampling the quadrature velocity inside the block, and writes
// back the interior. Here one thread block owns a T x T tile and loads the
// (T + 2H)^2 window around it of u and v (nodes) and of the 3 x n_tracers
// dG1 coefficient planes into shared memory. It runs n_sub substeps of
// rk1 or rk2 on the window, each RK stage followed by a barrier, and writes
// the interior to the output planes (ping-pong on the host: blocks run in
// parallel and in no order, so a launch never updates its input in place).
//
// Ring budget: an RK stage at element e reads the coefficients of e - 1 and
// e + 1, and the velocity of element e needs nodes e and e + 1, so each
// stage invalidates one ring on either side. The host runs at most
// K_CAP = (H - 1) // stages substeps per launch, as transport_tiled.py does
// (its extra ring is the block-edge velocity sample; here that ring is
// absorbed by the first stage, so the budget is one ring conservative).
//
// Shared memory: u, v and two coefficient buffers, (2 + 2 * 3 * n_tracers)
// planes. rk2's first stage writes buffer B from A; its second stage reads
// B around the element and A at the element (the step's base) and writes A
// in place, which is safe because every element reads only its own base
// value. The face masks, and on a graded or spherical mesh the transport's
// 5 metric planes, are read from global memory (read-only, L1/L2), so the
// metric does not grow the shared memory of a block.
//
// The HO path (kQv) passes the precomputed quadrature velocity of
// ho_velocity_to_quad instead of (u, v): 4 + 4 volume planes and 2 + 2 face
// planes, read from global memory like the metric planes (twelve more
// window planes in shared memory would not fit a block at k = 3), so the
// shared layout is unchanged and the sampling is skipped. An element's right
// and top faces read the neighbour's vn_x and vn_y, which is the plain
// version's shifted left and bottom face fluxes.
//
// Walls: loads outside the domain are zeros and cells outside the domain
// are never updated, as in transport.cu's load_coeffs and at(). Each element
// runs dg1_stage_cell of dg1_body.cuh with the wall flags of its global
// index, exactly as dg1_rk_stage does (the JAX kernel zeroes the wall
// columns of the face masks instead; both give a zero flux there), so this
// schedule equals dg1_rk_stage's bit for bit.
//
// What bounds it on the H100: a grid-wide dg1_rk_stage launch reads 13
// planes and writes 9 per stage; at 1024^2 (36 MB of coefficients plus
// velocity and masks) that streams from HBM twice per substep. Here the
// tracers are read and written once per launch, and the stage math, about
// 200 float operations per element and tracer, runs on the window out of
// shared memory: the bound moves to the arithmetic and to shared-memory
// bandwidth, at ((T + 2H)/T)^2 redundant work in the first stage.
#include <cstring>

#include "dg1_body.cuh"

namespace nst {

// The block size is a launch parameter; at most 768 threads keep the ~80
// registers of the stage body free of spills.
constexpr int kTransportMaxThreads = 768;

// The precomputed quadrature velocity of the HO path (QuadVelocity), each a
// read-only (nx, ny) plane; the host packs them in this order.
struct Dg1QvPlanes {
  const float* vx[kVol];
  const float* vy[kVol];
  const float* vn_x[kEdge];  // the left face of element (i, j)
  const float* vn_y[kEdge];  // its bottom face
};

// Element (i, j)'s velocity from the precomputed planes; its right and top
// faces are those of elements (i+1, j) and (i, j+1) (zero beyond the domain,
// where there is no flux).
__device__ __forceinline__ Dg1Velocity load_qv(const Dg1QvPlanes& qv, long ij, int ny,
                                               bool has_right, bool has_top) {
  Dg1Velocity q;
#pragma unroll
  for (int k = 0; k < kVol; ++k) {
    q.vx[k] = __ldg(qv.vx[k] + ij);
    q.vy[k] = __ldg(qv.vy[k] + ij);
  }
#pragma unroll
  for (int e = 0; e < kEdge; ++e) {
    q.vn_left[e] = __ldg(qv.vn_x[e] + ij);
    q.vn_right[e] = has_right ? __ldg(qv.vn_x[e] + ij + ny) : 0.0f;
    q.vn_bottom[e] = __ldg(qv.vn_y[e] + ij);
    q.vn_top[e] = has_top ? __ldg(qv.vn_y[e] + ij + 1) : 0.0f;
  }
  return q;
}

template <bool kMetric, bool kQv>
__global__ void __launch_bounds__(kTransportMaxThreads)
transport_tiled_kernel(const float* __restrict__ psi_in, float* __restrict__ psi_out,
                       const float* __restrict__ u, const float* __restrict__ v,
                       const float* __restrict__ face_x,
                       const float* __restrict__ face_y, Dg1MetricPlanes m, Dg1QvPlanes qv,
                       int nx, int ny, int n_tracers, int tile, int halo, int n_sub,
                       int n_stages, float a2, float b2, float dt, Dg1Tables tb) {
  extern __shared__ float smem[];
  const int w = tile + 2 * halo;
  const int plane = w * w;
  const int n_coeff = kDofs * n_tracers;
  const long gplane = static_cast<long>(nx) * ny;
  float* su = smem;
  float* sv = su + plane;
  float* buf_a = sv + plane;
  float* buf_b = buf_a + n_coeff * plane;

  // Window cell (a, b) is grid cell (i0 + a, j0 + b). Each loop below
  // spreads the cells of a square region over the block's threads, row by
  // row, consecutive threads on consecutive cells of a row.
  const int i0 = blockIdx.y * tile - halo;
  const int j0 = blockIdx.x * tile - halo;
  const int tid = threadIdx.x, n_threads = blockDim.x;

  // Load the window: u, v and the coefficients into A; B starts at zero, so
  // that its cells outside the domain read as zeros like A's.
  const float inv_w = 1.0f / static_cast<float>(w);
  for (int c = tid; c < plane; c += n_threads) {
    const int a = region_row(c, inv_w), b = c - a * w;
    const int i = i0 + a, j = j0 + b;
    const bool inside = i >= 0 && i < nx && j >= 0 && j < ny;
    const long ij = static_cast<long>(i) * ny + j;
    if (!kQv) {  // the HO path has no (u, v)
      su[c] = inside ? u[ij] : 0.0f;
      sv[c] = inside ? v[ij] : 0.0f;
    }
    for (int q = 0; q < n_coeff; ++q) {
      buf_a[q * plane + c] = inside ? psi_in[q * gplane + ij] : 0.0f;
      buf_b[q * plane + c] = 0.0f;
    }
  }
  __syncthreads();

  float* cur = buf_a;    // the substep's input (and, for rk2, its base)
  float* spare = buf_b;  // the first stage's output
  int ring = 0;          // stages run so far: the valid window is [ring, w - ring)
  for (int sub = 0; sub < n_sub; ++sub) {
    for (int stage = 0; stage < n_stages; ++stage) {
      // Stage 0: lim(psi + dt rhs(psi)) from cur into spare. Stage 1 (rk2):
      // lim(a2 base + b2 (psi1 + dt rhs(psi1))) from spare, base cur, into cur.
      const float* src = stage == 0 ? cur : spare;
      float* dst = stage == 0 ? spare : cur;
      const float sa = stage == 0 ? 0.0f : a2;
      const float sb = stage == 0 ? 1.0f : b2;
      const int lo = ring + 1, r = w - 2 - 2 * ring;
      const float inv_r = 1.0f / static_cast<float>(r);
      for (int idx = tid; idx < r * r; idx += n_threads) {
        const int da = region_row(idx, inv_r);
        const int a = lo + da, b = lo + idx - da * r;
        const int i = i0 + a, j = j0 + b;
        if (i < 0 || i >= nx || j < 0 || j >= ny) continue;
        const int c = a * w + b;
        const long ij = static_cast<long>(i) * ny + j;
        Dg1Faces f;
        f.left_wall = i == 0;
        f.has_right = i + 1 < nx;
        f.bottom_wall = j == 0;
        f.has_top = j + 1 < ny;
        Dg1Velocity q;
        if (kQv) {
          q = load_qv(qv, ij, ny, f.has_right, f.has_top);
        } else {
          Corners corners;
          corners.u00 = su[c];
          corners.u10 = su[c + w];
          corners.u01 = su[c + 1];
          corners.u11 = su[c + w + 1];
          corners.v00 = sv[c];
          corners.v10 = sv[c + w];
          corners.v01 = sv[c + 1];
          corners.v11 = sv[c + w + 1];
          q = sample_velocity(tb, corners);
        }
        f.fx_left = __ldg(face_x + ij);
        f.fx_right = f.has_right ? __ldg(face_x + ij + ny) : 0.0f;
        f.fy_bottom = __ldg(face_y + ij);
        f.fy_top = f.has_top ? __ldg(face_y + ij + 1) : 0.0f;
        Dg1Metric g = {};
        if (kMetric) g = load_metric(m, ij, ny, f.has_right, f.has_top);
        for (int t = 0; t < n_tracers; ++t) {
          float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs], p0[kDofs];
#pragma unroll
          for (int d = 0; d < kDofs; ++d) {
            const float* s = src + (d * n_tracers + t) * plane + c;
            p[d] = s[0];
            p_l[d] = s[-w];
            p_r[d] = s[w];
            p_b[d] = s[-1];
            p_t[d] = s[1];
            p0[d] = sa != 0.0f ? cur[(d * n_tracers + t) * plane + c] : 0.0f;
          }
          float val[kDofs];
          dg1_stage_cell<kMetric>(tb, q, f, g, p, p_l, p_r, p_b, p_t, p0, sa, sb, dt, val);
#pragma unroll
          for (int d = 0; d < kDofs; ++d) dst[(d * n_tracers + t) * plane + c] = val[d];
        }
      }
      __syncthreads();
      ++ring;
    }
    if (n_stages == 1) {  // rk1: the stage's output is the next substep's input
      float* tmp = cur;
      cur = spare;
      spare = tmp;
    }
  }

  // The T x T interior (window cells [halo, halo + tile)) is exact.
  const float inv_t = 1.0f / static_cast<float>(tile);
  for (int idx = tid; idx < tile * tile; idx += n_threads) {
    const int da = region_row(idx, inv_t);
    const int a = halo + da, b = halo + idx - da * tile;
    const int i = i0 + a, j = j0 + b;
    if (i >= nx || j >= ny) continue;
    const int c = a * w + b;
    const long ij = static_cast<long>(i) * ny + j;
    for (int q = 0; q < n_coeff; ++q) psi_out[q * gplane + ij] = cur[q * plane + c];
  }
}

}  // namespace nst

extern "C" {

int nst_transport_tiled_shared_bytes(int tile, int halo, int n_tracers) {
  const int w = tile + 2 * halo;
  return (2 + 2 * nst::kDofs * n_tracers) * w * w * static_cast<int>(sizeof(float));
}

// One round, by blocks of `threads` threads (at most 768): n_sub substeps of
// an n_stages-stage SSP-RK scheme (1: rk1,
// 2: rk2 with second-stage weights a2, b2) from psi_in into psi_out, both
// (3, n_tracers, nx, ny), which must not alias; n_sub * n_stages <= halo - 1.
// metric: null on a uniform mesh, else the 5 plane pointers in the order of
// Dg1MetricPlanes. qv: null on the CG1 path (velocity sampled from u, v),
// else the 12 quadrature-velocity plane pointers in the order of Dg1QvPlanes
// (u and v are then not read). Launches on `stream`, returns
// cudaGetLastError() (or the error of the shared-memory attribute); does not
// synchronise.
int nst_transport_tiled(const float* psi_in, float* psi_out, const float* u,
                        const float* v, const float* face_x, const float* face_y,
                        const void* const* metric, const void* const* qv, int nx, int ny,
                        int n_tracers,
                        int tile, int halo, int n_sub, int n_stages, int threads, float a2, float b2, float dt,
                        const float* tables, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tile < 1 || n_sub < 1 || n_stages < 1 || n_stages > 2 ||
      n_sub * n_stages > halo - 1 || threads < 32 ||
      threads > nst::kTransportMaxThreads || tile + 2 * halo > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::Dg1MetricPlanes m = {};
  if (metric != nullptr) std::memcpy(&m, metric, sizeof(m));
  nst::Dg1QvPlanes q = {};
  if (qv != nullptr) std::memcpy(&q, qv, sizeof(q));
  const auto kernel =
      metric != nullptr ? (qv != nullptr ? nst::transport_tiled_kernel<true, true>
                                         : nst::transport_tiled_kernel<true, false>)
                        : (qv != nullptr ? nst::transport_tiled_kernel<false, true>
                                         : nst::transport_tiled_kernel<false, false>);
  const int bytes = nst_transport_tiled_shared_bytes(tile, halo, n_tracers);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so that it is not reported by a later launch
    return static_cast<int>(err);
  }
  nst::Dg1Tables tb;
  std::memcpy(&tb, tables, sizeof(tb));
  const dim3 grid((ny + tile - 1) / tile, (nx + tile - 1) / tile);
  kernel<<<grid, threads, bytes, static_cast<cudaStream_t>(stream)>>>(
      psi_in, psi_out, u, v, face_x, face_y, m, q, nx, ny, n_tracers, tile, halo, n_sub,
      n_stages, a2, b2, dt, tb);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
