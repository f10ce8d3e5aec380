// The DG ghost-zone tiled transport kernel (transport_tiled.cu) as a
// template on the degree, the metric, the velocity source, the copy width,
// the TVB form, the periodic form and the TVB walls' source, shared by the
// sources that instantiate it: transport_tiled.cu (the closed instances
// without TVB, and the entry points), transport_tiled_forms.cu (the TVB and
// periodic forms), transport_tiled_spmd.cu and transport_tiled_spmd_qv.cu
// (the rank grid's TVB form, on the CG1 velocity and the qv samples),
// which nvcc compiles in parallel. The design is described in transport_tiled.cu.
#pragma once

#include <cstdint>

#include "async_copy.cuh"
#include "dg1_body.cuh"

namespace nst {

// The block size is a launch parameter; at most 768 threads keep the ~80
// registers of the dG1 stage body free of spills, at most 384 the larger
// dG2 body (6 coefficients of 5 elements, 9 volume points, the 21-point
// limiter).
template <int kDeg>
struct TransportShape {
  static constexpr int kMaxThreads = kDeg == 2 ? 384 : 768;
};
constexpr int kTransportMaxBuffers = 2;
constexpr int kTransportMaxStages = 3;

// Everything a launch takes.
template <int kDeg>
struct TransportTiledArgs {
  const float* psi_in;  // (K, n_tracers, nx, ny)
  float* psi_out;
  const float* u;
  const float* v;
  const float* face_x;
  const float* face_y;
  Dg1MetricPlanes m;
  DgQvPlanes<kDeg> qv;
  int nx, ny, n_tracers, group, n_groups, tile, halo, tiles_j, n_items, n_buffers, n_sub,
      n_stages;
  int compute;  // 0: load and store the windows only (the phase measurement)
  // Stage s: lim(a[s] base + b[s] (psi + dt rhs(psi))); a[0] is 0.
  float a[kTransportMaxStages], b[kTransportMaxStages];
  float dt;
  DgTables<kDeg> tb;
  // Last, so that the closed instances read their parameters at the offsets
  // they always had: the periodic axes (kWrapX, kWrapY; read by the
  // periodic instances), the TVB form's tolerances M dx^2, M dy^2, and the
  // global walls of the rank grid's TVB form (kWalls): the row whose
  // forward x difference is zeroed, the row of the backward one, then the
  // columns of y's, -1 for none.
  int wrap;
  float tol_x, tol_y;
  int wall[4];
};

// Floats of shared memory, rounded up to 128 bytes.
__host__ __device__ __forceinline__ int round_128(int floats) { return (floats + 31) / 32 * 32; }

// The shared memory of one block, in floats: the input buffers (the
// n_coeff coefficient planes of a group, then u and v), then the scratch
// buffers of the coefficients (two for rk3). A window row holds the
// window's w cells from column s <= 3 on, padded to a multiple of 4.
struct TransportLayout {
  int window, pitch, plane, coeffs, buffer, scratch;
  __host__ __device__ TransportLayout(int tile, int halo, int n_coeff, bool qv, int n_stages)
      : window(tile + 2 * halo), pitch((tile + 2 * halo + 3 + 3) / 4 * 4),
        plane(window * pitch), coeffs(round_128(n_coeff * plane)),
        buffer(coeffs + (qv ? 0 : 2 * round_128(plane))),
        scratch((n_stages == 3 ? 2 : 1) * coeffs) {}
  __host__ __device__ int bytes(int n_buffers) const {
    return (n_buffers * buffer + scratch) * static_cast<int>(sizeof(float));
  }
};

// kVec: cells a copy moves, 4 (16 bytes: ny a multiple of 4, aligned
// planes) or 1. kTvb: the TVB form (dG1, dG2 on a uniform mesh): each stage
// unlimited, then the TVB and positivity limiter on the window, one ring
// further in. kWrap: the periodic form (the windows wrap on the axes of
// g.wrap); without it g.wrap is not read and the code is the closed
// domain's. kWalls: the TVB form on a rank block widened by ghost cells,
// whose global walls sit inside it: the limiter zeroes the mean
// differences at the rows and columns of g.wall (the plain version's
// wall_masks) instead of at the edges of the launch's domain.
template <int kDeg, bool kMetric, bool kQv, int kVec, bool kTvb, bool kWrap, bool kWalls = false>
__global__ void __launch_bounds__(TransportShape<kDeg>::kMaxThreads, 1)
transport_tiled_kernel(const TransportTiledArgs<kDeg> g) {
  constexpr int kDofs = DgShape<kDeg>::kDofs;
  const bool wx = kWrap && (g.wrap & kWrapX) != 0, wy = kWrap && (g.wrap & kWrapY) != 0;
  extern __shared__ __align__(128) float smem[];
  const int group = g.group;
  const TransportLayout lay(g.tile, g.halo, kDofs * group, kQv, g.n_stages);
  const int w = lay.window, P = lay.pitch, plane = lay.plane;
  const int nx = g.nx, ny = g.ny, nb = g.n_buffers;
  const long gplane = static_cast<long>(nx) * ny;
  float* const scratch = smem + nb * lay.buffer;
  const int tid = threadIdx.x, n_threads = blockDim.x;
  const int first = static_cast<int>(blockIdx.x), stride = static_cast<int>(gridDim.x);
  const int n_mine = (g.n_items - first + stride - 1) / stride;  // this block's items
  const int chunks = P / kVec;  // copies a window row
  const float inv_chunks = 1.0f / static_cast<float>(chunks);

  // Local item m is tile `tile` and tracers g0 ... g0 + group - 1; window
  // cell (a, b) of it is grid cell (i0 + a, j0 + b), at a * P + s + b of
  // each plane of its buffer, m % n_buffers. Window plane d * group + t
  // holds coefficient d of tracer g0 + t, grid plane d * n_tracers + g0 + t.
  const auto origin = [&](int m, int& i0, int& j0, int& g0) {
    const int item = first + m * stride;
    const int tile = item / g.n_groups;
    g0 = (item - tile * g.n_groups) * group;
    const int ti = tile / g.tiles_j;
    i0 = ti * g.tile - g.halo;
    j0 = (tile - ti * g.tiles_j) * g.tile - g.halo;
  };
  // Start copying local item m's window into its buffer: row a, copy x of
  // it covers columns ja + kVec x .. of the grid, ja = j0 - s the 16-byte
  // boundary at or before j0. One group of copies per item, empty past the
  // last, so that the waits count right.
  const auto issue = [&](int m) {
    if (m < n_mine) {
      float* dst = smem + (m % nb) * lay.buffer;
      float* dst_u = dst + lay.coeffs;
      float* dst_v = dst_u + round_128(plane);
      int i0, j0, g0;
      origin(m, i0, j0, g0);
      const int ja = j0 - (j0 & 3);
      for (int x = tid; x < w * chunks; x += n_threads) {
        const int a = region_row(x, inv_chunks), b = (x - a * chunks) * kVec;
        int i = i0 + a, j = ja + b;
        if (kWrap) wrap_ij(i, j, nx, ny, g.wrap);  // a 16-byte copy never straddles the seam
        const bool in = i >= 0 && i < nx && j >= 0 && j < ny;
        const long ij = static_cast<long>(i) * ny + j;
        const int at = a * P + b;
        // Beyond the domain the source is not read: any valid address will do.
#pragma unroll
        for (int d = 0; d < kDofs; ++d) {
          for (int t = 0; t < group; ++t) {
            const float* src = g.psi_in + (d * g.n_tracers + g0 + t) * gplane;
            cp_async<kVec>(dst + (d * group + t) * plane + at, in ? src + ij : g.psi_in, in);
          }
        }
        if (!kQv) {
          cp_async<kVec>(dst_u + at, in ? g.u + ij : g.u, in);
          cp_async<kVec>(dst_v + at, in ? g.v + ij : g.v, in);
        }
      }
    }
    cp_async_commit();
  };

  for (int m = 0; m < nb; ++m) issue(m);
  for (int m = 0; m < n_mine; ++m) {
    // Wait for the window of item m (the group of item m + 1 may stay in
    // flight).
    if (nb == 2) {
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    int i0, j0, g0;
    origin(m, i0, j0, g0);
    float* const input = smem + (m % nb) * lay.buffer + (j0 & 3);  // window cell (0, 0)
    const float* su = input + lay.coeffs;
    const float* sv = su + round_128(plane);

    float* cur = input;  // the substep's input and base
    // The stages' outputs: the first stage's (spare0), and rk3's second
    // (spare1). Named pointers and constant indices: an array indexed by
    // the stage would live in local memory.
    float* spare0 = scratch + (j0 & 3);
    float* const spare1 = scratch + lay.coeffs + (j0 & 3);
    int ring = 0;  // stages run so far: the valid window is [ring, w - ring)
    for (int sub = 0; sub < (g.compute ? g.n_sub : 0); ++sub) {
      for (int stage = 0; stage < g.n_stages; ++stage) {
        // Stage 0: lim(psi + dt rhs(psi)) from cur into spare0. A later
        // stage: lim(a base + b (psi_s + dt rhs(psi_s))) from the previous
        // stage's output, base cur, into spare1, or into cur in place for
        // the last.
        const float* src = stage == 0 ? cur : (stage == 1 ? spare0 : spare1);
        float* dst = stage == 0 ? spare0 : (stage == g.n_stages - 1 ? cur : spare1);
        const float sa = stage == 0 ? 0.0f : (stage == 1 ? g.a[1] : g.a[2]);
        const float sb = stage == 0 ? g.b[0] : (stage == 1 ? g.b[1] : g.b[2]);
        const int lo = ring + 1, r = w - 2 - 2 * ring;
        const float inv_r = 1.0f / static_cast<float>(r);
        for (int idx = tid; idx < r * r; idx += n_threads) {
          const int da = region_row(idx, inv_r);
          const int a = lo + da, b = lo + idx - da * r;
          const int i = i0 + a, j = j0 + b;
          const int c = a * P + b;
          bool outside;
          if constexpr (kWrap) {
            outside = (!wx && (i < 0 || i >= nx)) || (!wy && (j < 0 || j >= ny));
          } else {
            outside = i < 0 || i >= nx || j < 0 || j >= ny;
          }
          if (outside) {
            for (int q = 0; q < kDofs * group; ++q) dst[q * plane + c] = 0.0f;
            continue;
          }
          // The cell's domain index, and its right and top neighbours'
          // (wrapped on a periodic axis, which has no wall).
          long ij, ij_right, ij_top;
          if constexpr (kWrap) {
            const int iw = wx ? wrap_index(i, nx) : i, jw = wy ? wrap_index(j, ny) : j;
            ij = static_cast<long>(iw) * ny + jw;
            ij_right = iw + 1 < nx ? ij + ny : static_cast<long>(jw);
            ij_top = jw + 1 < ny ? ij + 1 : static_cast<long>(iw) * ny;
          } else {
            ij = static_cast<long>(i) * ny + j;
            ij_right = ij + ny;
            ij_top = ij + 1;
          }
          Dg1Faces f;
          if constexpr (kWrap) {
            f.left_wall = !wx && i == 0;
            f.has_right = wx || i + 1 < nx;
            f.bottom_wall = !wy && j == 0;
            f.has_top = wy || j + 1 < ny;
          } else {
            f.left_wall = i == 0;
            f.has_right = i + 1 < nx;
            f.bottom_wall = j == 0;
            f.has_top = j + 1 < ny;
          }
          DgVelocity<kDeg> q;
          if (kQv) {
            q = load_qv(g.qv, ij, ij_right, ij_top, f.has_right, f.has_top);
          } else {
            Corners corners;
            corners.u00 = su[c];
            corners.u10 = su[c + P];
            corners.u01 = su[c + 1];
            corners.u11 = su[c + P + 1];
            corners.v00 = sv[c];
            corners.v10 = sv[c + P];
            corners.v01 = sv[c + 1];
            corners.v11 = sv[c + P + 1];
            q = sample_velocity(g.tb, corners);
          }
          f.fx_left = __ldg(g.face_x + ij);
          f.fx_right = f.has_right ? __ldg(g.face_x + ij_right) : 0.0f;
          f.fy_bottom = __ldg(g.face_y + ij);
          f.fy_top = f.has_top ? __ldg(g.face_y + ij_top) : 0.0f;
          Dg1Metric gm = {};
          if (kMetric) gm = load_metric(g.m, ij, ij_right, ij_top, f.has_right, f.has_top);
          for (int t = 0; t < group; ++t) {
            float p[kDofs], p_l[kDofs], p_r[kDofs], p_b[kDofs], p_t[kDofs], p0[kDofs];
#pragma unroll
            for (int d = 0; d < kDofs; ++d) {
              const float* s = src + (d * group + t) * plane + c;
              p[d] = s[0];
              p_l[d] = s[-P];
              p_r[d] = s[P];
              p_b[d] = s[-1];
              p_t[d] = s[1];
              p0[d] = sa != 0.0f ? cur[(d * group + t) * plane + c] : 0.0f;
            }
            float val[kDofs];
            dg1_stage_cell<kDeg, kMetric, true, !kTvb>(g.tb, q, f, gm, p, p_l, p_r, p_b, p_t, p0,
                                                       sa, sb, g.dt, val);
#pragma unroll
            for (int d = 0; d < kDofs; ++d) dst[(d * group + t) * plane + c] = val[d];
          }
        }
        __syncthreads();
        ++ring;
        if constexpr (kTvb) {
          // The limiter, in place on the stage's output one ring further
          // in: it reads the neighbours' means, which it never changes.
          const int llo = ring + 1, lr = w - 2 - 2 * ring;
          const float inv_lr = 1.0f / static_cast<float>(lr);
          for (int idx = tid; idx < lr * lr; idx += n_threads) {
            const int da = region_row(idx, inv_lr);
            const int a = llo + da, b = llo + idx - da * lr;
            const int i = i0 + a, j = j0 + b;
            if ((!wx && (i < 0 || i >= nx)) || (!wy && (j < 0 || j >= ny))) continue;
            const int c = a * P + b;
            TvbNeighbours n;
            if constexpr (kWalls) {
              n.wall_l = i == g.wall[1];
              n.wall_r = i == g.wall[0];
              n.wall_b = j == g.wall[3];
              n.wall_t = j == g.wall[2];
            } else {
              n.wall_l = !wx && i == 0;
              n.wall_r = !wx && i == nx - 1;
              n.wall_b = !wy && j == 0;
              n.wall_t = !wy && j == ny - 1;
            }
            n.tol_x = g.tol_x;
            n.tol_y = g.tol_y;
            for (int t = 0; t < group; ++t) {
              const float* mean = dst + t * plane + c;
              n.m_l = mean[-P];
              n.m_r = mean[P];
              n.m_b = mean[-1];
              n.m_t = mean[1];
              float val[kDofs], out[kDofs];
#pragma unroll
              for (int d = 0; d < kDofs; ++d) val[d] = dst[(d * group + t) * plane + c];
              if constexpr (kDeg > 0) dg_tvb_limit<kDeg>(g.tb, val, n, out);
#pragma unroll
              for (int d = 1; d < kDofs; ++d) dst[(d * group + t) * plane + c] = out[d];
            }
          }
          __syncthreads();
          ++ring;
        }
      }
      if (g.n_stages == 1) {  // rk1: the stage's output is the next substep's input
        float* tmp = cur;
        cur = spare0;
        spare0 = tmp;
      }
    }

    // The T x T interior (window cells [halo, halo + tile)) is exact.
    const float inv_t = 1.0f / static_cast<float>(g.tile);
    for (int idx = tid; idx < g.tile * g.tile; idx += n_threads) {
      const int da = region_row(idx, inv_t);
      const int a = g.halo + da, b = g.halo + idx - da * g.tile;
      const int i = i0 + a, j = j0 + b;
      if (i >= nx || j >= ny) continue;
      const int c = a * P + b;
      const long ij = static_cast<long>(i) * ny + j;
#pragma unroll
      for (int d = 0; d < kDofs; ++d) {
        for (int t = 0; t < group; ++t) {
          g.psi_out[(d * g.n_tracers + g0 + t) * gplane + ij] = cur[(d * group + t) * plane + c];
        }
      }
    }
    // Every thread is done with this buffer (and the scratch): the window
    // of item m + n_buffers may go into it.
    __syncthreads();
    issue(m + nb);
  }
}

template <int kDeg>
using TransportKernel = void (*)(TransportTiledArgs<kDeg>);

// The instance of a launch for one TVB and periodic form, or null where
// there is none: the TVB form runs dG1 and dG2 on a uniform mesh; the
// periodic instances of the HO path's qv form are transport_tiled_qv_of's.
template <int kDeg, bool kTvb, bool kWrap>
TransportKernel<kDeg> transport_tiled_select(bool metric, bool qv, bool vec) {
  if constexpr (kTvb && kDeg == 0) {
    return nullptr;
  } else {
    if ((kTvb && metric) || (kWrap && qv)) return nullptr;
    constexpr bool kM = !kTvb, kQ = !kWrap;  // the instances that exist
    if (vec) {
      return metric ? (qv ? transport_tiled_kernel<kDeg, kM, kQ, 4, kTvb, kWrap>
                          : transport_tiled_kernel<kDeg, kM, false, 4, kTvb, kWrap>)
                    : (qv ? transport_tiled_kernel<kDeg, false, kQ, 4, kTvb, kWrap>
                          : transport_tiled_kernel<kDeg, false, false, 4, kTvb, kWrap>);
    }
    return metric ? (qv ? transport_tiled_kernel<kDeg, kM, kQ, 1, kTvb, kWrap>
                        : transport_tiled_kernel<kDeg, kM, false, 1, kTvb, kWrap>)
                  : (qv ? transport_tiled_kernel<kDeg, false, kQ, 1, kTvb, kWrap>
                        : transport_tiled_kernel<kDeg, false, false, 1, kTvb, kWrap>);
  }
}

// The periodic metric qv instances at degree kDeg, untouched
// (transport_tiled_qv_metric.cu).
template <int kDeg>
TransportKernel<kDeg> transport_tiled_qv_metric_of(bool vec);

// The periodic instances of the HO path's qv form, whose windows take the
// quadrature planes at their wrapped indices: on a uniform mesh untouched or
// with TVB (dG1, dG2); on a graded or spherical one untouched, from
// transport_tiled_qv_metric_of (TVB there runs the staged transport, as the
// JAX gate transport_tiled_config has it); null where there is none.
template <int kDeg, bool kTvb>
TransportKernel<kDeg> transport_tiled_select_qv(bool metric, bool vec) {
  if constexpr (kTvb && kDeg == 0) {
    return nullptr;
  } else {
    if (metric) return kTvb ? nullptr : transport_tiled_qv_metric_of<kDeg>(vec);
    return vec ? transport_tiled_kernel<kDeg, false, true, 4, kTvb, true>
               : transport_tiled_kernel<kDeg, false, true, 1, kTvb, true>;
  }
}

// The periodic qv instances at degree kDeg (transport_tiled_qv.cu).
template <int kDeg>
TransportKernel<kDeg> transport_tiled_qv_of(bool metric, bool vec, bool tvb);

// The closed TVB instances at degree kDeg (transport_tiled_tvb.cu): dG1 and
// dG2 on a uniform mesh, CG1 or qv velocity.
template <int kDeg>
TransportKernel<kDeg> transport_tiled_tvb_of(bool metric, bool qv, bool vec);

// The TVB and periodic forms at degree kDeg (transport_tiled_forms.cu):
// every periodic instance, those of the qv form through
// transport_tiled_qv_of, and the closed TVB ones through
// transport_tiled_tvb_of.
template <int kDeg>
TransportKernel<kDeg> transport_tiled_forms_of(bool metric, bool qv, bool vec, bool tvb, int wrap);

// The rank grid's TVB instances at degree kDeg (transport_tiled_spmd.cu):
// dG1 and dG2 on a uniform mesh, the CG1 velocity, closed (the widened
// block's ring is the exchange's), the walls from g.wall; null at dG0.
template <int kDeg>
TransportKernel<kDeg> transport_tiled_walls_of(bool vec);

// The same in the HO path's qv form (transport_tiled_spmd_qv.cu).
template <int kDeg>
TransportKernel<kDeg> transport_tiled_walls_qv_of(bool vec);

// The instance of a launch: the closed, untouched instances are compiled in
// transport_tiled.cu, the forms in transport_tiled_forms.cu and, with the
// TVB walls given (walls), transport_tiled_spmd.cu (the CG1 velocity) and
// transport_tiled_spmd_qv.cu (the qv form).
template <int kDeg>
TransportKernel<kDeg> transport_tiled_of(bool metric, bool qv, bool vec, bool tvb, int wrap,
                                         bool walls = false) {
  if (walls) {
    if (!tvb || metric || wrap) return nullptr;
    return qv ? transport_tiled_walls_qv_of<kDeg>(vec) : transport_tiled_walls_of<kDeg>(vec);
  }
  return tvb || wrap ? transport_tiled_forms_of<kDeg>(metric, qv, vec, tvb, wrap)
                     : transport_tiled_select<kDeg, false, false>(metric, qv, vec);
}

}  // namespace nst
