// One ghost-zone round of CG1 mEVP on a rank block: the rdma_band kernel as
// a template on the band's axis, its launch bound and its forms (the metric
// round, the momentum form, the ring along the band), shared by the sources
// that instantiate it: mevp_rdma.cu (the closed uniform instances, rdma_stage
// and the entry points), mevp_rdma_forms.cu (the momentum forms and the ring
// on a uniform mesh) and mevp_rdma_metric.cu (the metric round), which nvcc
// compiles in parallel. The design is described in mevp_rdma.cu.
#pragma once

#include <cstdint>

#include "cluster_window.cuh"
#include "mevp_body.cuh"

namespace nst {

constexpr int kRdmaPlanes = 5;     // u, v, s11, s22, s12
constexpr int kRdmaHoPlanes = 17;  // the HO round's (kHoStatePlanes, mevp_rdma_ho.cuh)
constexpr int kRdmaMaxThreads = 1024;
// rdma_band's launch bound for blocks of up to 256 threads (the shipped
// launch): at least 3 such blocks an SM, so 80 registers a thread and a
// launch of a pair of bands (320 blocks) in one wave. It spills 100-132
// bytes a thread; without spills (139-144 registers) one block fits an SM
// and the launch ran 2x slower, at 128 registers 1.6x, at the 1024-thread
// bound (64 registers, 176-200 bytes of spills) 1.1x (PERF.md). Larger
// blocks get the 1024-thread bound.
constexpr int kRdmaBandThreads = 256;
constexpr int kRdmaBandMinBlocks = 3;
constexpr int kRdmaMaxSub = 64;            // subcycles of one rdma_band launch, at most
constexpr int kRdmaMaxCells = 4;           // cells a thread of rdma_band owns, at most
constexpr int kRdmaMaxClusterBlocks = 16;  // the H100's non-portable cluster size

// The round's sources in E's coordinates (see the file comment), of a
// state of P planes: the CG1 round's 5 (RdmaSources), the HO round's 17
// (mevp_rdma_ho.cuh).
template <int P>
struct RdmaSourcesT {
  const float* own[P];  // the pre-round (nx, ny) planes
  const float* gx_lo;   // (P, h, ny): E rows [0, hx), columns [hy, hy + ny)
  const float* gx_hi;   // (P, h, ny): E rows [hx + nx, nx + 2hx)
  const float* gy_lo;   // (P, nx + 2hx, h): E columns [0, hy), all rows
  const float* gy_hi;   // (P, nx + 2hx, h): E columns [hy + ny, ny + 2hy)
  int nx, ny, h, hx, hy;
};
using RdmaSources = RdmaSourcesT<kRdmaPlanes>;

// Plane k of E at (r, c), or 0 where no source covers it.
template <int P>
__device__ __forceinline__ float load_e(const RdmaSourcesT<P>& src, int k, int r, int c) {
  const int nxe = src.nx + 2 * src.hx;
  const int jc = c - src.hy;
  if (jc < 0) {
    return src.gy_lo != nullptr ? src.gy_lo[(k * nxe + r) * src.h + c] : 0.0f;
  }
  if (jc >= src.ny) {
    return src.gy_hi != nullptr ? src.gy_hi[(k * nxe + r) * src.h + jc - src.ny] : 0.0f;
  }
  const int ir = r - src.hx;
  if (ir < 0) {
    return src.gx_lo[(k * src.h + r) * src.ny + jc];
  }
  if (ir >= src.nx) {
    return src.gx_hi[(k * src.h + ir - src.nx) * src.ny + jc];
  }
  return src.own[k][ir * src.ny + jc];
}

// The band pair of one launch. Band cell (i, j), i < rows, j < cols, is E
// cell (r0[z] + i, c0[z] + j); its patch is the band cells [pr0, pr0 + prn)
// x [pc0, pc0 + pcn), written to the own cell (E row - hx, E column - hy).
struct RdmaBands {
  int rows, cols;
  int r0[2], c0[2];
  int pr0, prn, pc0, pcn;
  int long_axis;  // 0: tiles run along the rows (y bands), 1: along the columns (x bands)
};

// The per-step const planes of a band: band cell (i, j) reads index
// (i + off_i) * ld + (j + off_j) of each plane (the rank's widened planes,
// at the band's offset).
struct ConstView {
  MevpConsts k;
  int ld, off_i, off_j;
  __device__ __forceinline__ int at(int i, int j) const { return (i + off_i) * ld + (j + off_j); }
};

// The patch's cone, per subcycle of the launch: [lo, hi) of the band's rows
// and columns whose elements (e) and nodes (n) feed the patch after the
// subcycles that follow, clipped to the band; in the order e rows, e
// columns, n rows, n columns (mevp_rdma_cuda.band_cone computes them).
struct RdmaCone {
  int r[kRdmaMaxSub][8];
};

// -- the host's side of a launch, shared by the CG1 and the HO entry points --

// A round's sources from the host's arrays: P + 4 pointers (the P pre-round
// planes, gx_lo, gx_hi, gy_lo, gy_hi; the ghosts of an axis that is not
// split are null) and 6 ints: nx, ny, h, hx, hy and the plane count, which
// must be P (false where it is not).
template <int P>
inline bool rdma_sources_of(const void* const* sources, const int* dims, RdmaSourcesT<P>& src) {
  for (int p = 0; p < P; ++p) src.own[p] = static_cast<const float*>(sources[p]);
  src.gx_lo = static_cast<const float*>(sources[P]);
  src.gx_hi = static_cast<const float*>(sources[P + 1]);
  src.gy_lo = static_cast<const float*>(sources[P + 2]);
  src.gy_hi = static_cast<const float*>(sources[P + 3]);
  src.nx = dims[0];
  src.ny = dims[1];
  src.h = dims[2];
  src.hx = dims[3];
  src.hy = dims[4];
  return dims[5] == P;
}

// The band pair of `axis` (0: x, 1: y) of a round's sources.
template <int P>
inline RdmaBands rdma_bands(const RdmaSourcesT<P>& src, int axis) {
  const int h = src.h;
  RdmaBands bands;
  if (axis == 0) {  // rows [ghost h | own 2h] over the own columns
    bands.rows = 3 * h;
    bands.cols = src.ny;
    bands.r0[0] = 0;
    bands.r0[1] = src.nx - h;
    bands.c0[0] = bands.c0[1] = src.hy;
    bands.pr0 = h;
    bands.prn = h;
    bands.pc0 = 0;
    bands.pcn = src.ny;
    bands.long_axis = 1;
  } else {  // columns [ghost h | own 2h] over all of E's rows
    bands.rows = src.nx + 2 * src.hx;
    bands.cols = 3 * h;
    bands.r0[0] = bands.r0[1] = 0;
    bands.c0[0] = 0;
    bands.c0[1] = src.ny - h;
    bands.pr0 = src.hx;
    bands.prn = src.nx;
    bands.pc0 = h;
    bands.pcn = h;
    bands.long_axis = 0;
  }
  return bands;
}

// Whether the cone's ranges lie in the band, elements before nodes, and
// across the band within the cells a block holds (elements below the last
// row or column, nodes above the first: true for n_sub <= h). On a ring
// (wrap) the range along the band is not clipped to it.
inline bool rdma_cone_valid(const int* cone, int n_sub, const RdmaBands& bands, bool wrap) {
  const int across_axis = bands.long_axis ? 0 : 1;
  for (int sub = 0; sub < n_sub; ++sub) {
    const int* r = cone + 8 * sub;
    for (int axis = 0; axis < 2; ++axis) {
      const int n = axis == 0 ? bands.rows : bands.cols;
      const int e0 = r[2 * axis], e1 = r[2 * axis + 1], n0 = r[4 + 2 * axis], n1 = r[5 + 2 * axis];
      if (e0 > e1 || n0 > n1 || n0 < e0 || n1 > e1) return false;
      if ((axis == across_axis || !wrap) && (e0 < 0 || e1 > n || n0 < 0 || n1 > n)) {
        return false;
      }
      if (axis == across_axis && (e1 > n - 1 || n0 < 1)) return false;
    }
  }
  return true;
}

// Dynamic shared memory of one band block: `planes` planes of its region
// and its apron along the band (the y bands' rows padded by one cell).
inline int rdma_band_shared_bytes(int planes, int long_axis, int across, int seg) {
  const int cells = long_axis ? across * (seg + 2) : (seg + 2) * (across + 1);
  return planes * cells * static_cast<int>(sizeof(float));
}

// n_sub subcycles on one band of a pair (blockIdx.z: lo or hi) by clusters
// of blocks along the band's long axis (kAlong 1: along the columns, the x
// bands; 0: along the rows, the y bands). A cluster's window spans the band
// across and `cluster` x `seg` cells along it, n_sub of them at either end
// the ring; block x of the cluster keeps the seg cells from x seg of it,
// with a one-cell apron on either side along the band, in 5 planes of
// shared memory. A thread owns fixed cells for the launch: one position
// along the band (consecutive threads on consecutive positions) and every
// threads / seg-th cell across it, at most 4, so that the cone, which
// narrows across the band, leaves every thread about the same work. It
// keeps their 7 consts, c_w and inv_drag in registers: a subcycle's phase
// reads shared memory and registers only, so its latency is the body's and
// the barrier's. Subcycle `sub` computes the cells of the patch's cone that
// lie inside the window's valid ring; a cell on the block's last (first)
// position along the band pushes its new stresses (velocities) into the
// apron of the next (previous) block of the cluster. kMaxThreads: the
// launch bound, kRdmaBandThreads (kRdmaBandMinBlocks an SM) or
// kRdmaMaxThreads.
//
// The forms (template arguments, false or 0 in the closed uniform
// instances, which keep their code): kMetric, the metric round of a rank
// block of a graded or spherical mesh, whose inv_dx, inv_dy (per element),
// half_dx, half_dy (the four elements around a node) and inv_w (per node)
// are read by offset from the widened metric planes at their use, as the 7
// consts are at the launch's start, and never held; kForm, the momentum
// form of mevp_body.cuh (a_node read at its use; the adaptive beta of a
// node kept in a register beside its c_w); kWrap, the ring along the band:
// on a periodic axis that is not split over ranks the band spans the whole
// axis, and a position beyond it reads the band's cell on the other side
// (the states, the consts and the metric), and the cone along it is not
// clipped. Across a band nothing wraps: its edges are the round's ghosts.
template <int kAlong, int kMaxThreads, bool kMetric = false, int kForm = 0, bool kWrap = false>
__global__ void __launch_bounds__(kMaxThreads, kMaxThreads == kRdmaBandThreads ? kRdmaBandMinBlocks : 1)
rdma_band_kernel(RdmaSources src, RdmaBands bands, MevpConsts k, int ld, int seg, int n_sub,
                 RdmaCone cone, float* u, float* v, float* s11, float* s22, float* s12,
                 MevpScalars s) {
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPos pos = cluster_pos(cluster);
  const int z = blockIdx.z;
  const int r0 = bands.r0[z], c0 = bands.c0[z];
  const int across = kAlong ? bands.rows : bands.cols;
  // Band cell (i, j) is stored row-major in band orientation: x bands
  // `across` rows of seg + 2 cells (the apron at either end); y bands
  // seg + 2 rows of across + 1 cells (one of padding, so that threads on
  // consecutive rows fall in different banks). Position l along the band
  // (-1 and seg: the apron), cell c across it.
  const int pitch = kAlong ? seg + 2 : across + 1;
  const int plane = (kAlong ? across : seg + 2) * pitch;
  const auto cell = [&](int l, int c) { return kAlong ? c * pitch + l + 1 : (l + 1) * pitch + c; };
  float* su = smem;
  float* sv = su + plane;
  float* t11 = sv + plane;
  float* t22 = t11 + plane;
  float* t12 = t22 + plane;
  // The cluster's window along the band: w cells; this block's positions
  // from window index wx0, band index own0.
  const int w = pos.nx * seg;
  const int wx0 = pos.x * seg;
  const int own0 = static_cast<int>(blockIdx.x) / pos.nx * (w - 2 * n_sub) - n_sub + wx0;
  const auto band_ij = [&](int l, int c) {
    return kAlong ? make_int2(c, own0 + l) : make_int2(own0 + l, c);
  };
  const auto in_band = [&](int2 ij) {
    return ij.x >= 0 && ij.x < bands.rows && ij.y >= 0 && ij.y < bands.cols;
  };
  // The band cell of band index ij: on a ring (kWrap) its index along the
  // band wrapped onto the band, else ij.
  const auto wrapped = [&](int2 ij) {
    if constexpr (kWrap) {
      if (kAlong) {
        ij.y = wrap_index(ij.y, bands.cols);
      } else {
        ij.x = wrap_index(ij.x, bands.rows);
      }
    }
    return ij;
  };

  // The load: the region and its apron from the round's sources, zeros
  // beyond the band (and in the padding).
  const int stored = kAlong ? across : seg + 2;
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int e = threadIdx.x; e < stored * pitch; e += blockDim.x) {
    const int row = region_row(e, inv_pitch), col = e - row * pitch;
    const int2 ij = wrapped(kAlong ? band_ij(col - 1, row) : band_ij(row - 1, col));
    const bool in = in_band(ij) && (kAlong || col < across);
#pragma unroll
    for (int p = 0; p < kRdmaPlanes; ++p) {
      smem[p * plane + e] = in ? load_e(src, p, r0 + ij.x, c0 + ij.y) : 0.0f;
    }
  }

  // This thread owns position l along the band and cells c0 + q stride
  // across it; their consts, 0 beyond the band.
  const int l = threadIdx.x % seg;
  const int c_first = threadIdx.x / seg, stride = blockDim.x / seg;
  const int g = own0 + l;      // band index along
  const int x = wx0 + l;       // window index along
  const int c_end = c_first < stride ? across : 0;  // threads beyond stride x seg own nothing
  const auto owned = [&](auto fn) {
#pragma unroll
    for (int q = 0; q < kRdmaMaxCells; ++q) {
      const int c = c_first + q * stride;
      if (c < c_end) fn(q, c);
    }
  };
  const ConstView cv = {k, ld, r0, c0};
  float strength[kRdmaMaxCells], dt_m[kRdmaMaxCells], active[kRdmaMaxCells],
      uo[kRdmaMaxCells], vo[kRdmaMaxCells], b_u[kRdmaMaxCells], b_v[kRdmaMaxCells];
  owned([&](int q, int c) {
    const int2 ij = wrapped(band_ij(l, c));
    const bool in = in_band(ij);
    const int at = in ? cv.at(ij.x, ij.y) : 0;
    strength[q] = in ? __ldg(k.strength + at) : 0.0f;
    dt_m[q] = in ? __ldg(k.dt_m + at) : 0.0f;
    active[q] = in ? __ldg(k.active + at) : 0.0f;
    uo[q] = in ? __ldg(k.u_ocean + at) : 0.0f;
    vo[q] = in ? __ldg(k.v_ocean + at) : 0.0f;
    b_u[q] = in ? __ldg(k.b_u + at) : 0.0f;
    b_v[q] = in ? __ldg(k.b_v + at) : 0.0f;
  });
  // The forms' const reads at their use: the index of band index ij in the
  // widened planes, or -1 beyond the band (a metric weight of 0 there, as
  // the plain version's zero-filled shifts give).
  const auto const_at = [&](int2 ij) {
    ij = wrapped(ij);
    return in_band(ij) ? cv.at(ij.x, ij.y) : -1;
  };
  window_sync(cluster, pos);

  // The cone's ranges along the band are in cr[2 kAlong ..], across it in
  // cr[2 (1 - kAlong) ..] (rows first, then columns; elements, then nodes).
  const int along_e = 2 * kAlong, across_e = 2 * (1 - kAlong);
  float cw[kRdmaMaxCells], inv[kRdmaMaxCells], bt[kRdmaMaxCells];
  for (int sub = 0; sub < n_sub; ++sub) {
    const int* cr = cone.r[sub];
    // Stress phase: the cone's elements in the window's elements [sub, w - 1 - sub).
    if (g >= cr[along_e] && g < cr[along_e + 1] && x >= sub && x < w - 1 - sub) {
      owned([&](int q, int c) {
        if (c < cr[across_e] || c >= cr[across_e + 1]) return;
        const int e = cell(l, c);
        StressOut o;
        if constexpr (!kMetric && kForm == 0) {
          o = mevp_stress_body(
              su[e], su[e + pitch], su[e + 1], su[e + pitch + 1], sv[e], sv[e + pitch], sv[e + 1],
              sv[e + pitch + 1], t11[e], t22[e], t12[e], strength[q], dt_m[q], active[q], uo[q],
              vo[q], s.inv_dx, s.inv_dy, s);
        } else {
          const int at = const_at(band_ij(l, c));
          o = mevp_stress_body<kForm>(
              su[e], su[e + pitch], su[e + 1], su[e + pitch + 1], sv[e], sv[e + pitch], sv[e + 1],
              sv[e + pitch + 1], t11[e], t22[e], t12[e], strength[q], dt_m[q], active[q], uo[q],
              vo[q], kMetric ? __ldg(k.inv_dx + at) : s.inv_dx,
              kMetric ? __ldg(k.inv_dy + at) : s.inv_dy, s, form_a_node<kForm>(k, at),
              form_inv_area<kMetric, kForm>(k, at, s));
        }
        t11[e] = o.s11;
        t22[e] = o.s22;
        t12[e] = o.s12;
        cw[q] = o.c_w;
        inv[q] = o.inv_drag;
        if constexpr ((kForm & kFormAdaptive) != 0) bt[q] = o.beta;
        if (l == seg - 1 && pos.x + 1 < pos.nx) {  // into the next block's apron
          float* far = cluster.map_shared_rank(smem, pos.rank(pos.x + 1, 0));
          const int a = cell(-1, c);
          far[2 * plane + a] = o.s11;
          far[3 * plane + a] = o.s22;
          far[4 * plane + a] = o.s12;
        }
      });
    }
    window_sync(cluster, pos);

    // Velocity phase: the cone's nodes in the window's nodes [sub + 1, w - 1 - sub).
    if (g >= cr[4 + along_e] && g < cr[5 + along_e] && x >= sub + 1 && x < w - 1 - sub) {
      owned([&](int q, int c) {
        if (c < cr[4 + across_e] || c >= cr[5 + across_e]) return;
        const int e = cell(l, c);
        float2 uv;
        if constexpr (!kMetric && kForm == 0) {
          const Around a11 = {t11[e], t11[e - pitch], t11[e - 1], t11[e - pitch - 1]};
          const Around a22 = {t22[e], t22[e - pitch], t22[e - 1], t22[e - pitch - 1]};
          const Around a12 = {t12[e], t12[e - pitch], t12[e - 1], t12[e - pitch - 1]};
          uv = mevp_velocity_body(forces_uniform(a11, a22, a12, s), s.inv_w, su[e], sv[e], uo[q],
                                  vo[q], cw[q], dt_m[q], b_u[q], b_v[q], inv[q], s);
        } else {
          // The elements around node ij: (i, j), (i - 1, j), (i, j - 1),
          // (i - 1, j - 1), at e, e - pitch, e - 1, e - pitch - 1 in both
          // band orientations.
          const int2 ij = band_ij(l, c);
          float2 f;
          float inv_node_w;
          if constexpr (kMetric) {
            const int at00 = const_at(ij), at10 = const_at(make_int2(ij.x - 1, ij.y));
            const int at01 = const_at(make_int2(ij.x, ij.y - 1));
            const int at11 = const_at(make_int2(ij.x - 1, ij.y - 1));
            const auto weighted = [&](const float* t, const float* wp) {
              const auto wt = [&](int at) { return at >= 0 ? __ldg(wp + at) : 0.0f; };
              return Around{t[e] * wt(at00), t[e - pitch] * wt(at10), t[e - 1] * wt(at01),
                            t[e - pitch - 1] * wt(at11)};
            };
            f = forces_metric(weighted(t11, k.half_dy), weighted(t12, k.half_dx),
                              weighted(t12, k.half_dy), weighted(t22, k.half_dx));
            inv_node_w = __ldg(k.inv_w + at00);
          } else {
            const Around a11 = {t11[e], t11[e - pitch], t11[e - 1], t11[e - pitch - 1]};
            const Around a22 = {t22[e], t22[e - pitch], t22[e - 1], t22[e - pitch - 1]};
            const Around a12 = {t12[e], t12[e - pitch], t12[e - 1], t12[e - pitch - 1]};
            f = forces_uniform(a11, a22, a12, s);
            inv_node_w = s.inv_w;
          }
          uv = mevp_velocity_body(f, inv_node_w, su[e], sv[e], uo[q], vo[q], cw[q], dt_m[q],
                                  b_u[q], b_v[q], inv[q],
                                  (kForm & kFormAdaptive) != 0 ? bt[q] : s.beta, s);
        }
        su[e] = uv.x;
        sv[e] = uv.y;
        if (l == 0 && pos.x > 0) {  // into the previous block's apron
          float* far = cluster.map_shared_rank(smem, pos.rank(pos.x - 1, 0));
          const int a = cell(seg, c);
          far[a] = uv.x;
          far[plane + a] = uv.y;
        }
      });
    }
    window_sync(cluster, pos);  // the last one also keeps the cluster together until no block writes another
  }

  // The patch cells of the window's interior along the band, [n_sub, w -
  // n_sub), row by row (consecutive threads on consecutive cells of a row).
  float* out[kRdmaPlanes] = {u, v, s11, s22, s12};
  const int rows = kAlong ? across : seg, cols = kAlong ? seg : across;
  const float inv_cols = 1.0f / static_cast<float>(cols);
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int row = region_row(idx, inv_cols), col = idx - row * cols;
    const int pl = kAlong ? col : row, pc = kAlong ? row : col;
    const int2 ij = band_ij(pl, pc);
    if (ij.x < bands.pr0 || ij.x >= bands.pr0 + bands.prn || ij.y < bands.pc0 ||
        ij.y >= bands.pc0 + bands.pcn || wx0 + pl < n_sub || wx0 + pl >= w - n_sub) {
      continue;
    }
    const int own = (r0 + ij.x - src.hx) * src.ny + (c0 + ij.y - src.hy);
    const int e = cell(pl, pc);
#pragma unroll
    for (int p = 0; p < kRdmaPlanes; ++p) out[p][own] = smem[p * plane + e];
  }
}

using RdmaBandKernel = void (*)(RdmaSources, RdmaBands, MevpConsts, int, int, int, RdmaCone,
                                float*, float*, float*, float*, float*, MevpScalars);

// The instance of a band axis, block size and form: up to kRdmaBandThreads
// threads under that launch bound, more under kRdmaMaxThreads (the closed
// uniform instances only: the forms are built for the shipped launch).
template <bool kMetric, int kForm, bool kWrap>
RdmaBandKernel rdma_band_select(int long_axis, int threads) {
  if (threads <= kRdmaBandThreads) {
    return long_axis ? rdma_band_kernel<1, kRdmaBandThreads, kMetric, kForm, kWrap>
                     : rdma_band_kernel<0, kRdmaBandThreads, kMetric, kForm, kWrap>;
  }
  if constexpr (kMetric || kForm != 0 || kWrap) {
    return nullptr;
  } else {
    return long_axis ? rdma_band_kernel<1, kRdmaMaxThreads> : rdma_band_kernel<0, kRdmaMaxThreads>;
  }
}

// Every form of a mesh kind, closed or on a ring, by the form's bits
// (kFormWeighted, kFormAdaptive); null for another form.
template <bool kMetric, bool kWrap>
RdmaBandKernel rdma_band_form_select(int long_axis, int threads, int form) {
  switch (form) {
    case 0: return rdma_band_select<kMetric, 0, kWrap>(long_axis, threads);
    case kFormWeighted: return rdma_band_select<kMetric, kFormWeighted, kWrap>(long_axis, threads);
    case kFormAdaptive: return rdma_band_select<kMetric, kFormAdaptive, kWrap>(long_axis, threads);
    case kFormWeighted | kFormAdaptive:
      return rdma_band_select<kMetric, kFormWeighted | kFormAdaptive, kWrap>(long_axis, threads);
    default: return nullptr;
  }
}

// The instances of the forms, on a uniform mesh (mevp_rdma_forms.cu: every
// momentum form on a ring, and the weighted and adaptive ones closed; form
// 0 closed is mevp_rdma.cu's) and on a graded or spherical one
// (mevp_rdma_metric.cu); null for another form or block size.
RdmaBandKernel rdma_band_forms_of(int long_axis, int threads, int form, bool wrap);
RdmaBandKernel rdma_band_metric_of(int long_axis, int threads, int form, bool wrap);

}  // namespace nst
