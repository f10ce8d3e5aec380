// The HO (CG2/dG1) form of rdma_band: n_sub HO subcycles on the edge bands
// of an rdma round, as a template on the band's axis, the form (kHoWeighted,
// kHoMetric), the ring along the band and where the consts live, shared by
// the sources that instantiate it: mevp_rdma_ho.cu (the closed uniform
// instances and the entry points), mevp_rdma_ho_forms.cu (the A-weighted
// form and the ring on a uniform mesh), mevp_rdma_ho_metric.cu (a graded or
// spherical mesh) and mevp_rdma_ho_l2.cu (every form with its consts read
// from L2: the 2048^2 blocks and the ghost widths above 16), which nvcc
// compiles in parallel. The design is described in mevp_rdma_ho.cu.
#pragma once

#include "async_copy.cuh"
#include "ho_body.cuh"
#include "mevp_rdma.cuh"

namespace nst {

static_assert(kRdmaHoPlanes == kHoStatePlanes, "the HO round moves the HO state's planes");

using RdmaHoSources = RdmaSourcesT<kHoStatePlanes>;

// The HO band's launch bounds: with staged consts blocks of up to 384
// threads, two an SM, at most 85 registers a thread (the closed instances
// take 80; the staged A-weighted and metric ones took 85-92 uncapped, so
// that their 384-thread blocks ran one an SM, in two waves); with the
// consts in L2 (a block's shared memory is the 17 state planes alone)
// blocks of up to 256 threads, three an SM (80 registers, a few bytes of
// spills: at two an SM, up to 128 registers, the 2048^2 bands ran 25% slower).
constexpr int kRdmaHoThreads = 384;
constexpr int kRdmaHoMinBlocks = 2;
constexpr int kRdmaHoL2Threads = 256;
constexpr int kRdmaHoL2MinBlocks = 3;

// The shared-memory planes of one HO band block: the 17 state planes and,
// where the consts are staged, the form's 29-37 const planes.
__host__ __device__ constexpr int rdma_band_ho_planes(int form, bool staged) {
  return kHoStatePlanes + (staged ? ho_const_planes(form) : 0);
}

// Dynamic shared memory of one HO band block of rows x seg cells (across x
// along the band) and its one-cell apron on every side.
inline int rdma_band_ho_shared_bytes(int form, bool staged, int rows, int seg) {
  return rdma_band_ho_planes(form, staged) * (rows + 2) * (seg + 2) * static_cast<int>(sizeof(float));
}

// The address of plane k of E at (r, c) in the round's sources, or null
// where no source covers it (where load_e reads a zero).
template <int P>
__device__ __forceinline__ const float* source_at(const RdmaSourcesT<P>& src, int k, int r, int c) {
  const int nxe = src.nx + 2 * src.hx;
  const int jc = c - src.hy;
  if (jc < 0) {
    return src.gy_lo != nullptr ? src.gy_lo + (k * nxe + r) * src.h + c : nullptr;
  }
  if (jc >= src.ny) {
    return src.gy_hi != nullptr ? src.gy_hi + (k * nxe + r) * src.h + jc - src.ny : nullptr;
  }
  const int ir = r - src.hx;
  if (ir < 0) return src.gx_lo + (k * src.h + r) * src.ny + jc;
  if (ir >= src.nx) return src.gx_hi + (k * src.h + ir - src.nx) * src.ny + jc;
  return src.own[k] + ir * src.ny + jc;
}

// Const plane q of a form, in the staged order: the strength, the
// per-plane consts (HoPlaneConst q' of owned plane p at 1 + 4 q' + p), the
// metric form's widths last (ho_width_plane).
__device__ __forceinline__ const float* ho_form_const(const HoConsts& k, int form, int q) {
  const int per_plane = kHoPlanes * ho_plane_consts(form);
  if (q == 0) return k.strength;
  if (q <= per_plane) return ho_const_plane(k, (q - 1) / kHoPlanes, (q - 1) % kHoPlanes);
  return ho_width(k, q - 1 - per_plane);
}

// n_sub HO subcycles on one band of a pair (blockIdx.z: lo or hi) by
// clusters of pos.nx blocks along the band's long axis (kAlong 1: along
// the columns, the x bands; 0: along the rows, the y bands) and pos.ny
// across it. A cluster's window spans the band across and pos.nx x seg
// cells along it, n_sub of them at either end the ring; block (x, y) of
// the cluster keeps the seg cells from x seg of the window along the band
// and the `rows` cells from y rows across it (the last block's rows may
// run past the band: zeros, never computed), with a one-cell apron on
// every side, in shared memory: the 17 state planes and, with kStaged, the
// form's 29-37 const planes, copied in once a launch by cp.async (the
// apron's too: the metric form's velocity reads the widths of the elements
// at -1). Each phase runs the cells of the patch's cone (RdmaCone) that
// lie in the block and in the window's valid ring, one flat loop over the
// block's threads (a thread a cell where the block has a thread a cell of
// the cone). A phase's new stresses (velocities) on the block's
// last (first) row or column are pushed into the apron of the neighbour
// block at +1 (-1) on that axis, and of the diagonal one at a corner,
// through distributed shared memory; a cluster barrier ends each phase.
// The bodies are ho_body.cuh's, with this band's accessors: the same
// operations on the same values as ho_tiled on the widened block.
//
// kForm: kHoWeighted (the a_{k} planes among the consts), kHoMetric (each
// element's widths from the width planes, zeros beyond the band as beyond
// a closed domain); kWrap: the band spans a periodic axis that is not split
// over ranks, and a position beyond either end along it reads the band's
// cell on the other side (never across); kStaged false: the consts stay in
// global memory and are read by offset at their use (a block then holds
// the state alone).
template <int kAlong, int kForm, bool kWrap, bool kStaged>
__global__ void __launch_bounds__(kStaged ? kRdmaHoThreads : kRdmaHoL2Threads,
                                  kStaged ? kRdmaHoMinBlocks : kRdmaHoL2MinBlocks)
rdma_band_ho_kernel(RdmaHoSources src, RdmaBands bands, HoConsts k, int ld, int seg, int rows,
                    int n_sub, RdmaCone cone, float* __restrict__ out, HoScalars s, HoTables t) {
  constexpr bool kMetric = (kForm & kHoMetric) != 0;
  constexpr int kConsts = ho_const_planes(kForm);
  constexpr int kUv = 2 * kHoPlanes;  // the velocity planes, u's then v's, first of the state's
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPos pos = cluster_pos(cluster);  // x along the band, y across it
  const int z = blockIdx.z;
  const int r0 = bands.r0[z], c0 = bands.c0[z];
  // The block's ti x tj band cells are stored row-major in band
  // orientation (band row i + 1 is `pitch` further, band column j + 1 one
  // further) with the apron around them: local (li, lj) in [-1, ti] x
  // [-1, tj]. x bands: ti = rows across, tj = seg along; y bands: ti = seg
  // along, tj = rows across.
  const int ti = kAlong ? rows : seg, tj = kAlong ? seg : rows;
  const int pitch = tj + 2;
  const int plane = (ti + 2) * pitch;
  const auto cell = [&](int li, int lj) { return (li + 1) * pitch + lj + 1; };
  const float* cs = smem + kHoStatePlanes * plane;  // the staged consts
  // The cluster's window along the band: w cells; this block's cells along
  // from window index wx0, band index own0; across from band index ax0.
  const int w = pos.nx * seg;
  const int wx0 = pos.x * seg;
  const int own0 = static_cast<int>(blockIdx.x) / pos.nx * (w - 2 * n_sub) - n_sub + wx0;
  const int ax0 = pos.y * rows;
  const auto band_ij = [&](int li, int lj) {
    return kAlong ? make_int2(ax0 + li, own0 + lj) : make_int2(own0 + li, ax0 + lj);
  };
  const auto in_band = [&](int2 ij) {
    return ij.x >= 0 && ij.x < bands.rows && ij.y >= 0 && ij.y < bands.cols;
  };
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
  // The index of band index ij in the widened const planes (wrapped on a
  // ring), or -1 beyond the band (unstaged consts).
  const auto const_at = [&](int2 ij) {
    ij = wrapped(ij);
    return in_band(ij) ? (ij.x + r0) * ld + (ij.y + c0) : -1;
  };

  // The load: the block's cells and apron from the round's sources (and
  // the const planes), zeros beyond the band, by cp.async.
  const float inv_pitch = 1.0f / static_cast<float>(pitch);
  for (int e = threadIdx.x; e < plane; e += blockDim.x) {
    const int row = region_row(e, inv_pitch), col = e - row * pitch;
    const int2 ij = wrapped(band_ij(row - 1, col - 1));
    const bool in = in_band(ij);
    const int r = r0 + ij.x, c = c0 + ij.y;
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) {
      const float* from = in ? source_at(src, p, r, c) : nullptr;
      cp_async<1>(smem + p * plane + e, from != nullptr ? from : src.own[0], from != nullptr);
    }
    if constexpr (kStaged) {
      const int at = in ? r * ld + c : 0;
#pragma unroll
      for (int q = 0; q < kConsts; ++q) {
        cp_async<1>(smem + (kHoStatePlanes + q) * plane + e, ho_form_const(k, kForm, q) + at, in);
      }
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  window_sync(cluster, pos);

  // fn(li, lj) on the block's cells in [l0, l1) along the band and [c0,
  // c1) across it, block-local (clipped to the block): one flat loop over
  // the block's threads, consecutive threads on consecutive cells of a band
  // row, so that only the cone's cells take a thread, a warp's cells are
  // consecutive in shared memory, and a warp's L2 const reads run along a
  // row of E.
  const auto each = [&](int l0, int l1, int c0, int c1, auto fn) {
    l0 = max(l0, 0);
    l1 = min(l1, seg);
    c0 = max(c0, 0);
    c1 = min(c1, rows);
    if (l1 <= l0 || c1 <= c0) return;
    const int i0 = kAlong ? c0 : l0, j0 = kAlong ? l0 : c0;
    const int ni = kAlong ? c1 - c0 : l1 - l0, nj = kAlong ? l1 - l0 : c1 - c0;
    const float inv_nj = 1.0f / static_cast<float>(nj);
    for (int idx = threadIdx.x; idx < ni * nj; idx += blockDim.x) {
      const int r = region_row(idx, inv_nj);
      fn(i0 + r, j0 + idx - r * nj);
    }
  };
  // fn(far) with far the cell (li, lj) of this block in the apron of each
  // neighbour at (di, dj) in band orientation, di and dj in {0, d}, that
  // holds it (d = 1: from the block's last row or column; -1: its first).
  const auto push = [&](int li, int lj, int d, auto fn) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        const int di = ni * d, dj = nj * d;
        if ((di == 0 && dj == 0) || (di != 0 && li != (di > 0 ? ti - 1 : 0)) ||
            (dj != 0 && lj != (dj > 0 ? tj - 1 : 0))) {
          continue;
        }
        const int bx = pos.x + (kAlong ? dj : di), by = pos.y + (kAlong ? di : dj);
        if (bx < 0 || bx >= pos.nx || by < 0 || by >= pos.ny) continue;
        fn(cluster.map_shared_rank(smem, pos.rank(bx, by)) + cell(li - di * ti, lj - dj * tj));
      }
    }
  };

  // The cone's ranges along the band are in cr[2 kAlong ..], across it in
  // cr[2 (1 - kAlong) ..] (rows first, then columns; elements, then nodes).
  const int along_e = 2 * kAlong, across_e = 2 * (1 - kAlong);
  for (int sub = 0; sub < n_sub; ++sub) {
    const int* cr = cone.r[sub];
    // Stress phase: the cone's elements in the window's elements [sub, w - 1 - sub).
    const int el0 = max(cr[along_e] - own0, sub - wx0), el1 = min(cr[along_e + 1] - own0, w - 1 - sub - wx0);
    const int ec0 = cr[across_e] - ax0, ec1 = cr[across_e + 1] - ax0;
    each(el0, el1, ec0, ec1, [&](int li, int lj) {
      const int e = cell(li, lj);
      float u[kHoNodes], v[kHoNodes];
      const float* su = smem + e;
      ho_gather([&](int p, int di, int dj) { return su[p * plane + di * pitch + dj]; }, u);
      ho_gather([&](int p, int di, int dj) { return su[(kHoPlanes + p) * plane + di * pitch + dj]; }, v);
      float sig[3 * kHoCoeffs];
      float* s11 = sig;
      float* s22 = sig + kHoCoeffs;
      float* s12 = sig + 2 * kHoCoeffs;
#pragma unroll
      for (int q = 0; q < 3 * kHoCoeffs; ++q) sig[q] = smem[(kHoS11 + q) * plane + e];
      if constexpr (kStaged) {
        ho_stress_body(t, s, u, v, s11, s22, s12, cs[e],
                       kMetric ? cs[ho_width_plane(kForm, kHoInvDx) * plane + e] : s.inv_dx,
                       kMetric ? cs[ho_width_plane(kForm, kHoInvDy) * plane + e] : s.inv_dy);
      } else {
        const int at = const_at(band_ij(li, lj));
        if constexpr (kMetric) {
          ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + at), __ldg(k.inv_dx + at),
                         __ldg(k.inv_dy + at));
        } else {
          ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + at), s.inv_dx, s.inv_dy);
        }
      }
#pragma unroll
      for (int q = 0; q < 3 * kHoCoeffs; ++q) smem[(kHoS11 + q) * plane + e] = sig[q];
      if (li == ti - 1 || lj == tj - 1) {
        push(li, lj, 1, [&](float* far) {
#pragma unroll
          for (int q = 0; q < 3 * kHoCoeffs; ++q) far[(kHoS11 + q) * plane] = sig[q];
        });
      }
    });
    window_sync(cluster, pos);

    // Velocity phase: the cone's nodes in the window's nodes [sub + 1, w - 1 - sub).
    const int nl0 = max(cr[4 + along_e] - own0, sub + 1 - wx0), nl1 = min(cr[5 + along_e] - own0, w - 1 - sub - wx0);
    const int nc0 = cr[4 + across_e] - ax0, nc1 = cr[5 + across_e] - ax0;
    each(nl0, nl1, nc0, nc1, [&](int li, int lj) {
      const int e = cell(li, lj);
      const int2 ij = band_ij(li, lj);
      const int at = kStaged ? 0 : const_at(ij);
      float uv[kUv];
#pragma unroll
      for (int p = 0; p < kUv; ++p) uv[p] = smem[p * plane + e];
      ho_velocity_update<kForm>(
          t, s,
          [&](int q, int p) {
            if constexpr (kStaged) {
              return cs[(1 + kHoPlanes * q + p) * plane + e];
            } else {
              return __ldg(ho_const_plane(k, q, p) + at);
            }
          },
          // Element (i + di, j + dj) of the band, di, dj in {-1, 0}: the
          // block's cells or its apron, zeros beyond the band.
          [&](int di, int dj, float* a11, float* a22, float* a12) {
            const int f = e + di * pitch + dj;
#pragma unroll
            for (int q = 0; q < kHoCoeffs; ++q) {
              a11[q] = smem[(kHoS11 + q) * plane + f];
              a22[q] = smem[(kHoS22 + q) * plane + f];
              a12[q] = smem[(kHoS12 + q) * plane + f];
            }
          },
          // Its widths: in the metric form from the width planes (zeros
          // beyond the band, whose stresses are zeros), else the scalars'.
          [&](int di, int dj) {
            if constexpr (kMetric && kStaged) {
              const int f = e + di * pitch + dj;
              return make_float2(cs[ho_width_plane(kForm, kHoDx) * plane + f],
                                 cs[ho_width_plane(kForm, kHoDy) * plane + f]);
            } else if constexpr (kMetric) {
              const int f = const_at(make_int2(ij.x + di, ij.y + dj));
              return f >= 0 ? make_float2(__ldg(k.dx + f), __ldg(k.dy + f)) : make_float2(0.0f, 0.0f);
            } else {
              return ho_uniform_widths(s);
            }
          },
          uv);
#pragma unroll
      for (int p = 0; p < kUv; ++p) smem[p * plane + e] = uv[p];
      if (li == 0 || lj == 0) {
        push(li, lj, -1, [&](float* far) {
#pragma unroll
          for (int p = 0; p < kUv; ++p) far[p * plane] = uv[p];
        });
      }
    });
    window_sync(cluster, pos);  // the last one also keeps the cluster together until no block writes another
  }

  // The patch cells of the window's interior along the band, [n_sub, w -
  // n_sub), into the 17 (nx, ny) planes of `out`.
  const long gplane = static_cast<long>(src.nx) * src.ny;
  each(0, seg, 0, rows, [&](int li, int lj) {
    const int l = kAlong ? lj : li;
    const int2 ij = band_ij(li, lj);
    if (ij.x < bands.pr0 || ij.x >= bands.pr0 + bands.prn || ij.y < bands.pc0 ||
        ij.y >= bands.pc0 + bands.pcn || wx0 + l < n_sub || wx0 + l >= w - n_sub) {
      return;
    }
    const long own = static_cast<long>(r0 + ij.x - src.hx) * src.ny + (c0 + ij.y - src.hy);
    const int e = cell(li, lj);
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) out[p * gplane + own] = smem[p * plane + e];
  });
}

using RdmaBandHoKernel = void (*)(RdmaHoSources, RdmaBands, HoConsts, int, int, int, int, RdmaCone,
                                  float*, HoScalars, HoTables);

// The instance of a band axis (long_axis: 1 the x bands, 0 the y bands).
template <int kForm, bool kWrap, bool kStaged>
RdmaBandHoKernel rdma_band_ho_select(int long_axis) {
  return long_axis ? rdma_band_ho_kernel<1, kForm, kWrap, kStaged>
                   : rdma_band_ho_kernel<0, kForm, kWrap, kStaged>;
}

// Every form (kHoWeighted, kHoMetric) of one mesh kind (kMetric), closed or
// on a ring, with staged or L2 consts; null for another form.
template <bool kMetric, bool kStaged>
RdmaBandHoKernel rdma_band_ho_form_select(int long_axis, int form, bool wrap) {
  constexpr int kBase = kMetric ? kHoMetric : 0;
  switch (form) {
    case kBase:
      return wrap ? rdma_band_ho_select<kBase, true, kStaged>(long_axis)
                  : rdma_band_ho_select<kBase, false, kStaged>(long_axis);
    case kBase | kHoWeighted:
      return wrap ? rdma_band_ho_select<kBase | kHoWeighted, true, kStaged>(long_axis)
                  : rdma_band_ho_select<kBase | kHoWeighted, false, kStaged>(long_axis);
    default: return nullptr;
  }
}

// The instances of the forms: mevp_rdma_ho_forms.cu (the A-weighted one,
// closed or on a ring, and the unweighted ring, of a uniform mesh, staged),
// mevp_rdma_ho_metric.cu (every form of a graded or spherical mesh,
// staged) and mevp_rdma_ho_l2.cu (every form with L2 consts); the closed
// unweighted uniform staged one is mevp_rdma_ho.cu's. Null for another
// form.
RdmaBandHoKernel rdma_band_ho_forms_of(int long_axis, int form, bool wrap);
RdmaBandHoKernel rdma_band_ho_metric_of(int long_axis, int form, bool wrap);
RdmaBandHoKernel rdma_band_ho_l2_of(int long_axis, int form, bool wrap);

}  // namespace nst
