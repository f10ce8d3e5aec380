// The HO (CG2/dG1) form of rdma_band: n_sub HO subcycles on the edge bands
// of an rdma round, as a template on the band's axis, the form (kHoWeighted,
// kHoMetric) and the ring along the band, shared by the sources that
// instantiate it: mevp_rdma_ho.cu (the closed uniform instances and the
// entry points), mevp_rdma_ho_forms.cu (the A-weighted form and the ring on
// a uniform mesh) and mevp_rdma_ho_metric.cu (a graded or spherical mesh),
// which nvcc compiles in parallel. The design is described in
// mevp_rdma_ho.cu.
#pragma once

#include "ho_body.cuh"
#include "mevp_rdma.cuh"

namespace nst {

static_assert(kRdmaHoPlanes == kHoStatePlanes, "the HO round moves the HO state's planes");

using RdmaHoSources = RdmaSourcesT<kHoStatePlanes>;

// The HO band's launch bound: blocks of up to 256 threads, two an SM, so
// the HO body keeps up to 128 registers a thread, as in ho_tiled.
constexpr int kRdmaHoThreads = 256;
constexpr int kRdmaHoMinBlocks = 2;

// n_sub HO subcycles on one band of a pair (blockIdx.z: lo or hi) by
// clusters of blocks along the band's long axis (kAlong 1: along the
// columns, the x bands; 0: along the rows, the y bands), in the cluster
// geometry of the CG1 rdma_band_kernel (mevp_rdma.cuh): block x of a
// cluster keeps the seg cells from x seg of the cluster's window and a
// one-cell apron on either side along the band, across the whole band, in
// 17 planes of shared memory. Each phase of a subcycle runs the cells of
// the patch's cone (RdmaCone) that lie in the block and in the window's
// valid ring, row by row in one flat loop over the block's threads (no
// fixed cell ownership: the HO consts stay in global memory, as in
// ho_tiled, and are read by offset from the rank's widened planes at their
// use). A cell on the block's last (first) position along the band pushes
// its new stresses (velocities) into the apron of the next (previous)
// block of the cluster. The bodies are ho_body.cuh's, with this band's
// accessors: the same operations on the same values as ho_tiled on the
// widened block. kForm: kHoWeighted (the a_{k} planes among the consts),
// kHoMetric (each element's widths read from the width planes, zeros
// beyond the band as beyond a closed domain); kWrap: the band spans a
// periodic axis that is not split over ranks, and a position beyond
// either end along it reads the band's cell on the other side.
template <int kAlong, int kForm, bool kWrap>
__global__ void __launch_bounds__(kRdmaHoThreads, kRdmaHoMinBlocks)
rdma_band_ho_kernel(RdmaHoSources src, RdmaBands bands, HoConsts k, int ld, int seg, int n_sub,
                    RdmaCone cone, float* __restrict__ out, HoScalars s, HoTables t) {
  constexpr bool kMetric = (kForm & kHoMetric) != 0;
  extern __shared__ float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const ClusterPos pos = cluster_pos(cluster);
  const int z = blockIdx.z;
  const int r0 = bands.r0[z], c0 = bands.c0[z];
  const int across = kAlong ? bands.rows : bands.cols;
  // Band cell (i, j) is stored row-major in band orientation, as in the
  // CG1 band: x bands `across` rows of seg + 2 cells (the apron at either
  // end); y bands seg + 2 rows of across + 1 cells (one of padding, zero).
  // Position l along the band (-1 and seg: the apron), cell c across it.
  // In both orientations band row i + 1 is `pitch` further and band column
  // j + 1 one further.
  const int pitch = kAlong ? seg + 2 : across + 1;
  const int plane = (kAlong ? across : seg + 2) * pitch;
  const auto cell = [&](int l, int c) { return kAlong ? c * pitch + l + 1 : (l + 1) * pitch + c; };
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
  // ring), or -1 beyond the band.
  const auto const_at = [&](int2 ij) {
    ij = wrapped(ij);
    return in_band(ij) ? (ij.x + r0) * ld + (ij.y + c0) : -1;
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
    for (int p = 0; p < kHoStatePlanes; ++p) {
      smem[p * plane + e] = in ? load_e(src, p, r0 + ij.x, c0 + ij.y) : 0.0f;
    }
  }
  window_sync(cluster, pos);

  // fn(l, c) on the block's positions l in [l0, l1) and the cells c in [a0,
  // a1) across the band, row by row in band orientation (consecutive
  // threads on consecutive cells of a band row).
  const auto each = [&](int l0, int l1, int a0, int a1, auto fn) {
    const int nl = l1 - l0, na = a1 - a0;
    if (nl <= 0 || na <= 0) return;
    const int inner = kAlong ? nl : na;
    const float inv_inner = 1.0f / static_cast<float>(inner);
    for (int idx = threadIdx.x; idx < nl * na; idx += blockDim.x) {
      const int outer = region_row(idx, inv_inner), in = idx - outer * inner;
      if (kAlong) {
        fn(l0 + in, a0 + outer);
      } else {
        fn(l0 + outer, a0 + in);
      }
    }
  };
  // The cone's ranges along the band are in cr[2 kAlong ..], across it in
  // cr[2 (1 - kAlong) ..] (rows first, then columns; elements, then nodes).
  const int along_e = 2 * kAlong, across_e = 2 * (1 - kAlong);
  for (int sub = 0; sub < n_sub; ++sub) {
    const int* cr = cone.r[sub];
    // Stress phase: the cone's elements in the window's elements [sub, w - 1 - sub).
    each(max(max(cr[along_e] - own0, sub - wx0), 0), min(min(cr[along_e + 1] - own0, w - 1 - sub - wx0), seg),
         cr[across_e], cr[across_e + 1], [&](int l, int c) {
      const int e = cell(l, c);
      float u[kHoNodes], v[kHoNodes];
      ho_gather([&](int p, int di, int dj) { return smem[p * plane + e + di * pitch + dj]; }, u);
      ho_gather([&](int p, int di, int dj) { return smem[(kHoPlanes + p) * plane + e + di * pitch + dj]; },
                v);
      float s11[kHoCoeffs], s22[kHoCoeffs], s12[kHoCoeffs];
#pragma unroll
      for (int q = 0; q < kHoCoeffs; ++q) {
        s11[q] = smem[(kHoS11 + q) * plane + e];
        s22[q] = smem[(kHoS22 + q) * plane + e];
        s12[q] = smem[(kHoS12 + q) * plane + e];
      }
      const int at = const_at(band_ij(l, c));
      if constexpr (kMetric) {
        ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + at), __ldg(k.inv_dx + at),
                       __ldg(k.inv_dy + at));
      } else {
        ho_stress_body(t, s, u, v, s11, s22, s12, __ldg(k.strength + at), s.inv_dx, s.inv_dy);
      }
      float* far = nullptr;
      if (l == seg - 1 && pos.x + 1 < pos.nx) {  // into the next block's apron
        far = cluster.map_shared_rank(smem, pos.rank(pos.x + 1, 0)) + cell(-1, c);
      }
#pragma unroll
      for (int q = 0; q < kHoCoeffs; ++q) {
        smem[(kHoS11 + q) * plane + e] = s11[q];
        smem[(kHoS22 + q) * plane + e] = s22[q];
        smem[(kHoS12 + q) * plane + e] = s12[q];
        if (far != nullptr) {
          far[(kHoS11 + q) * plane] = s11[q];
          far[(kHoS22 + q) * plane] = s22[q];
          far[(kHoS12 + q) * plane] = s12[q];
        }
      }
    });
    window_sync(cluster, pos);

    // Velocity phase: the cone's nodes in the window's nodes [sub + 1, w - 1 - sub).
    each(max(max(cr[4 + along_e] - own0, sub + 1 - wx0), 0),
         min(min(cr[5 + along_e] - own0, w - 1 - sub - wx0), seg), cr[4 + across_e], cr[5 + across_e],
         [&](int l, int c) {
      const int e = cell(l, c);
      const int2 ij = band_ij(l, c);
      const int at = const_at(ij);
      float uv[2 * kHoPlanes];
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) uv[p] = smem[p * plane + e];
      ho_velocity_update<kForm>(
          t, s, [&](int q, int p) { return __ldg(ho_const_plane(k, q, p) + at); },
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
            if constexpr (kMetric) {
              const int f = const_at(make_int2(ij.x + di, ij.y + dj));
              return f >= 0 ? make_float2(__ldg(k.dx + f), __ldg(k.dy + f)) : make_float2(0.0f, 0.0f);
            } else {
              return ho_uniform_widths(s);
            }
          },
          uv);
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) smem[p * plane + e] = uv[p];
      if (l == 0 && pos.x > 0) {  // into the previous block's apron
        float* far = cluster.map_shared_rank(smem, pos.rank(pos.x - 1, 0)) + cell(seg, c);
#pragma unroll
        for (int p = 0; p < 2 * kHoPlanes; ++p) far[p * plane] = uv[p];
      }
    });
    window_sync(cluster, pos);  // the last one also keeps the cluster together until no block writes another
  }

  // The patch cells of the window's interior along the band, [n_sub, w -
  // n_sub), row by row, into the 17 (nx, ny) planes of `out`.
  const long gplane = static_cast<long>(src.nx) * src.ny;
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
    const long own = static_cast<long>(r0 + ij.x - src.hx) * src.ny + (c0 + ij.y - src.hy);
    const int e = cell(pl, pc);
#pragma unroll
    for (int p = 0; p < kHoStatePlanes; ++p) out[p * gplane + own] = smem[p * plane + e];
  }
}

using RdmaBandHoKernel = void (*)(RdmaHoSources, RdmaBands, HoConsts, int, int, int, RdmaCone,
                                  float*, HoScalars, HoTables);

// The instance of a band axis (long_axis: 1 the x bands, 0 the y bands).
template <int kForm, bool kWrap>
RdmaBandHoKernel rdma_band_ho_select(int long_axis) {
  return long_axis ? rdma_band_ho_kernel<1, kForm, kWrap> : rdma_band_ho_kernel<0, kForm, kWrap>;
}

// The instances of the forms: mevp_rdma_ho_forms.cu (the A-weighted one,
// closed or on a ring, and the unweighted ring, of a uniform mesh) and
// mevp_rdma_ho_metric.cu (every form of a graded or spherical mesh); the
// closed unweighted uniform one is mevp_rdma_ho.cu's. Null for another
// form.
RdmaBandHoKernel rdma_band_ho_forms_of(int long_axis, int form, bool wrap);
RdmaBandHoKernel rdma_band_ho_metric_of(int long_axis, int form, bool wrap);

}  // namespace nst
