// The two halves of the higher-order (CG2/dG1) mEVP subcycle as grid-wide
// halo kernels of a rank block, templates on the form, shared by the two
// sources that instantiate them: ho_halves_spmd.cu (the unweighted form of
// a uniform mesh, and the entry points; the design is described there) and
// ho_halves_spmd_forms.cu (the A-weighted and metric forms).
#pragma once

#include "ho_body.cuh"
#include "mevp_spmd.cuh"

namespace nst {

// Everything a launch takes. state: the rank's 17 own planes (ho_flatten's
// order), updated in place. The strips have MevpHalo's layout, a strip a
// plane: the stress half's x and y are the +1 neighbours' first row and
// (extended) first column of the 8 velocity planes, the velocity half's the
// -1 neighbours' last row and (extended) last column of the 9 stress
// planes; width_x, width_y the velocity half's of the element widths dx and
// dy in the metric form (null otherwise).
struct HoHaloArgs {
  float* state;
  HoConsts k;
  const float* strip_x;
  const float* strip_y;
  const float* width_x;
  const float* width_y;
  int nx, ny;
  HoScalars s;
  HoTables t;
};

// The stress half at element (i, j) of the block: ho_gather's 9 nodes of
// each velocity (node indices i..i+1, j..j+1, beyond the block from the
// strips), ho_stress_body, the element's 9 coefficients written in place.
template <int kForm>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    ho_stress_halo_kernel(const __grid_constant__ HoHaloArgs a) {
  constexpr bool kMetric = (kForm & kHoMetric) != 0;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = a.nx, ny = a.ny;
  if (i >= nx || j >= ny) return;
  const long plane = static_cast<long>(nx) * ny;
  const long ij = static_cast<long>(i) * ny + j;
  const int row = ny, col = nx + 1;
  float u[kHoNodes], v[kHoNodes];
  const auto gather = [&](int first, float* out) {
    ho_gather(
        [&](int p, int di, int dj) {
          const int q = first + p;
          return plus_at(a.state + q * plane, a.strip_x + q * row, a.strip_y + q * col, i + di,
                         j + dj, nx, ny);
        },
        out);
  };
  gather(0, u);
  gather(kHoPlanes, v);
  float sig[3 * kHoCoeffs];  // s11, s22, s12: planes kHoS11 .. kHoS12 + 2
#pragma unroll
  for (int q = 0; q < 3 * kHoCoeffs; ++q) sig[q] = a.state[(kHoS11 + q) * plane + ij];
  const float strength = __ldg(a.k.strength + ij);
  if constexpr (kMetric) {
    ho_stress_body(a.t, a.s, u, v, sig, sig + kHoCoeffs, sig + 2 * kHoCoeffs, strength,
                   __ldg(a.k.inv_dx + ij), __ldg(a.k.inv_dy + ij));
  } else {
    ho_stress_body(a.t, a.s, u, v, sig, sig + kHoCoeffs, sig + 2 * kHoCoeffs, strength,
                   a.s.inv_dx, a.s.inv_dy);
  }
#pragma unroll
  for (int q = 0; q < 3 * kHoCoeffs; ++q) a.state[(kHoS11 + q) * plane + ij] = sig[q];
}

// The velocity half at node index (i, j) of the block: ho_node_forces on
// the four elements (i-1..i, j-1..j; beyond the block their coefficients,
// and in the metric form their widths, from the strips), ho_velocity_body,
// the node's 8 velocity values written in place.
template <int kForm>
__global__ void __launch_bounds__(kBlockX * kBlockY)
    ho_velocity_halo_kernel(const __grid_constant__ HoHaloArgs a) {
  constexpr bool kMetric = (kForm & kHoMetric) != 0;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  const int nx = a.nx, ny = a.ny;
  if (i >= nx || j >= ny) return;
  const long plane = static_cast<long>(nx) * ny;
  const long ij = static_cast<long>(i) * ny + j;
  const int row = ny, col = nx + 1;
  float uv[2 * kHoPlanes];
#pragma unroll
  for (int p = 0; p < 2 * kHoPlanes; ++p) uv[p] = a.state[p * plane + ij];
  // Stress plane q (0..8 from kHoS11) of element (i + di, j + dj).
  const auto stress = [&](int q, int di, int dj) {
    return minus_at<false>(a.state + (kHoS11 + q) * plane, a.strip_x + q * row,
                           a.strip_y + q * col, i + di, j + dj, ny);
  };
  const auto load = [&](int di, int dj, float* s11, float* s22, float* s12) {
#pragma unroll
    for (int c = 0; c < kHoCoeffs; ++c) {
      s11[c] = stress(c, di, dj);
      s22[c] = stress(kHoCoeffs + c, di, dj);
      s12[c] = stress(2 * kHoCoeffs + c, di, dj);
    }
  };
  const auto widths = [&](int di, int dj) {
    if constexpr (kMetric) {
      return make_float2(minus_at<true>(a.k.dx, a.width_x, a.width_y, i + di, j + dj, ny),
                         minus_at<true>(a.k.dy, a.width_x + row, a.width_y + col, i + di, j + dj, ny));
    } else {
      return ho_uniform_widths(a.s);
    }
  };
  ho_velocity_body<kForm>(a.t, a.s, a.k, ij, load, widths, uv);
#pragma unroll
  for (int p = 0; p < 2 * kHoPlanes; ++p) a.state[p * plane + ij] = uv[p];
}

using HoHaloKernel = void (*)(const HoHaloArgs);

// The instance of a half (0: stress, 1: velocity) of a form.
template <int kForm>
HoHaloKernel ho_halo_kernel_of(int half) {
  return half == 0 ? ho_stress_halo_kernel<kForm> : ho_velocity_halo_kernel<kForm>;
}

// The A-weighted and metric instances (ho_halves_spmd_forms.cu); null for
// form 0 and an unknown form.
HoHaloKernel ho_halo_forms_of(int half, int form);

}  // namespace nst
