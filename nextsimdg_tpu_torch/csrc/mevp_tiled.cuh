// The CG1 mEVP ghost-zone tiled kernel (mevp_tiled.cu) as a template on the
// mesh, the window width, the momentum form and the periodic form, shared
// by the two sources that instantiate it: mevp_tiled.cu (the closed
// instances, and the entry points) and mevp_tiled_periodic.cu (the
// periodic ones), which nvcc compiles in parallel. The design is described
// in mevp_tiled.cu.
#pragma once

#include "mevp_body.cuh"

namespace nst {

constexpr int kTiledMaxThreads = 1024;  // the block size is a launch parameter
constexpr int kTiledStatePlanes = 5;    // u, v, s11, s22, s12
constexpr int kTiledMaxCells = 8;       // window rows a thread owns, at most

// kW: the window width where it is known at compile time (shared-memory
// offsets become immediates), 0 where it is read from tile and halo.
// kForm: the momentum form. kWrap: the periodic form, whose windows wrap on
// the axes of `wrap` (a runtime flag); without it `wrap` is not read and
// the code is the closed domain's.
template <bool kMetric, int kW, int kForm, bool kWrap>
__global__ void __launch_bounds__(kTiledMaxThreads)
mevp_tiled_kernel(const float* __restrict__ u_in, const float* __restrict__ v_in,
                  const float* __restrict__ s11_in, const float* __restrict__ s22_in,
                  const float* __restrict__ s12_in, float* __restrict__ u_out,
                  float* __restrict__ v_out, float* __restrict__ s11_out,
                  float* __restrict__ s22_out, float* __restrict__ s12_out,
                  MevpConsts k, int nx, int ny, int tile, int halo, int n_sub,
                  MevpScalars s, int wrap) {
  extern __shared__ float smem[];
  const int w = kW ? kW : tile + 2 * halo;  // window width, both axes
  const int plane = w * w;
  float* su = smem;
  float* sv = su + plane;
  float* s11 = sv + plane;
  float* s22 = s11 + plane;
  float* s12 = s22 + plane;

  // Window cell (a, b) is grid cell (i0 + a, j0 + b). This thread owns
  // column b of rows a0, a0 + rows, ... < w.
  const int i0 = blockIdx.y * tile - halo;
  const int j0 = blockIdx.x * tile - halo;
  const int rows = blockDim.x / w;
  const int a0 = threadIdx.x / w;
  const int b = threadIdx.x - a0 * w;
  const int j = j0 + b;
  // On a periodic axis every window cell is a domain cell: (i, j) wraps to
  // its domain index (iw, jw), and the ring limits alone bound the phases.
  // The closed instances (kWrap false) run the closed domain's expressions
  // as they are written in each `if constexpr` branch below.
  const bool wx = kWrap && (wrap & kWrapX) != 0, wy = kWrap && (wrap & kWrapY) != 0;
  const int jw = wy ? wrap_index(j, ny) : j;
  // Ring limits along the columns: this thread's cells are elements while
  // sub <= eb and nodes while sub <= nb (-1: never, beyond the domain).
  bool in_j;
  if constexpr (kWrap) {
    in_j = a0 < rows && (wy || (j >= 0 && j < ny));
  } else {
    in_j = a0 < rows && j >= 0 && j < ny;
  }
  const int eb = in_j ? min(b, w - 2 - b) : -1;
  const int nb = in_j ? min(b - 1, w - 2 - b) : -1;
  const int a_end = in_j ? w : 0;  // rows past it: none of this thread's

  // fn(q, a) over the owned rows a; q is the cell's register slot.
  const auto owned = [&](auto fn) {
#pragma unroll
    for (int q = 0; q < kTiledMaxCells; ++q) {
      int a = a0 + q * rows;
      // Opaque to the compiler, so that the cells' addresses are not all
      // hoisted out of the subcycle loop into registers (they spill).
      asm volatile("" : "+r"(a));
      if (a < a_end) fn(q, a);
    }
  };
  const auto cst = [&](int p, int ij) { return __ldg(mevp_const_plane(k, p) + ij); };

  // The load: the window's state, zeros beyond the domain. Threads beyond
  // rows x w own nothing.
#pragma unroll 1
  for (int a = a0; a < (a0 < rows ? w : 0); a += rows) {
    const int c = a * w + b, i = i0 + a;
    int ij;
    bool in;
    if constexpr (kWrap) {
      ij = (wx ? wrap_index(i, nx) : i) * ny + jw;
      in = in_j && (wx || (i >= 0 && i < nx));
    } else {
      ij = i * ny + j;
      in = in_j && i >= 0 && i < nx;
    }
    if (in) {
      su[c] = u_in[ij];
      sv[c] = v_in[ij];
      s11[c] = s11_in[ij];
      s22[c] = s22_in[ij];
      s12[c] = s12_in[ij];
    } else {
      su[c] = sv[c] = s11[c] = s22[c] = s12[c] = 0.0f;
    }
  }
  __syncthreads();

  float cw[kTiledMaxCells], inv[kTiledMaxCells], bt[kTiledMaxCells];
  for (int sub = 0; sub < n_sub; ++sub) {
    // Stress phase: element (a, b), elements [sub, w - 1 - sub) along each
    // axis, reads nodes a..a+1, b..b+1.
    owned([&](int q, int a) {
      const int i = i0 + a;
      int ij;
      if constexpr (kWrap) {
        if ((!wx && (i < 0 || i >= nx)) || sub > min(eb, min(a, w - 2 - a))) return;
        ij = (wx ? wrap_index(i, nx) : i) * ny + jw;
      } else {
        if (i < 0 || i >= nx || sub > min(eb, min(a, w - 2 - a))) return;
        ij = i * ny + j;
      }
      const int c = a * w + b;
      const StressOut o = mevp_stress_body<kForm>(
          su[c], su[c + w], su[c + 1], su[c + w + 1], sv[c], sv[c + w], sv[c + 1],
          sv[c + w + 1], s11[c], s22[c], s12[c], cst(kStrength, ij), cst(kDtM, ij),
          cst(kActive, ij), cst(kUo, ij), cst(kVo, ij),
          kMetric ? __ldg(k.inv_dx + ij) : s.inv_dx, kMetric ? __ldg(k.inv_dy + ij) : s.inv_dy,
          s, form_a_node<kForm>(k, ij), form_inv_area<kMetric, kForm>(k, ij, s));
      s11[c] = o.s11;
      s22[c] = o.s22;
      s12[c] = o.s12;
      cw[q] = o.c_w;
      inv[q] = o.inv_drag;
      if constexpr ((kForm & kFormAdaptive) != 0) bt[q] = o.beta;
    });
    __syncthreads();

    // Velocity phase: node (a, b), nodes [sub + 1, w - 1 - sub), reads
    // elements a-1..a, b-1..b and the c_w and inv_drag that this thread
    // computed at element (a, b) above.
    owned([&](int q, int a) {
      const int i = i0 + a;
      int iw, ij;
      if constexpr (kWrap) {
        if ((!wx && (i < 0 || i >= nx)) || sub > min(nb, min(a - 1, w - 2 - a))) return;
        iw = wx ? wrap_index(i, nx) : i;
        ij = iw * ny + jw;
      } else {
        if (i < 0 || i >= nx || sub > min(nb, min(a - 1, w - 2 - a))) return;
        iw = i;
        ij = i * ny + j;
      }
      const int c = a * w + b;
      float2 f;
      float inv_node_w;
      if (kMetric) {
        const auto weighted = [&](const float* sp, const float* fp) {
          return kWrap ? weighted_tile_wrap(sp, fp, c, w, iw, jw, nx, ny, wrap)
                       : weighted_tile(sp, fp, c, w, ij, i, j, nx, ny);
        };
        f = forces_metric(weighted(s11, k.half_dy), weighted(s12, k.half_dx),
                          weighted(s12, k.half_dy), weighted(s22, k.half_dx));
        inv_node_w = __ldg(k.inv_w + ij);
      } else {
        const Around a11 = {s11[c], s11[c - w], s11[c - 1], s11[c - w - 1]};
        const Around a22 = {s22[c], s22[c - w], s22[c - 1], s22[c - w - 1]};
        const Around a12 = {s12[c], s12[c - w], s12[c - 1], s12[c - w - 1]};
        f = forces_uniform(a11, a22, a12, s);
        inv_node_w = s.inv_w;
      }
      const float2 uv = mevp_velocity_body(
          f, inv_node_w, su[c], sv[c], cst(kUo, ij), cst(kVo, ij), cw[q], cst(kDtM, ij),
          cst(kBu, ij), cst(kBv, ij), inv[q], (kForm & kFormAdaptive) != 0 ? bt[q] : s.beta, s);
      su[c] = uv.x;
      sv[c] = uv.y;
    });
    __syncthreads();
  }

  // The T x T interior (window cells [halo, halo + tile)) is exact.
  if (b < halo || b >= halo + tile || j >= ny || a0 >= rows) return;
#pragma unroll 1
  for (int a = a0; a < halo + tile; a += rows) {
    const int i = i0 + a;
    if (a < halo || i >= nx) continue;
    const int c = a * w + b, ij = i * ny + j;
    u_out[ij] = su[c];
    v_out[ij] = sv[c];
    s11_out[ij] = s11[c];
    s22_out[ij] = s22[c];
    s12_out[ij] = s12[c];
  }
}

using TiledKernel = void (*)(const float*, const float*, const float*, const float*,
                             const float*, float*, float*, float*, float*, float*, MevpConsts,
                             int, int, int, int, int, MevpScalars, int);

template <bool kMetric, int kForm, bool kWrap>
TiledKernel tiled_kernel_of(int w) {
  return w == 80 ? mevp_tiled_kernel<kMetric, 80, kForm, kWrap>
                 : mevp_tiled_kernel<kMetric, 0, kForm, kWrap>;
}

template <int kForm, bool kWrap>
TiledKernel tiled_kernel_of(bool metric, int w) {
  return metric ? tiled_kernel_of<true, kForm, kWrap>(w) : tiled_kernel_of<false, kForm, kWrap>(w);
}

// The instance of a momentum form at window width w, closed or (kWrap)
// periodic; null for an unknown form.
template <bool kWrap>
TiledKernel tiled_kernel_of_form(bool metric, int form, int w) {
  switch (form) {
    case 0: return tiled_kernel_of<0, kWrap>(metric, w);
    case kFormWeighted: return tiled_kernel_of<kFormWeighted, kWrap>(metric, w);
    case kFormAdaptive: return tiled_kernel_of<kFormAdaptive, kWrap>(metric, w);
    case kFormWeighted | kFormAdaptive: return tiled_kernel_of<kFormWeighted | kFormAdaptive, kWrap>(metric, w);
    default: return nullptr;
  }
}

// The periodic instances, compiled in mevp_tiled_periodic.cu.
TiledKernel tiled_kernel_periodic(bool metric, int form, int w);

}  // namespace nst
