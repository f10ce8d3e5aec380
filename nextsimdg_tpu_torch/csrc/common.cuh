// Shared helpers of the dynamics kernels.
//
// Every field is a row-major (nx, ny) float32 plane in the owned layout of
// nextsimdg_tpu_torch/dynamics/stencil.py: element (i, j), node (i, j) and
// the left/bottom faces of element (i, j) all sit at index i * ny + j. On a
// closed axis the i = nx and j = ny nodes and faces are implicit walls: a
// read out of range is a zero, never a clamped index; on a periodic axis it
// wraps (kWrapX, kWrapY).
//
// The kernels are built with --fmad=false, so that each multiply and add
// rounds on its own, as the plain PyTorch version's separate operations do.
#pragma once

#include <cuda_runtime.h>

namespace nst {

constexpr int kBlockX = 32;  // threads along j (the contiguous axis)
constexpr int kBlockY = 8;   // threads along i

// f[i, j], or 0 beyond the owned range (closed walls).
__device__ __forceinline__ float at(const float* f, int i, int j, int nx, int ny) {
  return (i >= 0 && i < nx && j >= 0 && j < ny) ? f[i * ny + j] : 0.0f;
}

// Periodic axes: bits of a launch's `wrap` (the host's coupled_cuda.wrap_bits).
// On a periodic axis index n is index 0 and index -1 is n - 1: a read
// beyond the range wraps instead of reading a zero, and there is no wall.
// Every kernel takes the periodic form as a template argument (kWrap), so
// that its closed instances keep their code, and reads `wrap` only there.
constexpr int kWrapX = 1, kWrapY = 2;
// The host passes an mEVP kernel's form and its periodic axes in one int:
// the momentum form's bits, then kWrapX and kWrapY shifted by this.
constexpr int kFormWrapShift = 2;

// i modulo n, in [0, n), for any i; the integer remainder only where i
// lies outside [0, n) (the seam), so that a wrapped form pays it at the
// domain's edge and not at every cell.
__device__ __forceinline__ int wrap_index(int i, int n) {
  if (i >= 0 && i < n) return i;
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// (i, j) wrapped on the periodic axes of `wrap`.
__device__ __forceinline__ void wrap_ij(int& i, int& j, int nx, int ny, int wrap) {
  if (wrap & kWrapX) i = wrap_index(i, nx);
  if (wrap & kWrapY) j = wrap_index(j, ny);
}

// (i, j), at most one cell beyond the range (a neighbour), wrapped on the
// periodic axes of `wrap` by one add or subtract.
__device__ __forceinline__ void wrap_near_ij(int& i, int& j, int nx, int ny, int wrap) {
  if (wrap & kWrapX) i = i < 0 ? i + nx : (i >= nx ? i - nx : i);
  if (wrap & kWrapY) j = j < 0 ? j + ny : (j >= ny ? j - ny : j);
}

// at() of a neighbour on the axes of `wrap`: a periodic axis wraps, a
// closed one reads 0.
__device__ __forceinline__ float at_wrap(const float* f, int i, int j, int nx, int ny, int wrap) {
  wrap_near_ij(i, j, nx, ny, wrap);
  return at(f, i, j, nx, ny);
}

// Row of cell idx of a region r cells wide, by a float multiply instead of
// an integer division: (idx + 0.5) / r lies at least 0.5 / r from an
// integer and the product errs by less than r * 2^-22, so the truncation
// is exact for r up to 1024. inv_r is 1.0f / r.
__device__ __forceinline__ int region_row(int idx, float inv_r) {
  return static_cast<int>((static_cast<float>(idx) + 0.5f) * inv_r);
}

inline dim3 plane_grid(int nx, int ny) {
  return dim3((ny + kBlockX - 1) / kBlockX, (nx + kBlockY - 1) / kBlockY);
}

inline dim3 plane_block() { return dim3(kBlockX, kBlockY); }

}  // namespace nst
