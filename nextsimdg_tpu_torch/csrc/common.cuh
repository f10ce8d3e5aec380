// Shared helpers of the dynamics kernels.
//
// Every field is a row-major (nx, ny) float32 plane in the owned layout of
// nextsimdg_tpu_torch/dynamics/stencil.py: element (i, j), node (i, j) and
// the left/bottom faces of element (i, j) all sit at index i * ny + j. The
// i = nx and j = ny nodes and faces are implicit walls: a read out of range
// is a zero, never a clamped index.
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
