// Higher-order (CG2/dG1) mEVP subcycles on Hopper in one call: a persistent
// cooperative kernel.
//
// Replaces the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_ho_pallas.py::ho_subcycles_pallas,
// which runs all N HO subcycles in one call with the 17 state planes (4 + 4
// CG2 velocity planes, 3 x 3 dG1 stress coefficients) and the 29 uniform
// const planes resident in one core's VMEM. A float32 plane at 256^2 is
// already more than an SM's shared memory, so on Hopper the grid cannot be
// resident in one block. This kernel keeps the TPU kernel's contract
// instead: one call, one launch, all N subcycles. It is launched
// cooperatively with as many blocks as can be resident at once, and each
// subcycle is
//
//   a grid-stride loop over elements: ho_stress_body (ho_body.cuh) from the
//       element's 9 node velocities, writing its 9 stress coefficients in
//       place;
//   grid.sync();
//   a grid-stride loop over node indices: the forces of the (up to) four
//       elements around it, then ho_velocity_body on its four owned planes,
//       writing its 8 velocity values in place;
//   grid.sync() (except after the last subcycle).
//
// In place is safe: the stress half writes only its element's
// coefficients and reads, besides them, only velocities; the velocity half
// writes only its node index's velocities and reads, besides them, only
// stresses, which the other half wrote before the last grid.sync(). The
// state is written during the launch by other blocks, so it is read with
// plain loads, never through the read-only (non-coherent) path; only the
// const planes go through __ldg.
//
// The element and node bodies are those of ho_tiled.cu, with the same
// --fmad=false, so the two schedules agree bit for bit.
//
// What bounds it on the H100: per subcycle it reads the 17 state planes
// (most neighbour reads hit L1), writes them, and reads the 29 const
// planes: ~63 planes, ~250 bytes per element. At 256^2 the 46 planes
// (11.5 MiB) stay in the 50 MB L2, and the ~900 float32 operations per
// element and two grid-wide barriers per subcycle set the time. At 1024^2
// (184 MiB) every subcycle streams from HBM. What it removes is the host:
// the plain version's several hundred launches per subcycle become one
// launch per step.
#include <cooperative_groups.h>

#include <cstring>

#include "ho_body.cuh"

namespace cg = cooperative_groups;

namespace nst {

constexpr int kHoSingleThreads = 256;

struct HoSingleArgs {
  float* state;  // (17, nx, ny), updated in place
  HoConsts k;
  int nx, ny, n_sub;
  HoScalars s;
  HoTables t;
};

__global__ void __launch_bounds__(kHoSingleThreads) ho_single_kernel(HoSingleArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int nx = a.nx, ny = a.ny;
  const long plane = static_cast<long>(nx) * ny;
  float* st = a.state;
  const long first = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long stride = static_cast<long>(gridDim.x) * blockDim.x;
  for (int sub = 0; sub < a.n_sub; ++sub) {
    // Stress half, element (i, j).
    for (long ij = first; ij < plane; ij += stride) {
      const int i = static_cast<int>(ij / ny), j = static_cast<int>(ij - static_cast<long>(i) * ny);
      float u[kHoNodes], v[kHoNodes];
      ho_gather([&](int p, int di, int dj) {
        const int ii = i + di, jj = j + dj;
        return ii < nx && jj < ny ? st[p * plane + static_cast<long>(ii) * ny + jj] : 0.0f;
      }, u);
      ho_gather([&](int p, int di, int dj) {
        const int ii = i + di, jj = j + dj;
        return ii < nx && jj < ny ? st[(kHoPlanes + p) * plane + static_cast<long>(ii) * ny + jj]
                                  : 0.0f;
      }, v);
      float s11[kHoCoeffs], s22[kHoCoeffs], s12[kHoCoeffs];
#pragma unroll
      for (int c = 0; c < kHoCoeffs; ++c) {
        s11[c] = st[(kHoS11 + c) * plane + ij];
        s22[c] = st[(kHoS22 + c) * plane + ij];
        s12[c] = st[(kHoS12 + c) * plane + ij];
      }
      ho_stress_body(a.t, a.s, u, v, s11, s22, s12, __ldg(a.k.strength + ij));
#pragma unroll
      for (int c = 0; c < kHoCoeffs; ++c) {
        st[(kHoS11 + c) * plane + ij] = s11[c];
        st[(kHoS22 + c) * plane + ij] = s22[c];
        st[(kHoS12 + c) * plane + ij] = s12[c];
      }
    }
    grid.sync();
    // Velocity half, node index (i, j).
    for (long ij = first; ij < plane; ij += stride) {
      const int i = static_cast<int>(ij / ny), j = static_cast<int>(ij - static_cast<long>(i) * ny);
      float uv[2 * kHoPlanes];
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) uv[p] = st[p * plane + ij];
      ho_velocity_body(a.t, a.s, a.k, ij,
                       [&](int di, int dj, float* s11, float* s22, float* s12) {
                         const int ii = i + di, jj = j + dj;
                         const bool inside = ii >= 0 && jj >= 0;
                         const long e = static_cast<long>(ii) * ny + jj;
#pragma unroll
                         for (int c = 0; c < kHoCoeffs; ++c) {
                           s11[c] = inside ? st[(kHoS11 + c) * plane + e] : 0.0f;
                           s22[c] = inside ? st[(kHoS22 + c) * plane + e] : 0.0f;
                           s12[c] = inside ? st[(kHoS12 + c) * plane + e] : 0.0f;
                         }
                       },
                       uv);
#pragma unroll
      for (int p = 0; p < 2 * kHoPlanes; ++p) st[p * plane + ij] = uv[p];
    }
    if (sub + 1 < a.n_sub) grid.sync();
  }
}

}  // namespace nst

extern "C" {

// The most blocks of ho_single that can be resident at once on `device`
// (the cooperative launch's limit), or minus a CUDA error code.
int nst_ho_single_max_blocks(int device) {
  cudaError_t err = cudaSetDevice(device);
  int per_sm = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, reinterpret_cast<const void*>(&nst::ho_single_kernel), nst::kHoSingleThreads, 0);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  return err == cudaSuccess ? per_sm * sms : -static_cast<int>(err);
}

int nst_ho_n_table_floats() { return static_cast<int>(sizeof(nst::HoTables) / sizeof(float)); }

int nst_ho_n_scalars() { return static_cast<int>(sizeof(nst::HoScalars) / sizeof(float)); }

// n_sub >= 1 subcycles in place on the (17, nx, ny) state, in one
// cooperative launch of `blocks` blocks of 256 threads (0: the most that can
// be resident, capped at one element per thread). consts points to the 29
// const-plane pointers in the order of HoConsts; scalars and tables to
// HoScalars and HoTables. A grid larger than the resident limit is refused
// by the launch with an error, which is returned; so is any other launch
// error. Launches on `stream`; does not synchronise.
int nst_ho_single(float* state, const void* const* consts, int nx, int ny, int n_sub,
                  int blocks, const float* scalars, const float* tables, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nx < 1 || ny < 1 || n_sub < 1 || blocks < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  nst::HoSingleArgs a;
  a.state = state;
  std::memcpy(&a.k, consts, sizeof(a.k));
  std::memcpy(&a.s, scalars, sizeof(a.s));
  std::memcpy(&a.t, tables, sizeof(a.t));
  a.nx = nx;
  a.ny = ny;
  a.n_sub = n_sub;
  if (blocks == 0) {
    blocks = nst_ho_single_max_blocks(device);
    if (blocks < 0) return -blocks;
    if (blocks == 0) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
    const long needed = (static_cast<long>(nx) * ny + nst::kHoSingleThreads - 1) /
                        nst::kHoSingleThreads;
    if (blocks > needed) blocks = static_cast<int>(needed);
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(&nst::ho_single_kernel),
                                    dim3(blocks), dim3(nst::kHoSingleThreads), args, 0,
                                    static_cast<cudaStream_t>(stream));
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error
  return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // extern "C"
