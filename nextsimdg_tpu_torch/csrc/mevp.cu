// CG1 mEVP subcycle on Hopper: two kernels per subcycle.
//
// Replaces the mEVP part of the TPU kernel
// nextsimdg_tpu/dynamics/kernels/coupled_pallas.py::fused_dynamics_pallas,
// which keeps the whole grid resident on one core for all N subcycles. One
// 256^2 float32 plane (256 KiB) is already more than the shared memory of
// one SM, so here each subcycle is two grid-wide launches, one thread per
// element or node, with every plane in global memory:
//
//   mevp_stress    (elements): strain, Delta, the shared rheology/drag divide
//                  and the alpha-relaxed stress; writes s11, s22, s12 in place
//                  plus the node planes c_w and inv_drag.
//   mevp_velocity  (nodes):    stress divergence from elements (i-1..i,
//                  j-1..j) and the beta-relaxed velocity; writes u, v in place.
//
// In-place updates are safe: mevp_stress reads only its own stresses and
// mevp_velocity only its own velocity; the neighbour reads are of planes the
// kernel does not write. Both take the 7 uniform consts or, on a graded or
// spherical mesh, the 12 with the metric planes (a template on which).
//
// What bounds it on the H100: each subcycle moves about 116 bytes per
// element (mevp_stress reads 10 planes and writes 5, mevp_velocity reads 12
// and writes 2). At 256^2 that is 7.6 MB, 2.3 us at 3.35 TB/s, but the
// ~25-plane working set (~6 MB) stays in the 50 MB L2, so the launch
// latency of 2 launches per subcycle is the expected bound. The persistent
// single-launch form of the same subcycle is mevp_single.cu.
//
// The per-element and per-node code lives in mevp_body.cuh, shared with the
// tiled schedule of mevp_tiled.cu and with mevp_single.cu.
#include <cstring>

#include "mevp_body.cuh"

namespace nst {

template <bool kMetric>
__global__ void mevp_stress_kernel(MevpState p, MevpConsts k, int nx, int ny, MevpScalars s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i < nx && j < ny) stress_cell<kMetric>(p, k, i, j, nx, ny, s);
}

template <bool kMetric>
__global__ void mevp_velocity_kernel(MevpState p, MevpConsts k, int nx, int ny,
                                     MevpScalars s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i < nx && j < ny) velocity_cell<kMetric>(p, k, i, j, nx, ny, s);
}

// Unpacks the host's arguments shared by the entry points below.
inline void unpack(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                   float* inv_drag, const void* const* consts, const float* scalars,
                   MevpState& p, MevpConsts& k, MevpScalars& s) {
  p = {u, v, s11, s22, s12, c_w, inv_drag};
  std::memcpy(&k, consts, sizeof(k));
  std::memcpy(&s, scalars, sizeof(s));
}

}  // namespace nst

extern "C" {

int nst_mevp_n_scalars() { return sizeof(nst::MevpScalars) / sizeof(float); }

// Each entry point launches one kernel on `stream` (the caller's PyTorch
// stream) and returns cudaGetLastError(); it does not synchronise. consts
// points to the 12 const-plane pointers in the order of MevpConsts, the last
// five null on a uniform mesh.
int nst_mevp_stress(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                    float* inv_drag, const void* const* consts, int nx, int ny,
                    const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::MevpState p;
  nst::MevpConsts k;
  nst::MevpScalars s;
  nst::unpack(u, v, s11, s22, s12, c_w, inv_drag, consts, scalars, p, k, s);
  const auto kernel = k.inv_dx != nullptr ? nst::mevp_stress_kernel<true>
                                          : nst::mevp_stress_kernel<false>;
  kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
           static_cast<cudaStream_t>(stream)>>>(p, k, nx, ny, s);
  return static_cast<int>(cudaGetLastError());
}

// c_w and inv_drag are read here (written by nst_mevp_stress).
int nst_mevp_velocity(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                      float* inv_drag, const void* const* consts, int nx, int ny,
                      const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  nst::MevpState p;
  nst::MevpConsts k;
  nst::MevpScalars s;
  nst::unpack(u, v, s11, s22, s12, c_w, inv_drag, consts, scalars, p, k, s);
  const auto kernel = k.inv_dx != nullptr ? nst::mevp_velocity_kernel<true>
                                          : nst::mevp_velocity_kernel<false>;
  kernel<<<nst::plane_grid(nx, ny), nst::plane_block(), 0,
           static_cast<cudaStream_t>(stream)>>>(p, k, nx, ny, s);
  return static_cast<int>(cudaGetLastError());
}

const char* nst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
