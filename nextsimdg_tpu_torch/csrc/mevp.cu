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
// spherical mesh, the 12 with the metric planes (a template on which), and
// a_node besides in the A-weighted form. The momentum form is a second
// template argument (mevp_body.cuh), the periodic form a third (kWrap: the
// neighbour reads wrap on the launch's periodic axes, a runtime flag; the
// closed instances are the code without it); in the adaptive form mevp_stress also
// writes each node's beta into a third node plane, which mevp_velocity
// reads: one more plane each way a subcycle.
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

// kWrap: the periodic form, whose neighbour reads wrap on the axes of
// `wrap`; without it (the closed instances) they read zeros beyond the
// domain, and `wrap` is 0.
template <bool kMetric, int kForm, bool kWrap>
__global__ void mevp_stress_kernel(MevpState p, MevpConsts k, int nx, int ny, MevpScalars s,
                                   int wrap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i < nx && j < ny) stress_cell<kMetric, kForm, kWrap>(p, k, i, j, nx, ny, s, wrap);
}

template <bool kMetric, int kForm, bool kWrap>
__global__ void mevp_velocity_kernel(MevpState p, MevpConsts k, int nx, int ny,
                                     MevpScalars s, int wrap) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i < nx && j < ny) velocity_cell<kMetric, kForm, kWrap>(p, k, i, j, nx, ny, s, wrap);
}

using HalfKernel = void (*)(MevpState, MevpConsts, int, int, MevpScalars, int);

// The instance of a half (0: stress, 1: velocity) for a mesh, form and wrap.
template <int kForm, bool kWrap>
HalfKernel half_kernel_of(int half, bool metric) {
  if (half == 0) {
    return metric ? mevp_stress_kernel<true, kForm, kWrap> : mevp_stress_kernel<false, kForm, kWrap>;
  }
  return metric ? mevp_velocity_kernel<true, kForm, kWrap> : mevp_velocity_kernel<false, kForm, kWrap>;
}

template <bool kWrap>
HalfKernel half_kernel(int half, bool metric, int form) {
  switch (form) {
    case 0: return half_kernel_of<0, kWrap>(half, metric);
    case kFormWeighted: return half_kernel_of<kFormWeighted, kWrap>(half, metric);
    case kFormAdaptive: return half_kernel_of<kFormAdaptive, kWrap>(half, metric);
    case kFormWeighted | kFormAdaptive:
      return half_kernel_of<kFormWeighted | kFormAdaptive, kWrap>(half, metric);
    default: return nullptr;
  }
}

// Launches one half (0: stress, 1: velocity) from the host's arguments:
// `form` holds the momentum form in its low bits and the periodic axes
// (kWrapX, kWrapY) shifted by kFormWrapShift. The form must agree with the
// planes: a_node exactly in the weighted form, beta exactly in the
// adaptive one.
inline int launch_half(int half, float* u, float* v, float* s11, float* s22, float* s12,
                       float* c_w, float* inv_drag, float* beta, const void* const* consts,
                       int nx, int ny, int form, const float* scalars, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  MevpState p = {u, v, s11, s22, s12, c_w, inv_drag, beta};
  MevpConsts k;
  MevpScalars s;
  std::memcpy(&k, consts, sizeof(k));
  std::memcpy(&s, scalars, sizeof(s));
  const int wrap = form >> kFormWrapShift;
  form &= kForms - 1;
  const HalfKernel kernel = wrap ? half_kernel<true>(half, k.inv_dx != nullptr, form)
                                 : half_kernel<false>(half, k.inv_dx != nullptr, form);
  if (kernel == nullptr || wrap > (kWrapX | kWrapY) ||
      ((form & kFormWeighted) != 0) != (k.a_node != nullptr) ||
      ((form & kFormAdaptive) != 0) != (beta != nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  kernel<<<plane_grid(nx, ny), plane_block(), 0, static_cast<cudaStream_t>(stream)>>>(p, k, nx, ny,
                                                                                   s, wrap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace nst

extern "C" {

int nst_mevp_n_scalars() { return sizeof(nst::MevpScalars) / sizeof(float); }

// Each entry point launches one kernel on `stream` (the caller's PyTorch
// stream) and returns cudaGetLastError(); it does not synchronise. consts
// points to the 13 const-plane pointers in the order of MevpConsts, the
// five metric ones null on a uniform mesh and a_node null outside the
// weighted form; form: the momentum form's bits (kFormWeighted,
// kFormAdaptive), and the periodic axes' (kWrapX, kWrapY) shifted left by
// kFormWrapShift; beta: the adaptive form's node plane, null in the others.
int nst_mevp_stress(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                    float* inv_drag, float* beta, const void* const* consts, int nx, int ny,
                    int form, const float* scalars, int device, void* stream) {
  return nst::launch_half(0, u, v, s11, s22, s12, c_w, inv_drag, beta, consts, nx, ny, form,
                          scalars, device, stream);
}

// c_w, inv_drag and beta are read here (written by nst_mevp_stress).
int nst_mevp_velocity(float* u, float* v, float* s11, float* s22, float* s12, float* c_w,
                      float* inv_drag, float* beta, const void* const* consts, int nx, int ny,
                      int form, const float* scalars, int device, void* stream) {
  return nst::launch_half(1, u, v, s11, s22, s12, c_w, inv_drag, beta, consts, nx, ny, form,
                          scalars, device, stream);
}

const char* nst_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
