// The rank grid's TVB form of transport_tiled (transport_tiled.cuh) in the HO
// path's qv form: dG1 and dG2 on a uniform mesh, the velocity from the CG2
// quadrature samples widened by H with the block, and the global walls H
// rows (columns) inside the widened block, at the indices the host passes.
// Replaces, with transport_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled_spmd
// as it runs the higher-order solver's transport with TVB: there the
// samples and the 4 wall-delta mask planes ride the kernel's consts; here the
// samples are read from global memory as in every qv instance, and the four
// indices are the masks' function, with no plane in the window. In a source
// of its own, so that the instances of transport_tiled_spmd.cu keep their
// code; transport_tiled.cuh's transport_tiled_of dispatches to it.
#include "transport_tiled.cuh"

namespace nst {

template <int kDeg>
TransportKernel<kDeg> transport_tiled_walls_qv_of(bool vec) {
  if constexpr (kDeg == 0) {
    return nullptr;
  } else {
    return vec ? transport_tiled_kernel<kDeg, false, true, 4, true, false, true>
               : transport_tiled_kernel<kDeg, false, true, 1, true, false, true>;
  }
}

template TransportKernel<0> transport_tiled_walls_qv_of<0>(bool);
template TransportKernel<1> transport_tiled_walls_qv_of<1>(bool);
template TransportKernel<2> transport_tiled_walls_qv_of<2>(bool);

}  // namespace nst
