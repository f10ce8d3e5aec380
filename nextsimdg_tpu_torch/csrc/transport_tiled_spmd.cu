// The rank grid's TVB form of transport_tiled (transport_tiled.cuh): dG1 and
// dG2 on a uniform mesh, on a rank block widened by H ghost cells whose
// global walls sit H rows (columns) inside it, at the indices the host
// passes. Replaces, with transport_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled
// as transport_substeps_tiled_spmd runs it with TVB: there 4 wall-delta
// mask planes ride the kernel's consts, each 1 on one row or column and 0
// elsewhere; here the four indices are the same function, with no plane in
// the window. Compiled beside transport_tiled.cu, which dispatches to them.
#include "transport_tiled.cuh"

namespace nst {

template <int kDeg>
TransportKernel<kDeg> transport_tiled_walls_of(bool vec) {
  if constexpr (kDeg == 0) {
    return nullptr;
  } else {
    return vec ? transport_tiled_kernel<kDeg, false, false, 4, true, false, true>
               : transport_tiled_kernel<kDeg, false, false, 1, true, false, true>;
  }
}

template TransportKernel<0> transport_tiled_walls_of<0>(bool);
template TransportKernel<1> transport_tiled_walls_of<1>(bool);
template TransportKernel<2> transport_tiled_walls_of<2>(bool);

}  // namespace nst
