// The periodic metric instances of transport_tiled (transport_tiled.cuh) in
// the HO path's qv form, which replace, with transport_tiled.cu, the TPU
// kernel nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled
// for the higher-order solver on a periodic graded or spherical mesh (the
// 360 degree lon-lat ring): the velocity from the CG2 quadrature samples and
// the transport's 5 metric planes, read at the wrapped indices of a window
// beyond the domain, no face a wall; untouched (TVB on such a mesh runs the
// staged transport). In a source of their own so that the build's sources
// take similar times; transport_tiled_qv.cu dispatches to them.
#include "transport_tiled.cuh"

namespace nst {

template <int kDeg>
TransportKernel<kDeg> transport_tiled_qv_metric_of(bool vec) {
  return vec ? transport_tiled_kernel<kDeg, true, true, 4, false, true>
             : transport_tiled_kernel<kDeg, true, true, 1, false, true>;
}

template TransportKernel<0> transport_tiled_qv_metric_of<0>(bool);
template TransportKernel<1> transport_tiled_qv_metric_of<1>(bool);
template TransportKernel<2> transport_tiled_qv_metric_of<2>(bool);

}  // namespace nst
