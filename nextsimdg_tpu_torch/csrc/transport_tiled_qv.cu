// The periodic instances of transport_tiled (transport_tiled.cuh) in the HO
// path's qv form, which replace, with transport_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled
// for the higher-order solver on a periodic mesh: the velocity from the CG2
// quadrature samples, read at the wrapped indices of a window beyond the
// domain, no face a wall; untouched, or with the TVB limiter where the JAX
// gate (transport_tiled_config) takes it, on a uniform mesh (those of a
// graded or spherical mesh are in transport_tiled_qv_metric.cu). Compiled
// beside transport_tiled_forms.cu, which dispatches to them.
#include "transport_tiled.cuh"

namespace nst {

template <int kDeg>
TransportKernel<kDeg> transport_tiled_qv_of(bool metric, bool vec, bool tvb) {
  return tvb ? transport_tiled_select_qv<kDeg, true>(metric, vec)
             : transport_tiled_select_qv<kDeg, false>(metric, vec);
}

template TransportKernel<0> transport_tiled_qv_of<0>(bool, bool, bool);
template TransportKernel<1> transport_tiled_qv_of<1>(bool, bool, bool);
template TransportKernel<2> transport_tiled_qv_of<2>(bool, bool, bool);

}  // namespace nst
