// The closed TVB instances of transport_tiled (transport_tiled.cuh), which
// replace, with transport_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled
// in its TVB form: dG1 and dG2 on a uniform mesh, each stage unlimited, then
// the TVB and positivity limiter on the window one ring further in (two
// window rings a stage), on the CG1 velocity or the HO path's qv samples. In
// a source of their own so that the build's sources take similar times;
// transport_tiled_forms.cu dispatches to them.
#include "transport_tiled.cuh"

namespace nst {

template <int kDeg>
TransportKernel<kDeg> transport_tiled_tvb_of(bool metric, bool qv, bool vec) {
  return transport_tiled_select<kDeg, true, false>(metric, qv, vec);
}

template TransportKernel<0> transport_tiled_tvb_of<0>(bool, bool, bool);
template TransportKernel<1> transport_tiled_tvb_of<1>(bool, bool, bool);
template TransportKernel<2> transport_tiled_tvb_of<2>(bool, bool, bool);

}  // namespace nst
