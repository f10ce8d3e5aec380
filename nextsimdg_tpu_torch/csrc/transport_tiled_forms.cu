// The TVB and periodic forms of transport_tiled (transport_tiled.cuh), which
// replaces, with transport_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled
// in those forms: the closed TVB instances (dG1, dG2 on a uniform mesh, two
// window rings a stage) and every periodic instance (a window beyond the
// domain copied from the opposite side, no face a wall; no qv form: the HO
// solver on a periodic mesh is not ported). Compiled beside
// transport_tiled.cu, which dispatches to them.
#include "transport_tiled.cuh"

namespace nst {

template <int kDeg>
TransportKernel<kDeg> transport_tiled_forms_of(bool metric, bool qv, bool vec, bool tvb, int wrap) {
  if (wrap) {
    return tvb ? transport_tiled_select<kDeg, true, true>(metric, qv, vec)
               : transport_tiled_select<kDeg, false, true>(metric, qv, vec);
  }
  return tvb ? transport_tiled_select<kDeg, true, false>(metric, qv, vec) : nullptr;
}

template TransportKernel<0> transport_tiled_forms_of<0>(bool, bool, bool, bool, int);
template TransportKernel<1> transport_tiled_forms_of<1>(bool, bool, bool, bool, int);
template TransportKernel<2> transport_tiled_forms_of<2>(bool, bool, bool, bool, int);

}  // namespace nst
