// The TVB and periodic forms of transport_tiled (transport_tiled.cuh), which
// replaces, with transport_tiled.cu, the TPU kernel
// nextsimdg_tpu/dynamics/kernels/transport_tiled.py::transport_substeps_tiled
// in those forms: every periodic instance (a window beyond the domain copied
// from the opposite side, no face a wall; the HO path's qv form in
// transport_tiled_qv.cu), and the dispatch to the closed TVB instances
// (transport_tiled_tvb.cu). Compiled beside transport_tiled.cu, which
// dispatches to them.
#include "transport_tiled.cuh"

namespace nst {

template <int kDeg>
TransportKernel<kDeg> transport_tiled_forms_of(bool metric, bool qv, bool vec, bool tvb, int wrap) {
  if (wrap && qv) return transport_tiled_qv_of<kDeg>(metric, vec, tvb);
  if (wrap) {
    return tvb ? transport_tiled_select<kDeg, true, true>(metric, qv, vec)
               : transport_tiled_select<kDeg, false, true>(metric, qv, vec);
  }
  return tvb ? transport_tiled_tvb_of<kDeg>(metric, qv, vec) : nullptr;
}

template TransportKernel<0> transport_tiled_forms_of<0>(bool, bool, bool, bool, int);
template TransportKernel<1> transport_tiled_forms_of<1>(bool, bool, bool, bool, int);
template TransportKernel<2> transport_tiled_forms_of<2>(bool, bool, bool, bool, int);

}  // namespace nst
