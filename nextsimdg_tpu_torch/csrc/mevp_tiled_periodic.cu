// The periodic instances of mevp_tiled (mevp_tiled.cuh): the ghost-zone
// windows wrap on the launch's periodic axes. Replaces, with mevp_tiled.cu,
// the TPU kernel
// nextsimdg_tpu/dynamics/kernels/mevp_tiled.py::mevp_subcycles_tiled in its
// periodic form; compiled beside mevp_tiled.cu, which dispatches to them.
#include "mevp_tiled.cuh"

namespace nst {

TiledKernel tiled_kernel_periodic(bool metric, int form, int w) {
  return tiled_kernel_of_form<true>(metric, form, w);
}

}  // namespace nst
