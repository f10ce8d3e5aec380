"""nextsimdg_tpu_torch: the sea-ice model on PyTorch and CUDA.

A port of ``nextsimdg_tpu`` (JAX) for NVIDIA Hopper cards, which stays in
the repository as the reference. It imports torch and numpy, never jax.
The main path so far is the coupled thermo+dynamics step
(``coupled.CoupledModel``) on uniform, graded and spherical meshes with
optional coastlines, with the CG1 mEVP solver or, selected through the
module registry (``modules``), the CG2/dG1 one on uniform meshes: its
dynamics phase runs hand-written CUDA kernels on a GPU
(``dynamics.kernels``: K1's schedule in ``coupled_cuda``, the ghost-zone
tiled one in ``mevp_tiled_cuda`` and ``transport_tiled_cuda``, the
single-launch mEVP in ``mevp_single_cuda``, the HO mEVP in
``ho_single_cuda`` and ``ho_tiled_cuda``) and their plain PyTorch versions
on the CPU; the column physics (``physics``) is plain PyTorch.
"""
