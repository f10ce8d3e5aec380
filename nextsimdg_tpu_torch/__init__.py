"""nextsimdg_tpu_torch: the sea-ice model on PyTorch and CUDA.

A port of ``nextsimdg_tpu`` (JAX) for NVIDIA Hopper cards, which stays in
the repository as the reference. It imports torch and numpy, never jax.
The main path so far is the dynamics-only coupled step
(``coupled.CoupledModel``), whose dynamics phase runs hand-written CUDA
kernels (``dynamics.kernels.coupled_cuda``) on a GPU and their plain
PyTorch versions on the CPU.
"""
