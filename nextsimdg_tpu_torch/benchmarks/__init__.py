"""The port's benchmark battery, the twins of the JAX package's ``benchmarks/``.

* ``roofline``: the measured ceilings of the card (the ``chain`` kernel,
  K8's counterpart, and a streaming add), the op census of the mEVP
  subcycle bodies, bytes per element and subcycle of the port's kernels,
  and their achieved time per element and subcycle;
* ``run_benchmarks``: element updates/s of each battery config the port
  runs, one JSON line each;
* ``mevp_large``: the mEVP phase on each schedule at a size, the "auto"
  threshold sweeps, the tile sweeps and ``transport_tiled``'s and
  ``ho_single``'s times per call.

Each runs as ``python -m nextsimdg_tpu_torch.benchmarks.<name>`` on a
machine with a CUDA card; see each module's usage. None falls back to the
CPU: a measurement without a card exits non-zero.
"""
