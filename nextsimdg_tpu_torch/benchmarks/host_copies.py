"""The coupled CLI's host copies on the card, each against its pageable form.

``python -m nextsimdg_tpu_torch.benchmarks.host_copies [n ...]`` (default
4096 and 256): for a CG1 coupled state of n x n elements (18 float32
planes) the checkpoint fetch, ``io.coupled_restart.fetch_coupled_state``
(one flattened buffer copied into pinned host memory), against one
flattened copy into fresh pageable memory; and for the cyclone's four
float64 planes the forcing copy, ``runtime.coupled_main.cyclone_forcing``
(rounded into a pinned buffer, copied asynchronously), against the same
rounding into pageable memory and a synchronous copy. Each is timed on the
host clock to a synchronize, three times keeping every result (fresh host
memory each time, as a caller that holds its checkpoints) and three times
releasing it (as the CLI, whose writer releases each checkpoint before the
next fetch); the forcing copies also behind ~170 ms of queued device work
(the host's time in the call: a pageable copy waits for the card). One
line per measurement, with the card's name and power limit. Exits
non-zero without a CUDA card.
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from ..coupled import CoupledModel
from ..dynamics import RectMesh
from ..io.coupled_restart import fetch_coupled_state
from ..io.forcing_pipeline import CYCLONE_FIELDS
from ..runtime.coupled_main import cyclone_forcing
from ..state import tree_leaves, tree_map


def _ms(fn, reps: int, keep: bool) -> list:
    kept, out = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t0) * 1e3)
        if keep:
            kept.append(result)
    return out


def _fmt(ms: list) -> str:
    return ", ".join(f"{m:.1f}" for m in ms)


def measure(n: int, device, card: str) -> None:
    model = CoupledModel(RectMesh(n, n, 2e3, 2e3))
    state = model.initial_state(hice0=1.0, cice0=0.9, hsnow0=0.05, device=device, dtype=torch.float32)
    state = tree_map(lambda t: torch.rand_like(t), state)
    n_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))

    def pageable_fetch():
        return torch.cat([t.reshape(-1) for t in tree_leaves(state)]).cpu()

    for name, fn in (("pageable", pageable_fetch), ("pinned (fetch_coupled_state)", lambda: fetch_coupled_state(state))):
        print(
            f"[host_copies] fetch {n}^2 ({n_bytes / 1e9:.3f} GB) {name}: kept {_fmt(_ms(fn, 3, True))} ms; "
            f"released {_fmt(_ms(fn, 3, False))} ms; {card}", flush=True,
        )
    rng = np.random.default_rng(0)
    fields = {name: rng.standard_normal((n, n)) for name in CYCLONE_FIELDS}

    def pageable_forcing():
        host = np.stack([fields[name] for name in CYCLONE_FIELDS]).astype(np.float32)
        return torch.from_numpy(host).to(device)

    a = torch.rand((8192, 8192), device=device)
    for name, fn in (("pageable", pageable_forcing),
                     ("pinned (cyclone_forcing)", lambda: cyclone_forcing(fields, device=device, dtype=torch.float32))):
        behind = []
        for _ in range(3):
            torch.cuda.synchronize()
            for _ in range(8):
                a @ a
            t0 = time.perf_counter()
            fn()
            behind.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        print(
            f"[host_copies] forcing copy {n}^2 x{len(CYCLONE_FIELDS)} {name}: alone {_fmt(_ms(fn, 5, False))} ms; "
            f"host time in the call behind queued device work {_fmt(behind)} ms; {card}", flush=True,
        )


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("host_copies: no CUDA device; this measurement runs only on a GPU", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    for n in [int(a) for a in argv] or [4096, 256]:
        measure(n, device, card)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
