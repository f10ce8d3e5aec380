"""What the battery's measurements share: the card they need, its name and
power limit, CUDA-event timing, a kernel's device time from the profiler,
and models built with the HO solver."""

from __future__ import annotations

import subprocess

import torch

from .. import modules


def with_high_order(build):
    """``build()`` with ``Nextsim::MEVPHighOrder`` selected in the port's
    registry, reset after (the selection spans the process)."""
    loader = modules.get_loader()
    loader.set_implementation("Nextsim::IDynamics", "Nextsim::MEVPHighOrder")
    try:
        return build()
    finally:
        loader.reset()


def require_cuda(device="cuda") -> torch.device:
    """``device`` as a CUDA device; raises for any other (a measurement of
    the card never falls back to the CPU) and when no card is present."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"this measures a CUDA card, not {device}: there is no CPU form")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this measurement runs only on a GPU")
    return torch.device("cuda", torch.cuda.current_device() if device.index is None else device.index)


def card(device) -> dict:
    """The card's name and ``nvidia-smi``'s name and power limit."""
    device = torch.device(device)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return {
        "name": torch.cuda.get_device_name(device),
        "nvidia_smi": smi[device.index or 0],
        "count": torch.cuda.device_count(),
    }


def best_ms(fn, reps: int = 5) -> float:
    """The least ms of one ``fn()`` over ``reps`` timed calls after a
    warm-up, on the device timeline (CUDA events on the current stream)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(reps):
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def device_ms(fn, kernel: str, n: int = 20) -> float:
    """Mean device duration (ms) of the CUDA kernels whose name holds
    ``kernel`` over n calls of fn, from torch.profiler: the kernel's own
    time, whatever the host takes to issue it. A profiler session slows the
    host's later launches, so time host-bound work before it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    events = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key
    ]
    count = sum(e.count for e in events)
    if count == 0:
        raise AssertionError(f"the profiler saw no {kernel} kernel")
    return sum(e.self_device_time_total for e in events) / count / 1e3
