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


def profiled_ms(fn, kernel: str, n: int = 20) -> float | None:
    """Mean device duration (ms) of the CUDA kernels whose name holds
    ``kernel`` over n calls of fn, from torch.profiler: the kernel's own
    time, whatever the host takes to issue it. A session that records no
    event at all (seen on the H100 machines now and then, sometimes for the
    rest of the process) is taken again, up to three; None where no session
    sees the kernel. A profiler session slows the host's later launches, so
    time host-bound work before it."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no events at all: take another
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [
            e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and kernel in e.key
        ]
        count = sum(e.count for e in events)
        if count:
            return sum(e.self_device_time_total for e in events) / count / 1e3
    return None


def profiled_ms_many(probes: dict, n: int = 10, device: bool = True) -> dict:
    """``profiled_ms`` of many probes in one profiler session: label ->
    (fn, kernel) in, label -> mean ms or None out. Each probe's n calls run
    inside a ``record_function`` range of its own, which ends after a
    synchronize, so its kernels start inside the range's window; the events
    whose names hold its kernel and start there are its. One session for
    all: a session's start and stop cost the host more than most probes'
    calls. A session that records no device event is taken again, up to
    three. ``device=False`` attributes host events instead (the tests)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sync = torch.cuda.synchronize if device else (lambda: None)
    kind = torch.autograd.DeviceType.CUDA if device else torch.autograd.DeviceType.CPU
    for fn, _ in probes.values():
        fn()
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device else [])
    first = next(iter(probes.values()))[0]
    for _ in range(3):
        with profile(activities=activities) as prof:
            # The session's first kernels can go unrecorded (seen on the H100:
            # all 10 of the first probe's): calls outside every probe's range
            # take their place.
            for _ in range(n):
                first()
            sync()
            for label, (fn, _) in probes.items():
                with record_function(f"probe {label}"):
                    for _ in range(n):
                        fn()
                    sync()
        events = prof.events()
        windows = {e.name[len("probe "):]: e.time_range for e in events if e.name.startswith("probe ")}
        timed = [e for e in events if e.device_type == kind and not e.name.startswith("probe ")]
        if not timed:
            continue
        out = {}
        for label, (_, kernel) in probes.items():
            window = windows.get(label)
            hits = [e.time_range.elapsed_us() for e in timed
                    if window and kernel in e.name and window.start <= e.time_range.start <= window.end]
            out[label] = sum(hits) / len(hits) / 1e3 if hits else None
        return out
    return dict.fromkeys(probes)


def device_ms(fn, kernel: str, n: int = 20) -> float:
    """``profiled_ms``, raising where no session sees the kernel."""
    ms = profiled_ms(fn, kernel, n)
    if ms is None:
        raise AssertionError(f"the profiler saw no {kernel} kernel in 3 sessions")
    return ms
