"""Device profiling helpers.

The port's counterpart of ``nextsimdg_tpu.utils.profiling``, on
``torch.profiler``. The hierarchical host Timer (``utils.timer``) covers
phase boundaries; for the device's detail, ``device_trace`` writes a Chrome
trace (viewable in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """Record a trace of the enclosed block into ``log_dir``: CPU activity,
    plus CUDA activity when ``device`` is a CUDA device (or, with no device
    given, when there is a card). Yields the profiler; the trace file,
    ``trace_<pid>_<ns>.json``, is written when the block ends, also when it
    raises.

    Example::

        with device_trace("nextsim-trace", device="cuda"):
            with annotate("step"):
                state = model.step(state, phys, dyn, dt)
            torch.cuda.synchronize()
    """
    cuda = torch.cuda.is_available() if device is None else torch.device(device).type == "cuda"
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize(device)
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named trace annotation for a region (shows up in the trace viewer)."""
    return torch.profiler.record_function(name)
