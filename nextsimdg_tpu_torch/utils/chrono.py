"""A single stopwatch.

The port's copy of ``nextsimdg_tpu.utils.chrono`` (``Chrono``,
``core/src/include/Chrono.hpp:21-139``): paired wall and CPU clocks plus an
activation count, with live reads while running and external increments.
Both clocks are the host's.
"""

from __future__ import annotations

import time


class Chrono:
    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self._wall_time = 0.0
        self._cpu_time = 0.0
        self._ticks = 0
        self._running = False
        self._wall_start = 0.0
        self._cpu_start = 0.0

    def start(self) -> None:
        self._wall_start = time.perf_counter()
        self._cpu_start = time.process_time()
        self._ticks += 1
        self._running = True

    def stop(self) -> None:
        if self._running:
            self._wall_time += time.perf_counter() - self._wall_start
            self._cpu_time += time.process_time() - self._cpu_start
            self._running = False

    @property
    def running(self) -> bool:
        return self._running

    @property
    def ticks(self) -> int:
        return self._ticks

    def wall_time(self) -> float:
        """Accumulated wall time [s], including the live interval if running."""
        live = time.perf_counter() - self._wall_start if self._running else 0.0
        return self._wall_time + live

    def cpu_time(self) -> float:
        """Accumulated CPU time [s], including the live interval if running."""
        live = time.process_time() - self._cpu_start if self._running else 0.0
        return self._cpu_time + live

    # External increments (Chrono.hpp:116-138).
    def extra_wall_time(self, dt: float) -> None:
        self._wall_time += dt

    def extra_cpu_time(self, dt: float) -> None:
        self._cpu_time += dt

    def extra_ticks(self, n: int) -> None:
        self._ticks += n
