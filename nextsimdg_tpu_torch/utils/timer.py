"""Hierarchical profiling timer.

The port's copy of ``nextsimdg_tpu.utils.timer`` (``Timer``,
``core/src/Timer.cpp:35-198``): a tree of named nodes each holding a
:class:`Chrono`; ``tick(name)`` descends (creating the child if needed),
``tock()`` ascends; the report prints the tree with wall/CPU seconds,
percent-of-parent and ms-per-activation using box-drawing characters.
``main_timer`` is the static global (``Timer::main``); :class:`ScopedTimer`
is the RAII wrapper (``core/src/ScopedTimer.cpp:13-30``), also a context
manager.

The runtime wraps its phases (configure, time loop, step, restart I/O) in
timer scopes. Every clock is the host's: on a card a "step" scope measures
the time to issue the step's work, not the device's time to run it (the
launches return before the kernels end). Device times come from CUDA events
(``chip_smoke.py``, ``benchmarks``).
"""

from __future__ import annotations

import contextlib
import io
from typing import Dict, Optional

from .chrono import Chrono


class TimerNode:
    def __init__(self, name: str, parent: Optional["TimerNode"]) -> None:
        self.name = name
        self.parent = parent
        self.children: Dict[str, TimerNode] = {}
        self.chrono = Chrono()

    def child(self, name: str) -> "TimerNode":
        if name not in self.children:
            self.children[name] = TimerNode(name, self)
        return self.children[name]

    def report(self, out: io.TextIOBase, prefix: str = "", is_last: bool = True) -> None:
        wall = self.chrono.wall_time()
        cpu = self.chrono.cpu_time()
        ticks = self.chrono.ticks
        parent_wall = self.parent.chrono.wall_time() if self.parent else 0.0
        pct = f" {100.0 * wall / parent_wall:6.2f}% of parent" if parent_wall > 0 else ""
        per_activation = f" ({1000.0 * wall / ticks:.3f} ms per activation)" if ticks else ""
        connector = "" if self.parent is None else ("└─ " if is_last else "├─ ")
        out.write(
            f"{prefix}{connector}{self.name}: {wall:.6f} s wall, {cpu:.6f} s CPU,"
            f" {ticks} activations{pct}{per_activation}\n"
        )
        child_prefix = prefix if self.parent is None else prefix + ("   " if is_last else "│  ")
        kids = list(self.children.values())
        for i, kid in enumerate(kids):
            kid.report(out, child_prefix, i == len(kids) - 1)


class Timer:
    def __init__(self, root_name: str = "main") -> None:
        self.root = TimerNode(root_name, None)
        self.current = self.root
        self.root.chrono.start()

    def tick(self, name: str) -> None:
        """Descend into (or create) the named child and start its clock."""
        self.current = self.current.child(name)
        self.current.chrono.start()

    def tock(self, name: str = None) -> None:
        """Stop the current node's clock and ascend."""
        self.current.chrono.stop()
        if self.current.parent is not None:
            self.current = self.current.parent

    @contextlib.contextmanager
    def scope(self, name: str):
        """Context-manager form of tick/tock."""
        self.tick(name)
        try:
            yield self
        finally:
            self.tock(name)

    def reset(self) -> None:
        self.root = TimerNode(self.root.name, None)
        self.current = self.root
        self.root.chrono.start()

    def report(self) -> str:
        out = io.StringIO()
        self.root.report(out)
        return out.getvalue()

    def __str__(self) -> str:
        return self.report()


#: The static global timer (Timer::main).
main_timer = Timer("main")


class ScopedTimer:
    """RAII/context-manager timer bound to the global timer by default."""

    _timer: Timer = main_timer

    @classmethod
    def set_timer_address(cls, timer: Timer) -> None:
        cls._timer = timer

    def __init__(self, name: str) -> None:
        self._name = name
        type(self)._timer.tick(name)
        self._open = True

    def substitute(self, name: str) -> None:
        """Swap the timed section mid-scope (ScopedTimer.cpp:24-28)."""
        type(self)._timer.tock()
        type(self)._timer.tick(name)
        self._name = name

    def close(self) -> None:
        if self._open:
            type(self)._timer.tock()
            self._open = False

    def __enter__(self) -> "ScopedTimer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass
