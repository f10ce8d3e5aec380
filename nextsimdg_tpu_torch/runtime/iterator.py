"""The time-stepping engine.

The port's copy of ``nextsimdg_tpu.runtime.iterator``. Mirrors ``Iterator``
(``core/src/Iterator.cpp:35-62``, ``include/Iterator.hpp:78-121``): an
``Iterant`` with ``init/start/iterate/stop`` hooks driven over ``[t0, t1)``
in steps of ``dt``.
Time points and durations are numbers (the reference uses placeholder
``int``s); ``parse_and_set`` accepts start/stop/duration/step with duration
taking precedence over stop (``Iterator.cpp:35-51``).
"""

from __future__ import annotations

from ..utils.logged import Logged
from ..utils.timer import main_timer


class Iterant:
    """Callback interface for one model component driven by the Iterator."""

    def init(self) -> None:  # noqa: B027
        pass

    def start(self, start_time) -> None:  # noqa: B027
        pass

    def iterate(self, dt) -> None:
        raise NotImplementedError

    def stop(self, stop_time) -> None:  # noqa: B027
        pass


class NullIterant(Iterant):
    """A no-op Iterant (Iterator.hpp:113-121)."""

    def iterate(self, dt) -> None:
        pass


class Iterator:
    def __init__(self, iterant: Iterant = None) -> None:
        self.iterant: Iterant = iterant if iterant is not None else NullIterant()
        self.start_time = 0
        self.stop_time = 0
        self.time_step = 1

    def set_iterant(self, iterant: Iterant) -> None:
        self.iterant = iterant

    def set_start_stop_step(self, start, stop, step) -> None:
        self.start_time = start
        self.stop_time = stop
        self.time_step = step

    def set_start_duration_step(self, start, duration, step) -> None:
        self.start_time = start
        self.stop_time = start + duration
        self.time_step = step

    def parse_and_set(self, start: str, stop: str, duration: str, step: str) -> None:
        """Parse time strings; a set duration overrides the stop time."""
        self.start_time = _parse_time(start)
        self.time_step = _parse_time(step)
        parsed_duration = _parse_time(duration) if duration not in (None, "") else None
        if parsed_duration is not None and parsed_duration >= 0:
            self.stop_time = self.start_time + parsed_duration
        else:
            self.stop_time = _parse_time(stop)

    def run(self) -> None:
        """start -> iterate over [t0, t1) -> stop (Iterator.cpp:53-62)."""
        with main_timer.scope("time-loop"):
            self.iterant.start(self.start_time)
            time = self.start_time
            while time < self.stop_time:
                with main_timer.scope("step"):
                    self.iterant.iterate(self.time_step)
                time += self.time_step
            self.iterant.stop(self.stop_time)
        Logged.info(f"Iterator: ran from {self.start_time} to {self.stop_time}")


def _parse_time(text):
    """Parse a time value: int seconds for now (reference uses ints too)."""
    if isinstance(text, (int, float)):
        return text
    value = float(text)
    return int(value) if value == int(value) else value
