"""A demonstration Iterant that logs its lifecycle.

The port's copy of ``nextsimdg_tpu.runtime.simple_iterant``. Mirrors
``SimpleIterant`` (``core/src/SimpleIterant.cpp:16-59``): prints
start/iterate/stop messages; used in examples and tests.
"""

from __future__ import annotations

from .iterator import Iterant


class SimpleIterant(Iterant):
    def init(self) -> None:
        print("SimpleIterant::init")

    def start(self, start_time) -> None:
        print(f"SimpleIterant::start at {start_time}")

    def iterate(self, dt) -> None:
        print(f"SimpleIterant::iterate for {dt}")

    def stop(self, stop_time) -> None:
        print(f"SimpleIterant::stop at {stop_time}")
