"""Diagnostics utilities: hierarchical host timers and logging."""

from .chrono import Chrono
from .logged import Logged
from .timer import ScopedTimer, Timer, main_timer

__all__ = ["Chrono", "Timer", "ScopedTimer", "main_timer", "Logged"]
