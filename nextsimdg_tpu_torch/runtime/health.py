"""Failure detection and the dt/2 replay for long production runs.

The port's copy of ``nextsimdg_tpu.runtime.health`` (the reference has no
failure detection; its only resilience is the Model destructor's
best-effort restart write, ``core/src/Model.cpp:40-53``):

* ``finite_probe(state)``: whether every floating leaf of a state, or of a
  list of rank-block states, is finite everywhere: one ``isfinite().all()``
  a leaf on its device, the flags stacked, one host sync for the answer.
* ``HealthMonitor``: the run loop's bookkeeping, line for line the JAX
  package's. It keeps the newest state that probed healthy, raises
  :class:`NonFiniteStateError` carrying it when a probe fails and, in
  ``retry-halved`` mode, schedules one replay of the failed segment at
  half the time step before giving up.

The JAX package keeps the healthy state by reference, which is sound there
because its arrays are immutable. A PyTorch schedule may write into its
input's tensors (the rank grid's halo halves update their carries in
place), so the monitor keeps a clone of every leaf on its device, and
hands the run loop a clone of that when it rolls back: a replay cannot reach
the snapshot. That is one more copy of the state in device memory and one
device copy of the state per healthy probe (about 0.7 ms of HBM time for a
1.1 GB HO state at 16M elements on an H100).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from ..state import tree_leaves, tree_map
from ..utils.logged import Logged

#: What a failed probe does: stop, or replay the failed segment at dt/2 once.
ON_NONFINITE = ("abort", "retry-halved")


class NonFiniteStateError(RuntimeError):
    """A health probe found NaN/Inf in the model state.

    Carries the failing step and the last snapshot that probed healthy,
    so the run loop can checkpoint both sides of the failure.
    """

    def __init__(self, step: int, t: float, last_good: Optional[Tuple]):
        msg = f"non-finite model state detected at step {step} (t={t})"
        if last_good is not None:
            msg += f"; last healthy state was step {last_good[0]} (t={last_good[1]})"
        super().__init__(msg)
        self.step = step
        self.t = t
        #: (step, t, state) of the newest probe that passed, or None.
        self.last_good = last_good


def finite_probe(state: Any) -> bool:
    """True iff every floating tensor of ``state`` (a state tree, or a list
    of rank blocks) is finite everywhere. One reduction a leaf on its own
    device, the flags gathered on the first leaf's device, one sync."""
    leaves = [x for x in tree_leaves(state) if x.is_floating_point()]
    if not leaves:
        return True
    device = leaves[0].device
    flags = torch.stack([torch.isfinite(leaf).all().to(device) for leaf in leaves])
    return bool(flags.all().item())


def clone_state(state: Any) -> Any:
    """The same tree with every tensor cloned on its device."""
    return tree_map(torch.clone, state)


class HealthMonitor:
    """Periodic finite-state probing with an optional halved-dt replay.

    Run-loop contract (``runtime/coupled_main.py``)::

        mon = HealthMonitor(period, mode)
        mon.record_good(0, t0, state)           # the initial state
        while stepping:
            dt_cur = dt / 2 if mon.recovering else dt
            state = step(state, ..., dt_cur)
            ...
            action = mon.after_step(step, t, state)
            if action == "rollback":
                step, t, state = mon.rollback_target()

    ``after_step`` returns ``"ok"`` (keep going), ``"rollback"`` (restore
    the last-good snapshot and replay at dt/2) or raises
    :class:`NonFiniteStateError`. Probes run every ``period`` completed
    full steps, at the end of a recovery segment, and wherever the run loop
    asks for one with ``probe_now`` (before a cadence write that the
    period does not cover). ``last_probe`` is the step of the newest probe.
    """

    def __init__(self, period: int, mode: str = "abort", probe=finite_probe):
        if mode not in ON_NONFINITE:
            raise ValueError(f"unknown on_nonfinite mode '{mode}'")
        self.period = int(period)
        self.mode = mode
        self.probe = probe
        self._last_good: Optional[Tuple[int, float, Any]] = None
        #: >0 while replaying a failed segment at dt/2 (the half-steps
        #: left); the run loop reads ``recovering``.
        self._recovery_left = 0
        #: set when the active recovery segment already used its retry; a
        #: second failure of the same segment aborts.
        self._retry_spent = False
        self.last_probe: Optional[int] = None

    # -- run-loop-facing state ----------------------------------------------
    @property
    def recovering(self) -> bool:
        return self._recovery_left > 0

    @property
    def last_good(self) -> Optional[Tuple[int, float, Any]]:
        return self._last_good

    def record_good(self, step: int, t: float, state: Any) -> None:
        """Keep a clone of ``state`` as the newest known-healthy snapshot."""
        self._last_good = (step, t, clone_state(state))

    # -- probing ------------------------------------------------------------
    def due(self, step: int) -> bool:
        """Is a probe due after completed full step ``step``?"""
        if self.period <= 0:
            return False
        if self.recovering:
            return False  # probed at segment end via after_step
        return step % self.period == 0

    def after_step(self, step: int, t: float, state: Any) -> str:
        """Advance the monitor after one completed step (full or half).

        Returns "ok" or "rollback"; raises NonFiniteStateError when the
        failure is terminal (abort mode, or a spent retry).
        """
        if self.period <= 0:
            return "ok"
        if self._recovery_left > 0:
            self._recovery_left -= 1
            if self._recovery_left > 0:
                return "ok"  # mid-segment: keep replaying
            # Segment replayed: probe it.
            self.last_probe = step
            if self.probe(state):
                Logged.warning(
                    f"health: halved-dt replay healthy again at step {step}; "
                    "resuming the configured time step"
                )
                self._retry_spent = False
                self.record_good(step, t, state)
                return "ok"
            raise NonFiniteStateError(step, t, self._last_good)
        if not self.due(step):
            return "ok"
        return self.probe_now(step, t, state)

    def probe_now(self, step: int, t: float, state: Any) -> str:
        """Probe after completed full step ``step``, whether or not the
        period calls for it: "ok" (the state is the new snapshot),
        "rollback" (retry-halved with the retry unspent), or raises."""
        self.last_probe = step
        if self.probe(state):
            self.record_good(step, t, state)
            return "ok"
        if self.mode == "abort" or self._retry_spent or self._last_good is None:
            raise NonFiniteStateError(step, t, self._last_good)
        good_step = self._last_good[0]
        segment = step - good_step
        self._recovery_left = 2 * segment
        self._retry_spent = True
        Logged.error(
            f"health: non-finite state at step {step}; rolling back to "
            f"step {good_step} and replaying {segment} step(s) at dt/2"
        )
        return "rollback"

    def rollback_target(self) -> Tuple[int, float, Any]:
        """The (step, t, state) snapshot the run loop restores: a clone, so
        the replay does not reach the monitor's own copy."""
        if self._last_good is None:
            raise RuntimeError("no healthy snapshot to roll back to")
        step, t, state = self._last_good
        return step, t, clone_state(state)
