"""The per-timestep model update.

Counterpart of ``nextsimdg_tpu.runtime.model_step`` (``DevStep``,
``core/src/DevStep.cpp:14-23``): one whole-grid column-physics step on the
structure's tensors, driven by the host time loop. Where the JAX step is a
jitted program and its multi-step form a ``lax.scan``, here the step is a
plain function on tensors and ``run_steps_scanned`` a loop that issues the
steps back to back with no host sync.

Cross-step physics memory (``new_ice``; see ``NextsimPhysics``) is carried
here alongside the prognostic state.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import try_configure
from ..grid.structure import IStructure
from ..modules import ModuleRegistry
from ..utils.timer import main_timer
from .iterator import Iterant


class ModelStep(Iterant):
    def __init__(self) -> None:
        self.structure: Optional[IStructure] = None
        self.physics = None
        self.new_ice = None
        #: Periodic checkpointing during long runs (0 = final restart only,
        #: which is all the reference does); see ``Model`` config
        #: ``model.checkpoint_period`` / ``model.checkpoint_pattern``.
        self.checkpoint_period = 0
        self.checkpoint_pattern = "checkpoint.{step}.nc"
        self.step_count = 0
        #: Time-dependent forcing (``model.forcing_file``): a
        #: ``ForcingProvider`` that sets the structure's forcing at the start
        #: of every step; None keeps the structure's forcing.
        self.forcing_provider = None
        self.start_time = 0.0

    # -- IModelStep (IModelStep.hpp:16-34) -----------------------------------
    def set_initial_data(self, structure: IStructure) -> None:
        self.structure = structure
        self.new_ice = torch.zeros_like(structure.prognostic.hice)

    def init(self) -> None:
        """The registry's ``Nextsim::IPhysics1d``, configured."""
        from .. import physics  # noqa: F401 - registers the physics modules

        self.physics = ModuleRegistry.get_loader().get_implementation("Nextsim::IPhysics1d")
        try_configure(self.physics)

    def step_fn(self):
        """The single-step function ``(prog, forcing, new_ice, dt) ->
        (prog, new_ice)`` of the configured physics."""
        if self.physics is None:
            self.init()
        physics = self.physics

        def step(prog, forcing, new_ice, dt: float):
            updated, diags = physics.step(prog, forcing, new_ice, dt)
            return updated, diags.new_ice

        return step

    # -- Iterant -------------------------------------------------------------
    def iterate(self, dt) -> None:
        if self.forcing_provider is not None:
            t_now = self.start_time + self.step_count * float(dt)
            self.structure.forcing = self.forcing_provider.thermo_forcing(
                t_now, self.structure.nx, self.structure.ny
            )
        step = self.step_fn()
        self.structure.prognostic, self.new_ice = step(
            self.structure.prognostic, self.structure.forcing, self.new_ice, float(dt)
        )
        self.step_count += 1
        if self.checkpoint_period and self.step_count % self.checkpoint_period == 0:
            with main_timer.scope("checkpoint-write"):
                self.structure.dump(self.checkpoint_pattern.format(step=self.step_count))

    # -- many steps without the host -----------------------------------------
    def run_steps_scanned(self, n_steps: int, dt: float) -> None:
        """Issue n_steps back to back on the structure's device: no host
        sync, no checkpoint, no step count (the JAX function's ``lax.scan``)."""
        step = self.step_fn()
        prog, new_ice, forcing = self.structure.prognostic, self.new_ice, self.structure.forcing
        for _ in range(int(n_steps)):
            prog, new_ice = step(prog, forcing, new_ice, float(dt))
        self.structure.prognostic, self.new_ice = prog, new_ice
