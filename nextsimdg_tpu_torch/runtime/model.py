"""The top-level model object.

Counterpart of ``nextsimdg_tpu.runtime.model`` (``Model``,
``core/src/Model.cpp:22-88``): ``configure()`` reads
``model.{init_file,start,stop,run_length,time_step}`` and the checkpoint
cadence, builds the structure from the restart file on the model's device in
its dtype, seeds the dummy forcing there and wires the ModelStep into the
Iterator; ``run()`` drives the time loop and, like the reference destructor,
always tries to write the final restart file (default ``restart.nc``), also
when the run fails (``Model.cpp:40-53``).

``model.forcing_file`` (a time-interpolating forcing archive) is ROADMAP
M8b part 2's and raises ``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import Optional

from ..config import Configured
from ..grid.factory import StructureFactory
from ..io.restart import RestartFields
from ..state import dummy_forcing
from ..utils.logged import Logged
from ..utils.timer import main_timer
from .iterator import Iterator
from .model_step import ModelStep


class Model(Configured):
    DEFAULT_FINAL_FILENAME = "restart.nc"

    # Config keys (Model.cpp:22-29) + checkpoint cadence.
    KEYS = {
        "init_file": "model.init_file",
        "start": "model.start",
        "stop": "model.stop",
        "run_length": "model.run_length",
        "time_step": "model.time_step",
        "checkpoint_period": "model.checkpoint_period",
        "checkpoint_pattern": "model.checkpoint_pattern",
        "forcing_file": "model.forcing_file",
    }

    def __init__(self, *, device, dtype) -> None:
        self.device = device
        self.dtype = dtype
        self.iterator = Iterator()
        self.model_step = ModelStep()
        self.iterator.set_iterant(self.model_step)
        self.structure = None
        self.final_filename = self.DEFAULT_FINAL_FILENAME
        self.initial_filename = ""

    def configure(self, fields: Optional[RestartFields] = None) -> None:
        """Configure from the registered sources; the initial state is
        ``model.init_file``, or ``fields`` (an in-memory restart) if given."""
        get = Configured.get_configuration
        with main_timer.scope("configure"):
            if get(self.KEYS["forcing_file"], ""):
                raise NotImplementedError(
                    "model.forcing_file needs io/forcing_file.py, which the port does not "
                    "have yet (ROADMAP M8b part 2)"
                )
            start = get(self.KEYS["start"], "0")
            stop = get(self.KEYS["stop"], "0")
            duration = get(self.KEYS["run_length"], "")
            step = get(self.KEYS["time_step"], "1")
            self.iterator.parse_and_set(start, stop, duration, step)

            self.model_step.checkpoint_period = int(get(self.KEYS["checkpoint_period"], 0))
            self.model_step.checkpoint_pattern = get(
                self.KEYS["checkpoint_pattern"], "checkpoint.{step}.nc"
            )

            self.initial_filename = get(self.KEYS["init_file"], "")
            placement = dict(device=self.device, dtype=self.dtype)
            with main_timer.scope("restart-read"):
                if fields is None:
                    self.structure = StructureFactory.generate_from_file(
                        self.initial_filename, **placement
                    )
                else:
                    self.structure = StructureFactory.generate_from_fields(fields, **placement)
            self.model_step.init()
            self.model_step.set_initial_data(self.structure)
            self.structure.forcing = dummy_forcing(
                self.structure.nx, self.structure.ny, **placement
            )

    def set_final_filename(self, filename: str) -> None:
        self.final_filename = filename

    def run(self) -> None:
        """Run the time loop; always attempt the final restart write."""
        try:
            with main_timer.scope("run"):
                self.iterator.run()
        finally:
            try:
                self.write_restart_file()
            except Exception as err:  # Model.cpp:44-52: swallow, report.
                Logged.error(f"Failed writing restart file {self.final_filename}: {err}")

    def write_restart_file(self) -> None:
        with main_timer.scope("restart-write"):
            Logged.info(f"  Writing state-based restart file: {self.final_filename}")
            self.structure.dump(self.final_filename)
