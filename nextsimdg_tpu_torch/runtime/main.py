"""The model executable entry point.

Counterpart of ``nextsimdg_tpu.runtime.main`` (``main()``,
``core/src/main.cpp:14-37``): wire the command line into the Configurator,
collect config files, apply module defaults then config-driven selections,
then configure and run the Model.

Run as: ``python -m nextsimdg_tpu_torch --config-file run/dev1.cfg``. The
model runs on the CUDA card in float32 unless ``--cpu`` or ``--float64``
say otherwise (or a caller passes ``device`` and ``dtype``); without a card
and without ``--cpu`` it exits non-zero.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

import torch

from ..config import CommandLineParser, Configurator, ConfiguredModule
from ..modules import ModuleRegistry
from ..utils.timer import main_timer
from .model import Model


def main(argv: Optional[Sequence[str]] = None, *, device="cuda", dtype=torch.float32) -> int:
    argv = list(sys.argv if argv is None else argv)

    # Pass the command line to the Configurator (so config options can be
    # overridden with --section.key=value), then gather config files.
    Configurator.set_command_line(argv)
    cmd_line = CommandLineParser(argv)
    if cmd_line.help_requested:
        return 0
    if cmd_line.cpu_requested:
        device = "cpu"
    if cmd_line.float64_requested:
        dtype = torch.float64
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        print(
            "nextsimdg_tpu_torch: no CUDA device; pass --cpu to run on the CPU", file=sys.stderr
        )
        return 2
    Configurator.add_files(cmd_line.get_config_file_names())

    # Import the physics and grid packages so their modules register, then select.
    from .. import grid, physics  # noqa: F401

    loader = ModuleRegistry.get_loader()
    loader.set_all_defaults()
    ConfiguredModule.parse_configurator()

    model = Model(device=device, dtype=dtype)
    model.configure()
    model.run()
    print(main_timer.report(), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
