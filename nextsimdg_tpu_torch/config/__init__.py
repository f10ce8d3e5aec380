"""Configuration subsystem.

The port's copy of ``nextsimdg_tpu.config`` (the reference's
Boost.program_options stack: ``core/src/Configurator.cpp``,
``Configured.hpp``, ``ConfiguredModule.cpp``, ``CommandLineParser.cpp``),
with the same semantics:

* INI files / streams with ``[section]`` + ``key = value`` mapping to dotted
  option names (``section.key``);
* first-parsed-wins precedence: command line beats files, earlier files beat
  later files;
* unknown options are ignored; parse errors in one stream are reported and
  that stream skipped;
* per-consumer defaults.

The port's ``Configurator`` is a process-wide singleton of its own,
independent of the JAX package's, and ``ConfiguredModule`` selects
implementations in the port's registry (``nextsimdg_tpu_torch.modules``).
Whoever adds a source calls ``Configurator.clear()`` when done.
"""

from .command_line import CommandLineParser
from .configurator import ConfigOption, Configurator, OptionsDescription
from .configured import Configured, try_configure
from .configured_module import ConfiguredModule

__all__ = [
    "Configurator",
    "OptionsDescription",
    "ConfigOption",
    "Configured",
    "try_configure",
    "ConfiguredModule",
    "CommandLineParser",
]
