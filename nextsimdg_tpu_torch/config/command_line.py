"""Command-line parsing for the model driver.

The port's copy of ``nextsimdg_tpu.config.command_line``, with two
switches of the port's engine besides: ``--cpu`` runs the model on the CPU
(the default is the CUDA card) and ``--float64`` in float64 (the default is
float32), the counterparts of the JAX package's ``JAX_PLATFORMS`` and
``JAX_ENABLE_X64``.

Mirrors ``CommandLineParser`` (``core/src/CommandLineParser.cpp:23-66``):
recognises ``--help``, ``--config-file <file>`` and
``--config-files <file...>`` and preserves the order config files were given
(which Boost's variables_map does not, hence the reference's manual token
walk — here order preservation is natural).
"""

from __future__ import annotations

import sys
from typing import List, Sequence

USAGE = """\
nextsim [options]
Options:
  --help                 print help message
  --config-file FILE     specify a configuration file
  --config-files FILES   specify a list of configuration files
  --cpu                  run on the CPU (default: the CUDA card)
  --float64              compute in float64 (default: float32)
"""


class CommandLineParser:
    def __init__(self, argv: Sequence[str]) -> None:
        self._config_files: List[str] = []
        self.help_requested = False
        self.cpu_requested = False
        self.float64_requested = False

        tokens = list(argv[1:])
        i = 0
        while i < len(tokens):
            token = tokens[i]
            if token == "--help":
                self.help_requested = True
                print(USAGE)
            elif token == "--cpu":
                self.cpu_requested = True
            elif token == "--float64":
                self.float64_requested = True
            elif token == "--config-file":
                if i + 1 < len(tokens):
                    self._config_files.append(tokens[i + 1])
                    i += 1
            elif token.startswith("--config-file="):
                self._config_files.append(token.partition("=")[2])
            elif token == "--config-files":
                while i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
                    self._config_files.append(tokens[i + 1])
                    i += 1
            i += 1

    def get_config_file_names(self) -> List[str]:
        """Config file names, in the order they appeared on the command line."""
        return list(self._config_files)
