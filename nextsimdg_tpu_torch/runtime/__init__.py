"""Model runtime: time-stepping iterator, model step, model facade, CLI."""

from .iterator import Iterant, Iterator, NullIterant
from .model import Model
from .model_step import ModelStep

__all__ = ["Iterator", "Iterant", "NullIterant", "ModelStep", "Model"]
