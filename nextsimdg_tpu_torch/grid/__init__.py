"""Model structures (grids) and the structure factory."""

from .devgrid import DevGrid
from .factory import StructureFactory
from .rectgrid import RectGrid
from .structure import IStructure

__all__ = ["IStructure", "DevGrid", "RectGrid", "StructureFactory"]
