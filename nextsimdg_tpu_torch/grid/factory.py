"""Structure factory.

Counterpart of ``nextsimdg_tpu.grid.factory`` (``StructureFactory``,
``core/src/StructureFactory.cpp:20-59``): ``generate(name)`` walks the
registered implementations of ``Nextsim::IStructure`` and matches the
case-insensitive structure name, raising on an unknown name;
``generate_from_file`` dispatches on the ``/structure@type`` attribute of a
restart file, ``generate_from_fields`` on that of an in-memory restart.
Every structure is built on the caller's ``device`` in its ``dtype``.
"""

from __future__ import annotations

from ..io.restart import RestartFields, read_restart
from ..modules import ModuleRegistry
from .structure import IStructure

INTERFACE = "Nextsim::IStructure"


class StructureFactory:
    @staticmethod
    def generate(name: str, *, device, dtype) -> IStructure:
        loader = ModuleRegistry.get_loader()
        for impl_name in loader.list_implementations(INTERFACE):
            cls = loader._factories[INTERFACE][impl_name]
            if cls.handles_structure_name(name):
                return cls(device=device, dtype=dtype)
        raise ValueError(f"Invalid structure name: {name}")

    @staticmethod
    def generate_from_fields(fields: RestartFields, *, device, dtype) -> IStructure:
        structure = StructureFactory.generate(fields.structure_type, device=device, dtype=dtype)
        structure.load_restart(fields)
        return structure

    @staticmethod
    def generate_from_file(file_path: str, *, device, dtype) -> IStructure:
        return StructureFactory.generate_from_fields(
            read_restart(file_path), device=device, dtype=dtype
        )
