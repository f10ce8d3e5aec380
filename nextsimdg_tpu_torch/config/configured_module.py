"""Config-driven module selection.

The port's copy of ``nextsimdg_tpu.config.configured_module``
(``ConfiguredModule``, ``core/src/ConfiguredModule.cpp:19-56``), bound to
the port's registry: for every registered module interface, the option
``Modules.<InterfaceName>`` selects the implementation; an unknown
implementation name raises :class:`~nextsimdg_tpu_torch.modules.ModuleError`.
"""

from __future__ import annotations

from ..modules import ModuleRegistry
from .configurator import Configurator, OptionsDescription

#: Section prefix for module-selection keys (``ConfiguredModule.cpp:17``).
MODULE_PREFIX = "Modules"


class ConfiguredModule:
    @staticmethod
    def add_prefix(interface: str) -> str:
        return f"{MODULE_PREFIX}.{interface}"

    @staticmethod
    def parse_configurator() -> None:
        """Apply ``Modules.*`` selections from all configuration sources."""
        loader = ModuleRegistry.get_loader()
        desc = OptionsDescription()
        for interface in loader.list_modules():
            desc.add(ConfiguredModule.add_prefix(interface), str, "")
        values = Configurator.parse(desc)
        for interface in loader.list_modules():
            impl = values[ConfiguredModule.add_prefix(interface)]
            if impl:
                # Raises ModuleError on an unknown implementation, as the
                # reference raises std::domain_error (ConfiguredModule.cpp:49-53).
                loader.set_implementation(interface, impl)
