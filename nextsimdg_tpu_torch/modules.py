"""Runtime-selectable module registry.

The port's own copy of ``nextsimdg_tpu.modules`` (that module imports no
JAX, but the port imports nothing of the JAX package). Implementations
register themselves at import time and are addressed by the reference's
string names (``Nextsim::IDynamics`` -> ``Nextsim::MEVPHighOrder`` ...), so
the same config files select the same modules. The contract is the
reference ``ModuleLoader``'s:

* the default implementation is the first one registered;
* ``get_implementation`` returns a cached ("static") instance of the
  selected implementation, ``get_instance`` a fresh one;
* selecting an unknown interface or implementation raises ``ModuleError``.

The registry is one object per process: whoever selects an implementation
(a test, a benchmark) calls ``reset()`` when done, so the selection does not
leak into the next user.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List


class ModuleError(ValueError):
    """Unknown module interface or implementation."""


class ModuleRegistry:
    """Singleton registry of interface -> {implementation name -> factory}."""

    _instance: "ModuleRegistry" = None

    def __init__(self) -> None:
        self._factories: Dict[str, Dict[str, Callable[[], Any]]] = {}
        self._order: Dict[str, List[str]] = {}
        self._selected: Dict[str, str] = {}
        self._static_instances: Dict[str, Any] = {}

    @classmethod
    def get_loader(cls) -> "ModuleRegistry":
        if cls._instance is None:
            cls._instance = ModuleRegistry()
        return cls._instance

    # -- registration --------------------------------------------------------
    def register(self, interface: str, name: str, factory: Callable[[], Any]) -> None:
        impls = self._factories.setdefault(interface, {})
        if name not in impls:
            self._order.setdefault(interface, []).append(name)
        impls[name] = factory

    # -- introspection -------------------------------------------------------
    def list_modules(self) -> List[str]:
        return list(self._factories)

    def list_implementations(self, interface: str) -> List[str]:
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        return list(self._order[interface])

    def selected_name(self, interface: str) -> str:
        if interface not in self._selected:
            self.set_default(interface)
        return self._selected[interface]

    # -- selection -----------------------------------------------------------
    def set_implementation(self, interface: str, name: str) -> None:
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        if name not in self._factories[interface]:
            raise ModuleError(f"{name} is not an implementation of the module {interface}")
        self._selected[interface] = name
        self._static_instances.pop(interface, None)

    def set_default(self, interface: str) -> None:
        """Select the first-registered implementation (the default)."""
        if interface not in self._order:
            raise ModuleError(f"unknown module interface: {interface}")
        self.set_implementation(interface, self._order[interface][0])

    def set_all_defaults(self) -> None:
        for interface in self._factories:
            self.set_default(interface)

    # -- retrieval -----------------------------------------------------------
    def get_implementation(self, interface: str) -> Any:
        """The cached ("static") instance of the selected implementation."""
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        if interface not in self._selected:
            self.set_default(interface)
        if interface not in self._static_instances:
            name = self._selected[interface]
            self._static_instances[interface] = self._factories[interface][name]()
        return self._static_instances[interface]

    def get_instance(self, interface: str) -> Any:
        """A fresh instance of the selected implementation."""
        if interface not in self._factories:
            raise ModuleError(f"unknown module interface: {interface}")
        if interface not in self._selected:
            self.set_default(interface)
        return self._factories[interface][self._selected[interface]]()

    def reset(self) -> None:
        """Drop all selections and cached instances (not registrations)."""
        self._selected = {}
        self._static_instances = {}


def register_implementation(interface: str, name: str):
    """Class/function decorator registering an implementation factory: a
    class is instantiated, anything else is returned as it is."""

    def wrap(factory):
        loader = ModuleRegistry.get_loader()
        if isinstance(factory, type):
            loader.register(interface, name, factory)
        else:
            loader.register(interface, name, lambda: factory)
        return factory

    return wrap


def get_loader() -> ModuleRegistry:
    """The process's registry (the reference's ``ModuleLoader::getLoader()``)."""
    return ModuleRegistry.get_loader()
