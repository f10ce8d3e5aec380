"""Per-class configuration mixin.

The port's copy of ``nextsimdg_tpu.config.configured``, unchanged.

Mirrors the CRTP base ``Configured<C>`` (``core/src/include/Configured.hpp:
32-189``): a virtual ``configure()``, a static ``get_configuration(name,
default)`` convenience that builds a one-option description and parses all
sources, a staged ``add_option``/``retrieve_value`` API backed by a per-class
option map, and the duck-typed free function ``try_configure``.
"""

from __future__ import annotations

from typing import Any, Dict

from .configurator import Configurator, OptionsDescription


class Configured:
    """Base class for configurable components.

    Each *subclass* gets its own staged-options map (the C++ version's
    per-instantiation ``configuration`` static), created lazily via
    ``__init_subclass__``.
    """

    _staged: Dict[str, Any]

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        cls._staged = {}
        cls._staged_desc = OptionsDescription()

    def configure(self) -> None:  # noqa: B027 - intentional no-op default
        """Configure the object from the registered sources. Override me."""

    # -- one-shot convenience (Configured.hpp:73-79) -------------------------
    @staticmethod
    def get_configuration(name: str, default: Any) -> Any:
        """Parse a single option with a default; type comes from the default."""
        desc = OptionsDescription().add(name, type(default), default)
        return Configurator.parse(desc)[name]

    # -- staged API (Configured.hpp:95-124) ----------------------------------
    @classmethod
    def add_option(cls, name: str, default: Any, value_type: type = None) -> None:
        """Stage an option for later retrieval by ``retrieve_value``."""
        cls._staged_desc.add(name, value_type or type(default), default)

    @classmethod
    def retrieve_value(cls, name: str) -> Any:
        """Retrieve a staged option's value, parsing all sources."""
        return Configurator.parse(cls._staged_desc)[name]

    @classmethod
    def clear_configuration_map(cls) -> None:
        """Reset the per-class staged options (test helper)."""
        cls._staged = {}
        cls._staged_desc = OptionsDescription()


def try_configure(obj: Any) -> bool:
    """Configure ``obj`` if it is configurable; return whether it was.

    Duck-typed equivalent of the reference's ``tryConfigure(T&/T*)``
    (``Configured.hpp:141-189``): anything exposing a callable ``configure``
    attribute is configured.
    """
    configure = getattr(obj, "configure", None)
    if callable(configure):
        configure()
        return True
    return False
