"""Enum option parsing helper.

The port's copy of ``nextsimdg_tpu.config.enum_map``, unchanged.

Mirrors ``EnumWrapper`` (``core/src/include/EnumWrapper.hpp:58-112``): a
static string→enum map makes an enum usable as a config option type; an
unmapped token raises (boost ``validation_error`` → ``ValueError``).
"""

from __future__ import annotations

from typing import Dict, Generic, Type, TypeVar

E = TypeVar("E")


class EnumWrapper(Generic[E]):
    """Callable converter from config text to an enum value via a set map."""

    def __init__(self, enum_type: Type[E], mapping: Dict[str, E]) -> None:
        self._enum_type = enum_type
        self._map = dict(mapping)

    def __call__(self, text: str) -> E:
        token = text.strip()
        if token not in self._map:
            raise ValueError(
                f"invalid value {token!r} for enum {self._enum_type.__name__}"
            )
        return self._map[token]
