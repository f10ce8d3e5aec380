"""Static registry of configuration sources and the on-demand parser.

The port's copy of ``nextsimdg_tpu.config.configurator``, unchanged.

Semantics match the reference ``Configurator``
(``core/src/Configurator.cpp:18-60``, ``core/src/include/Configurator.hpp``):

* sources are an ordered list of INI text streams plus an optional command
  line;
* ``parse`` evaluates a set of declared options against all sources with
  *first-parsed-wins* precedence — the command line is parsed first (so it
  overrides files), then streams in the order they were added;
* unknown keys in any source are ignored (``allow_unregistered``);
* a malformed stream is reported to stderr and skipped
  (``Configurator.cpp:49-52``);
* streams are kept (the C++ code rewinds them) so every consumer class can
  re-parse all sources.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence


def _parse_bool(text: str) -> bool:
    """Boost program_options bool lexical cast: 1/0, true/false, on/off, yes/no."""
    lowered = text.strip().lower()
    if lowered in ("1", "true", "on", "yes"):
        return True
    if lowered in ("0", "false", "off", "no"):
        return False
    raise ValueError(f"invalid bool value: {text!r}")


def convert_value(text: str, value_type: type) -> Any:
    """Convert raw INI/CLI text to the declared option type."""
    if value_type is bool:
        return _parse_bool(text)
    if value_type is int:
        return int(text.strip(), 0)
    if value_type is float:
        return float(text.strip())
    if value_type is str:
        return text
    return value_type(text)


@dataclass
class ConfigOption:
    """One declared option: dotted name, value type, and default."""

    name: str
    value_type: type
    default: Any = None


class OptionsDescription:
    """A set of declared options, analogous to boost options_description."""

    def __init__(self) -> None:
        self.options: Dict[str, ConfigOption] = {}

    def add(self, name: str, value_type: type, default: Any = None) -> "OptionsDescription":
        self.options[name] = ConfigOption(name, value_type, default)
        return self


class IniParseError(ValueError):
    """Raised when an INI stream cannot be parsed."""


def parse_ini(text: str) -> List[tuple]:
    """Parse INI text into an ordered list of (dotted_key, raw_value) pairs.

    Mirrors boost ``parse_config_file``: ``[section]`` headers prefix
    subsequent keys as ``section.key``; ``#`` and ``;`` start comments;
    keys outside any section keep their bare name; values keep internal
    whitespace but are stripped at the ends.
    """
    pairs: List[tuple] = []
    section = ""
    for lineno, raw_line in enumerate(text.splitlines(), start=1):
        line = raw_line.strip()
        if not line or line.startswith("#") or line.startswith(";"):
            continue
        if line.startswith("["):
            if not line.endswith("]"):
                raise IniParseError(f"line {lineno}: malformed section header: {raw_line!r}")
            section = line[1:-1].strip()
            continue
        if "=" not in line:
            raise IniParseError(f"line {lineno}: expected 'key = value': {raw_line!r}")
        key, _, value = line.partition("=")
        key = key.strip()
        if not key:
            raise IniParseError(f"line {lineno}: empty key: {raw_line!r}")
        # Strip trailing comments from the value.
        for marker in ("#", ";"):
            idx = value.find(marker)
            if idx >= 0:
                value = value[:idx]
        value = value.strip()
        dotted = f"{section}.{key}" if section else key
        pairs.append((dotted, value))
    return pairs


def parse_command_line(argv: Sequence[str], names: Sequence[str]) -> List[tuple]:
    """Extract ``--name value`` / ``--name=value`` pairs for registered names.

    Unregistered tokens are ignored, matching boost's ``allow_unregistered``
    unix-style parse. ``argv[0]`` (the program name) is skipped.
    """
    known = set(names)
    pairs: List[tuple] = []
    tokens = list(argv[1:]) if argv else []
    i = 0
    while i < len(tokens):
        token = tokens[i]
        if token.startswith("--"):
            body = token[2:]
            if "=" in body:
                key, _, value = body.partition("=")
                if key in known:
                    pairs.append((key, value))
            elif body in known and i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
                pairs.append((body, tokens[i + 1]))
                i += 1
        i += 1
    return pairs


class Configurator:
    """Process-wide registry of configuration sources.

    All state is class-level, mirroring the static members of the C++
    ``Configurator`` — tests must call :meth:`clear` / :meth:`clear_streams`
    between cases, exactly as the reference tests do
    (``core/test/Configurator_test.cpp:119-143``).
    """

    _streams: List[str] = []
    _argv: Optional[List[str]] = None
    # Optional hook: additional data sources (e.g. the config map used by
    # ConfigOutput); parsed after command line, before streams.
    _extra_sources: List[Callable[[], Dict[str, str]]] = []

    # -- source registration -------------------------------------------------
    @classmethod
    def add_stream(cls, text: str) -> None:
        """Add one INI-formatted text source (parsed after earlier ones)."""
        cls._streams.append(text)

    @classmethod
    def add_streams(cls, texts: Sequence[str]) -> None:
        for text in texts:
            cls.add_stream(text)

    @classmethod
    def add_file(cls, path: str) -> None:
        with open(path, "r", encoding="utf-8") as handle:
            cls.add_stream(handle.read())

    @classmethod
    def add_files(cls, paths: Sequence[str]) -> None:
        for path in paths:
            cls.add_file(path)

    @classmethod
    def set_command_line(cls, argv: Optional[Sequence[str]]) -> None:
        cls._argv = list(argv) if argv is not None else None

    @classmethod
    def clear_streams(cls) -> None:
        cls._streams = []

    @classmethod
    def clear(cls) -> None:
        cls.clear_streams()
        cls._argv = None
        cls._extra_sources = []

    # -- parsing -------------------------------------------------------------
    @classmethod
    def parse(cls, options: OptionsDescription) -> Dict[str, Any]:
        """Resolve declared options against all sources, first-parsed-wins."""
        result: Dict[str, Any] = {}

        def store(key: str, raw: str) -> None:
            if key in result:
                return  # first parse wins
            option = options.options[key]
            try:
                result[key] = convert_value(raw, option.value_type)
            except (ValueError, TypeError) as err:
                raise ValueError(f"option {key!r}: {err}") from err

        names = list(options.options)
        # 1. Command line (parsed first so it overrides everything).
        if cls._argv is not None:
            for key, raw in parse_command_line(cls._argv, names):
                store(key, raw)
        # 2. Extra programmatic sources.
        for source in cls._extra_sources:
            for key, raw in source().items():
                if key in options.options:
                    store(key, str(raw))
        # 3. Streams, in addition order; malformed streams are skipped.
        for stream in cls._streams:
            try:
                pairs = parse_ini(stream)
            except IniParseError as err:
                print(f"Configuration parsing error: {err}", file=sys.stderr)
                continue
            for key, raw in pairs:
                if key in options.options:
                    store(key, raw)
        # 4. Defaults for anything still unset.
        for key, option in options.options.items():
            if key not in result:
                result[key] = option.default
        return result

    @classmethod
    def all_set_keys(cls) -> Dict[str, str]:
        """Return every key present in any source (raw strings, first wins).

        Used by the module-selection system to discover ``Modules.*`` keys.
        """
        seen: Dict[str, str] = {}
        if cls._argv is not None:
            # Without a registered-name list, accept every --key=value token.
            tokens = cls._argv[1:]
            i = 0
            while i < len(tokens):
                token = tokens[i]
                if token.startswith("--"):
                    body = token[2:]
                    if "=" in body:
                        key, _, value = body.partition("=")
                        seen.setdefault(key, value)
                    elif i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
                        seen.setdefault(body, tokens[i + 1])
                        i += 1
                i += 1
        for source in cls._extra_sources:
            for key, raw in source().items():
                seen.setdefault(key, str(raw))
        for stream in cls._streams:
            try:
                pairs = parse_ini(stream)
            except IniParseError:
                continue
            for key, raw in pairs:
                seen.setdefault(key, raw)
        return seen
