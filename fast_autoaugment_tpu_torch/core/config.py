"""Immutable configuration objects (the port's copy of
``fast_autoaugment_tpu/core/config.py``), with a reader for the YAML that
``confs/*.yaml`` use in place of PyYAML.

- :class:`Config` wraps a nested dict; attribute and item access;
  ``cfg.replace(**dotted)`` returns a new config.
- :func:`load_config` reads a preset and applies dotted-path overrides.
- :func:`parse_yaml` reads the subset of YAML that the presets use: nested
  block maps by indentation, plain scalars, single- and double-quoted
  strings, comments and blank lines.  Plain scalars resolve as PyYAML's
  ``safe_load`` resolves them (YAML 1.1): null (``~``, ``null``, empty),
  booleans (``true``/``yes``/``on`` and their opposites, in three cases),
  integers (decimal, ``0x``, ``0b``, leading-0 octal, with ``_``), floats
  (with a dot, ``.inf``, ``.nan``), else strings.  Anything outside that
  subset (sequences, flow collections, anchors, tags, block scalars,
  documents, sexagesimal numbers, timestamps) raises ``ValueError`` with
  its line number.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterator, Mapping

__all__ = ["Config", "load_config", "parse_overrides", "parse_yaml"]


def _freeze(value: Any) -> Any:
    if isinstance(value, Mapping):
        return Config(value)
    if isinstance(value, (list, tuple)):
        return tuple(_freeze(v) for v in value)
    return value


def _thaw(value: Any) -> Any:
    if isinstance(value, Config):
        return {k: _thaw(v) for k, v in value.items()}
    if isinstance(value, tuple):
        return [_thaw(v) for v in value]
    return value


class Config(Mapping):
    """Immutable nested mapping with attribute access.

    >>> c = Config({'model': {'type': 'wresnet40_2'}, 'lr': 0.1})
    >>> c.model.type, c['lr'], c.get('missing', 3)
    ('wresnet40_2', 0.1, 3)
    >>> c.replace(**{'model.type': 'resnet50'}).model.type
    'resnet50'
    """

    __slots__ = ("_data", "_hash")

    def __init__(self, data: Mapping | None = None):
        object.__setattr__(self, "_data", {k: _freeze(v) for k, v in (data or {}).items()})
        object.__setattr__(self, "_hash", None)

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __getattr__(self, key: str) -> Any:
        try:
            return self._data[key]
        except KeyError:
            raise AttributeError(key) from None

    def __setattr__(self, key: str, value: Any):
        raise TypeError("Config is immutable; use .replace()")

    def get(self, key: str, default: Any = None) -> Any:
        """Dotted-path lookup with default: ``cfg.get('optimizer.clip', 5.0)``."""
        node: Any = self
        for part in key.split("."):
            if isinstance(node, Config) and part in node:
                node = node[part]
            else:
                return default
        return node

    def to_dict(self) -> dict:
        return {k: _thaw(v) for k, v in self._data.items()}

    def replace(self, **dotted: Any) -> "Config":
        """A new Config with dotted-path keys replaced."""
        data = self.to_dict()
        for path, value in dotted.items():
            node = data
            parts = path.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = value
        return Config(data)

    def __hash__(self) -> int:
        if self._hash is None:
            object.__setattr__(
                self, "_hash", hash(json.dumps(self.to_dict(), sort_keys=True, default=str)))
        return self._hash

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Config) and self.to_dict() == other.to_dict()

    def __repr__(self) -> str:
        return f"Config({self.to_dict()!r})"


# ------------------------------------------------ the YAML subset reader

# PyYAML's implicit resolvers (yaml/resolver.py), less sexagesimal numbers
_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[0-1_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)")
_OUTSIDE = re.compile(r"[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"  # sexagesimal
                      r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*")  # timestamps


def _plain(text: str, line: int) -> Any:
    """A plain scalar, resolved as ``yaml.safe_load`` resolves it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t == "0":
            return 0
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if t.startswith("0"):
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.fullmatch(text):
        t = text.replace("_", "").lower()
        sign = -1.0 if t[0] == "-" else 1.0
        t = t.lstrip("+-")
        if t == ".inf":
            return sign * float("inf")
        if t == ".nan":
            return float("nan")
        return sign * float(t)
    if (_OUTSIDE.fullmatch(text) or text[0] in "[]{}&*!|>%@`\"'?,#" or text == "-"
            or text.startswith("- ") or ": " in text or text.endswith(":")):
        raise ValueError(f"line {line}: {text!r} is outside the YAML subset this reader takes")
    return text


def _quoted(text: str, line: int) -> tuple[str, str]:
    """A quoted scalar at the start of `text` -> (value, rest of the line)."""
    q = text[0]
    out, i = [], 1
    escapes = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0", "r": "\r"}
    while i < len(text):
        c = text[i]
        if q == "'" and c == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if q == '"' and c == '"':
            return "".join(out), text[i + 1:]
        if q == '"' and c == "\\":
            nxt = text[i + 1:i + 2]
            if nxt not in escapes:
                raise ValueError(f"line {line}: escape \\{nxt} is outside the YAML subset")
            out.append(escapes[nxt])
            i += 2
            continue
        out.append(c)
        i += 1
    raise ValueError(f"line {line}: unterminated {q}-quoted string (multi-line strings are "
                     "outside the YAML subset)")


def _strip_comment(text: str) -> str:
    """Drop a ``#`` comment that starts the text or follows a space."""
    m = re.search(r"(^|\s)#", text)
    return text[:m.start()] if m else text


def _value(text: str, line: int) -> Any:
    text = text.strip()
    if text[:1] in ("'", '"'):
        value, rest = _quoted(text, line)
        if _strip_comment(rest).strip():
            raise ValueError(f"line {line}: text after a quoted scalar: {rest.strip()!r}")
        return value
    return _plain(_strip_comment(text).strip(), line)


def parse_yaml(text: str) -> dict:
    """The nested dict of a YAML document in the subset of the module
    docstring (an empty document is ``{}``)."""
    root: dict = {}
    stack: list[tuple[int, dict]] = [(0, root)]  # (indent of the map's keys, map)
    pending: tuple[dict, Any, int] | None = None  # a key whose value may be a block
    key_re = re.compile(r"""('(?:[^']|'')*'|"(?:[^"\\]|\\.)*"|[^\s'"#:][^:]*?)\s*:(?:\s|$)""")
    for line_no, raw in enumerate(text.splitlines(), start=1):
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError(f"line {line_no}: tab indentation is outside the YAML subset")
        if body in ("---", "...", "-") or body.startswith(("- ", "%")):
            raise ValueError(f"line {line_no}: {body!r} is outside the YAML subset this "
                             "reader takes (documents, sequences, directives)")
        indent = len(raw) - len(raw.lstrip(" "))
        if pending is not None:
            parent, key, parent_indent = pending
            if indent > parent_indent:  # the key's value is the block that starts here
                parent[key] = {}
                stack.append((indent, parent[key]))
            pending = None
        while stack[-1][0] > indent:
            stack.pop()
        if stack[-1][0] != indent:
            raise ValueError(f"line {line_no}: indentation {indent} matches no open map")
        cur = stack[-1][1]
        m = key_re.match(body)
        if m is None:
            raise ValueError(f"line {line_no}: {body!r} is not a 'key: value' line of the "
                             "YAML subset")
        key = _value(m.group(1), line_no)
        if key in cur:
            raise ValueError(f"line {line_no}: duplicate key {key!r}")
        rest = body[m.end():]
        if _strip_comment(rest).strip():
            cur[key] = _value(rest, line_no)
        else:  # an empty value is null unless a deeper block follows
            cur[key] = None
            pending = (cur, key, indent)
    return root


def _coerce(text: str) -> Any:
    """An override value with the YAML scalar rules ('5' -> 5); text that
    the reader does not take stays text, as PyYAML errors do in the JAX
    package's ``_coerce``."""
    try:
        return _value(text, 1) if text.strip() else None
    except ValueError:
        return text


def parse_overrides(pairs: list[str]) -> dict:
    """``["model.type=resnet50", "lr=0.4"]`` -> a dotted dict."""
    out: dict[str, Any] = {}
    for pair in pairs:
        if "=" not in pair:
            raise ValueError(f"override must look like key=value, got {pair!r}")
        key, _, value = pair.partition("=")
        out[key.strip()] = _coerce(value.strip())
    return out


def load_config(path: str | None = None, overrides: list[str] | dict | None = None,
                defaults: Mapping | None = None) -> Config:
    """Load a YAML preset and apply dotted overrides (the reference's
    ``ConfigArgumentParser``: file values, then command-line overrides)."""
    data: dict = dict(defaults or {})
    if path is not None:
        with open(path) as fh:
            data.update(parse_yaml(fh.read()))
    cfg = Config(data)
    if overrides:
        if isinstance(overrides, list):
            overrides = parse_overrides(overrides)
        cfg = cfg.replace(**overrides)
    return cfg
