"""YAML deep-merge config loading (port of
``multimodal_clinical_tpu/config/merge.py``).

A base YAML provides defaults, a per-dataset YAML overrides it with a
recursive dict merge (utils/merge_yaml.py:3-20).  The files are read by
``safe_load`` below, a reader of the YAML subset the repository's
``configs/*.yaml`` use, so the port needs no YAML package:

* a document is a top-level block mapping (``key: value`` lines starting
  in column 0) or a single value;
* values are plain scalars resolved as PyYAML's ``safe_load`` resolves
  them (ints, floats such as ``1.0e-2``, the YAML 1.1 bools, ``null``/``~``,
  everything else a string), single- and double-quoted strings, ``[a, b]``
  flow sequences and ``{k: v}`` flow mappings, nested;
* ``#`` starts a comment at the start of a line or after whitespace.

Anything else raises ``ValueError``: block sequences, nested block
mappings, anchors, aliases, tags, multi-line and block scalars, several
documents, and plain scalars that PyYAML would read as another type (octal,
hexadecimal, binary or underscored ints, sexagesimal numbers, dates, the
merge key).  A value is never passed through as its raw text.
"""

from __future__ import annotations

import re
from typing import Any, Dict

_BOOLS = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                           "On", "ON"), True),
          **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                           "Off", "OFF"), False)}
_NULLS = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)")
_FLOAT = re.compile(r"[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9]+(?:[eE][-+][0-9]+)?")
_SPECIAL_FLOATS = {".inf": float("inf"), ".Inf": float("inf"),
                   ".INF": float("inf"), "+.inf": float("inf"),
                   "+.Inf": float("inf"), "+.INF": float("inf"),
                   "-.inf": float("-inf"), "-.Inf": float("-inf"),
                   "-.INF": float("-inf"), ".nan": float("nan"),
                   ".NaN": float("nan"), ".NAN": float("nan")}
# plain scalars PyYAML resolves to types outside the subset
_UNSUPPORTED = re.compile(
    r"[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0o[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[-+]?[0-9][0-9_]*"
    r"|[-+]?(?:[0-9][0-9_]*\.[0-9_]*|\.[0-9_]+)(?:[eE][-+][0-9]+)?"
    r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*|<<|=")
_INDICATORS = "&*!|>%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}


def _resolve(text: str) -> Any:
    """A plain scalar's value, as PyYAML's safe_load resolves it."""
    if text in _BOOLS:
        return _BOOLS[text]
    if text in _NULLS:
        return None
    if _INT.fullmatch(text):
        return int(text)
    if _FLOAT.fullmatch(text):
        return float(text)
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    if _UNSUPPORTED.fullmatch(text):
        raise ValueError(f"unsupported YAML scalar {text!r}")
    return text


class _Line:
    """Recursive-descent reader of one line's value."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def fail(self, what: str):
        raise ValueError(f"unsupported YAML: {what} in {self.s!r}")

    def peek(self) -> str:
        return self.s[self.i] if self.i < len(self.s) else ""

    def skip_spaces(self) -> None:
        while self.peek() in (" ", "\t") and self.peek():
            self.i += 1

    def end(self) -> None:
        """Only spaces and a comment may follow the value."""
        self.skip_spaces()
        if self.peek() and not (self.peek() == "#" and (
                self.i == 0 or self.s[self.i - 1] in " \t")):
            self.fail(f"trailing text {self.s[self.i:]!r}")

    def value(self, flow: bool) -> Any:
        self.skip_spaces()
        c = self.peek()
        if c == "[":
            return self.sequence()
        if c == "{":
            return self.mapping()
        if c == '"':
            return self.double_quoted()
        if c == "'":
            return self.single_quoted()
        return self.plain(flow)

    def plain(self, flow: bool) -> Any:
        c = self.peek()
        if c and (c in _INDICATORS or c in "]}#,"
                  or (c in "-?:" and self.s[self.i + 1:self.i + 2] in
                      ("", " ", "\t"))):
            self.fail(f"indicator {c!r}")
        start = self.i
        while self.i < len(self.s):
            c = self.s[self.i]
            nxt = self.s[self.i + 1:self.i + 2]
            if c == "#" and self.i > start and self.s[self.i - 1] in " \t":
                break
            if c == ":" and nxt in ("", " ", "\t") + ((",", "]", "}")
                                                       if flow else ()):
                break
            if flow and c in ",[]{}":
                break
            self.i += 1
        return _resolve(self.s[start:self.i].rstrip(" \t"))

    def double_quoted(self) -> str:
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if not c:
                self.fail("unterminated string")
            self.i += 1
            if c == '"':
                return "".join(out)
            if c != "\\":
                out.append(c)
                continue
            e = self.peek()
            self.i += 1
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
            elif e in ("x", "u", "U"):
                n = {"x": 2, "u": 4, "U": 8}[e]
                digits = self.s[self.i:self.i + n]
                if not re.fullmatch(r"[0-9a-fA-F]{%d}" % n, digits):
                    self.fail(f"escape \\{e}{digits}")
                out.append(chr(int(digits, 16)))
                self.i += n
            else:
                self.fail(f"escape \\{e}")

    def single_quoted(self) -> str:
        self.i += 1
        out = []
        while True:
            c = self.peek()
            if not c:
                self.fail("unterminated string")
            self.i += 1
            if c == "'":
                if self.peek() == "'":
                    out.append("'")
                    self.i += 1
                    continue
                return "".join(out)
            out.append(c)

    def sequence(self) -> list:
        self.i += 1
        out = []
        self.skip_spaces()
        if self.peek() == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(flow=True))
            self.skip_spaces()
            c = self.peek()
            self.i += 1
            if c == "]":
                return out
            if c != ",":
                self.fail("flow sequence")
            self.skip_spaces()
            if self.peek() == "]":
                self.i += 1
                return out

    def mapping(self) -> dict:
        self.i += 1
        out: Dict[Any, Any] = {}
        self.skip_spaces()
        if self.peek() == "}":
            self.i += 1
            return out
        while True:
            key = self.value(flow=True)
            self.skip_spaces()
            if self.peek() != ":":
                self.fail("flow mapping without ': '")
            self.i += 1
            self.skip_spaces()
            out[key] = (None if self.peek() in (",", "}")
                        else self.value(flow=True))
            self.skip_spaces()
            c = self.peek()
            self.i += 1
            if c == "}":
                return out
            if c != ",":
                self.fail("flow mapping")
            self.skip_spaces()
            if self.peek() == "}":
                self.i += 1
                return out


_KEY = re.compile(r"([^\s#:'\"\[\]{},&*!|>%@`-][^:#]*?|-[^\s:#][^:#]*?)"
                  r"\s*:(?=\s|$)")


def safe_load(text: str) -> Any:
    """The value of a YAML document in the subset described above."""
    lines = [ln for ln in text.splitlines()
             if ln.strip() and not ln.lstrip().startswith("#")]
    if not lines:
        return None
    if any(ln.startswith(("---", "...", "%")) for ln in lines):
        raise ValueError("unsupported YAML: document markers or directives")
    key_lines = [_KEY.match(ln) for ln in lines]
    if not any(key_lines):
        if len(lines) > 1:
            raise ValueError("unsupported YAML: a multi-line value")
        reader = _Line(lines[0].strip())
        value = reader.value(flow=False)
        reader.end()
        return value
    out: Dict[Any, Any] = {}
    for line, match in zip(lines, key_lines):
        if line[0] in " \t" or match is None:
            raise ValueError(
                f"unsupported YAML: {line!r} (nested block or block "
                "sequence)")
        key = _resolve(match.group(1))
        reader = _Line(line)
        reader.i = match.end()
        reader.skip_spaces()
        if not reader.peek() or reader.peek() == "#":
            out[key] = None
        else:
            out[key] = reader.value(flow=False)
        reader.end()
    return out


def deep_merge(dct: Dict[str, Any], merge_dct: Dict[str, Any]) -> None:
    """Recursively merge ``merge_dct`` into ``dct`` in place (override wins)."""
    for key, value in merge_dct.items():
        if key in dct and isinstance(dct[key], dict) and isinstance(value, dict):
            deep_merge(dct[key], value)
        else:
            dct[key] = value


def load_yaml(path: str) -> Dict[str, Any]:
    with open(path, "r") as f:
        loaded = safe_load(f.read())
    if loaded is not None and not isinstance(loaded, dict):
        raise ValueError(f"{path}: a config file must hold a mapping")
    return loaded or {}


def load_and_merge_yaml(base_filepath: str, override_filepath: str
                        ) -> Dict[str, Any]:
    """Load two YAML files and deep-merge (override file takes precedence)."""
    base_config = load_yaml(base_filepath)
    override_config = load_yaml(override_filepath)
    deep_merge(base_config, override_config)
    return base_config
