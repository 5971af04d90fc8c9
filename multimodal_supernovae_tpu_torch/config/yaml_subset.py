"""The part of YAML that the repository's files use, read without PyYAML.

The GPU host has no PyYAML, so the port reads ``configs/*.yaml`` and a run
directory's ``config.yaml`` with this module. ``safe_load`` gives what
PyYAML's ``yaml.safe_load`` gives on the constructs it knows:

  * block mappings and block sequences (a sequence may sit at its key's
    indent, as PyYAML writes it), nested by indentation of spaces;
  * flow sequences ``[a, b]`` and flow mappings ``{a: 1}``, nested, over
    several lines;
  * comments, plain scalars and single- or double-quoted scalars (double
    quotes take JSON's escapes);
  * plain scalars typed as YAML 1.1's resolver types them: ``5.0e-05`` is a
    float but ``1e-4`` (no dot) is a string, ``true``/``yes``/``on`` and
    their opposites are bools, ``null``/``~``/empty is None, ``0x1f``,
    ``0o``-less octal ``017`` and ``0b101`` are ints.

Anything else raises ``YAMLSubsetError`` with its line: anchors, aliases,
tags, block scalars (``|``, ``>``), multi-line plain or quoted scalars,
complex keys, mappings inside block sequence items, document markers and
directives, timestamps, duplicate keys. It never guesses.

``dump`` writes the other way: a JSON document (JSON is valid YAML) whose
floats carry a dot in their mantissa, so that PyYAML's YAML 1.1 resolver
reads them back as floats (``1e-05`` would be a string to it), and which
refuses non-finite floats (JSON has no spelling for them that YAML reads).
"""

from __future__ import annotations

import bisect
import json
import math
import numbers
import re
from typing import Any, List, Tuple

__all__ = ["YAMLSubsetError", "dump", "load", "safe_load"]


class YAMLSubsetError(ValueError):
    """A construct outside the subset, or a malformed document."""


# YAML 1.1's implicit resolvers, as PyYAML's resolver.py defines them
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_UNSUPPORTED_START = "&*!|>%@`"
_FLOW_STOP = ",[]{}"


def _fail(line: int, msg: str):
    raise YAMLSubsetError(f"line {line + 1}: {msg}")


def _resolve(text: str, line: int) -> Any:
    """A plain scalar typed as PyYAML's SafeLoader types it."""
    if _BOOL.match(text):
        return text in _TRUE
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        sign = -1.0 if value[0] == "-" else 1.0
        value = value.lstrip("+-")
        if ":" in value:
            _fail(line, f"sexagesimal number {text!r} is not supported")
        if value == ".inf":
            return sign * math.inf
        if value == ".nan":
            return math.nan
        return sign * float(value)
    if _INT.match(text):
        value = text.replace("_", "")
        sign = -1 if value[0] == "-" else 1
        value = value.lstrip("+-")
        if ":" in value:
            _fail(line, f"sexagesimal number {text!r} is not supported")
        if value == "0":
            return 0
        if value.startswith("0b"):
            return sign * int(value[2:], 2)
        if value.startswith("0x"):
            return sign * int(value[2:], 16)
        if value[0] == "0":
            return sign * int(value, 8)
        return sign * int(value)
    if _NULL.match(text):
        return None
    if _TIMESTAMP.match(text):
        _fail(line, f"timestamp {text!r} is not supported")
    if text in ("<<", "="):
        _fail(line, f"{text!r} (merge or value key) is not supported")
    return text


class _Text:
    """The document as one string, and the line of a position in it."""

    def __init__(self, s: str):
        self.s = s
        self._starts = [0] + [m.end() for m in re.finditer("\n", s)]

    def line(self, pos: int) -> int:
        return bisect.bisect_right(self._starts, pos) - 1

    def fail(self, pos: int, msg: str):
        _fail(self.line(pos), msg)


def _quoted(t: _Text, pos: int) -> Tuple[str, int]:
    """The quoted scalar that starts at ``pos``; returns (value, end)."""
    s, quote = t.s, t.s[pos]
    i = pos + 1
    while True:
        if i >= len(s) or s[i] == "\n":
            t.fail(pos, "a quoted scalar must end on its line")
        if quote == '"' and s[i] == "\\":
            i += 2
            continue
        if s[i] == quote:
            if quote == "'" and s.startswith("''", i):
                i += 2
                continue
            break
        i += 1
    body = s[pos:i + 1]
    if quote == "'":
        return body[1:-1].replace("''", "'"), i + 1
    try:
        return json.loads(body), i + 1
    except json.JSONDecodeError as e:
        t.fail(pos, f"double-quoted scalar outside the subset (JSON escapes only): {e}")


def _plain_end(s: str, pos: int, flow: bool) -> int:
    """End of the plain scalar at ``pos``: a comment, the line's end, ': ' and,
    in a flow collection, one of ``,[]{}`` or ':' before one of them."""
    i = pos
    while i < len(s) and s[i] != "\n":
        c = s[i]
        nxt = s[i + 1] if i + 1 < len(s) else "\n"
        if c == "#" and i > pos and s[i - 1] in " \t":
            break
        if c == ":" and (nxt in " \t\n" or (flow and nxt in _FLOW_STOP)):
            break
        if flow and c in _FLOW_STOP:
            break
        i += 1
    return i


def _check_plain_start(t: _Text, pos: int, flow: bool):
    s = t.s
    c = s[pos]
    nxt = s[pos + 1] if pos + 1 < len(s) else "\n"
    if c in _UNSUPPORTED_START:
        t.fail(pos, f"{c!r} (anchor, alias, tag, block scalar or reserved) is not supported")
    if c in "-?:" and (nxt in " \t\n" or (flow and nxt in _FLOW_STOP)):
        t.fail(pos, f"{c!r} indicator here is not supported")
    if c in _FLOW_STOP or c == "#":
        t.fail(pos, f"a plain scalar cannot start with {c!r}")


def _skip_space(t: _Text, pos: int, newlines: bool) -> int:
    """Skip spaces (and, in a flow collection, line breaks and comments)."""
    s = t.s
    while pos < len(s):
        c = s[pos]
        if c in " \t" or (newlines and c == "\n"):
            pos += 1
        elif newlines and c == "#" and (pos == 0 or s[pos - 1] in " \t\n"):
            while pos < len(s) and s[pos] != "\n":
                pos += 1
        else:
            break
    return pos


def _flow_scalar(t: _Text, pos: int) -> Tuple[Any, int]:
    if t.s[pos] in "'\"":
        return _quoted(t, pos)
    _check_plain_start(t, pos, flow=True)
    end = _plain_end(t.s, pos, flow=True)
    if end < len(t.s) and t.s[end] == "\n":
        nxt = _skip_space(t, end, True)
        if nxt < len(t.s) and t.s[nxt] not in ",]}:":
            t.fail(pos, "a multi-line plain scalar is not supported")
    return _resolve(t.s[pos:end].rstrip(" \t"), t.line(pos)), end


def _flow_node(t: _Text, pos: int) -> Tuple[Any, int]:
    """A flow node at ``pos``; returns (value, position after it)."""
    pos = _skip_space(t, pos, True)
    if pos >= len(t.s):
        t.fail(pos - 1, "unexpected end of a flow collection")
    c = t.s[pos]
    if c not in "[{":
        return _flow_scalar(t, pos)
    close = "]" if c == "[" else "}"
    out: Any = [] if c == "[" else {}
    pos += 1
    while True:
        pos = _skip_space(t, pos, True)
        if pos >= len(t.s):
            t.fail(pos - 1, f"{close!r} expected")
        if t.s[pos] == close:
            return out, pos + 1
        start = pos
        item, pos = _flow_node(t, pos)
        pos = _skip_space(t, pos, True)
        if pos < len(t.s) and t.s[pos] == ":":
            if c == "[":
                t.fail(start, "a mapping inside a flow sequence is not supported")
            if isinstance(item, (list, dict)):
                t.fail(start, "a collection as a key is not supported")
            value, pos = _flow_node(t, pos + 1)
            if item in out:
                t.fail(start, f"duplicate key {item!r}")
            out[item] = value
        elif c == "{":
            t.fail(start, "a flow mapping entry needs ':'")
        else:
            out.append(item)
        pos = _skip_space(t, pos, True)
        if pos < len(t.s) and t.s[pos] == ",":
            pos += 1
        elif pos >= len(t.s) or t.s[pos] != close:
            t.fail(pos if pos < len(t.s) else pos - 1, f"',' or {close!r} expected")


class _Block:
    """Recursive descent over the block structure, one logical line at a
    time; flow collections are handed to ``_flow_node`` on the same text."""

    def __init__(self, text: str):
        text = text.replace("\r\n", "\n")
        if "\r" in text:
            raise YAMLSubsetError("a carriage return outside a CRLF line end")
        self.t = _Text(text)
        self.lines: List[Tuple[int, int]] = []  # (position of content, indent)
        pos = 0
        for no, raw in enumerate(text.split("\n")):
            body = raw.rstrip(" \t")
            stripped = body.lstrip(" ")
            indent = len(body) - len(stripped)
            if stripped and not stripped.startswith("#"):
                if stripped[0] == "\t":
                    _fail(no, "a tab in indentation is not supported")
                if stripped.startswith(("---", "...", "%")):
                    _fail(no, "document markers and directives are not supported")
                self.lines.append((pos + indent, indent))
            pos += len(raw) + 1
        self.i = 0  # the next logical line

    def _skip_lines_before(self, pos: int):
        while self.i < len(self.lines) and self.lines[self.i][0] < pos:
            self.i += 1

    def _end_of_line(self, pos: int):
        """After a value: only spaces and a comment may follow on its line."""
        s = self.t.s
        pos = _skip_space(self.t, pos, False)
        if pos < len(s) and s[pos] != "\n":
            if not (s[pos] == "#" and s[pos - 1] in " \t"):
                self.t.fail(pos, f"unexpected {s[pos:pos + 20]!r} after a value")
        self._skip_lines_before(pos + 1)

    def _key(self, pos: int):
        """(key, position after ': ') when a mapping key starts at ``pos``,
        else None."""
        s, t = self.t.s, self.t
        if s[pos] in "'\"":
            key, end = _quoted(t, pos)
        else:
            if s[pos] in "[{":
                return None
            end = _plain_end(s, pos, flow=False)
            if end >= len(s) or s[end] != ":":
                return None
            _check_plain_start(t, pos, flow=False)
            key = _resolve(s[pos:end].rstrip(" \t"), t.line(pos))
        end = _skip_space(t, end, False)
        if end < len(s) and s[end] == ":" and (end + 1 >= len(s) or s[end + 1] in " \n"):
            return key, end + 1
        return None

    def node(self, parent_indent: int) -> Any:
        """The block node at the current line, indented past ``parent_indent``."""
        pos, indent = self.lines[self.i]
        if indent <= parent_indent:
            return None
        if self._is_item(pos):
            return self.sequence(indent)
        if self._key(pos) is not None:
            return self.mapping(indent)
        return self.inline(pos, parent_indent)

    def _is_item(self, pos: int) -> bool:
        s = self.t.s
        return s[pos] == "-" and (pos + 1 >= len(s) or s[pos + 1] in " \t\n")

    def inline(self, pos: int, parent_indent: int) -> Any:
        """A value that starts on a line at ``pos``: flow, quoted or plain."""
        s, t = self.t.s, self.t
        if s[pos] in "[{":
            value, end = _flow_node(t, pos)
        elif s[pos] in "'\"":
            value, end = _quoted(t, pos)
        else:
            _check_plain_start(t, pos, flow=False)
            end = _plain_end(s, pos, flow=False)
            if end < len(s) and s[end] == ":":
                t.fail(pos, "a mapping is not allowed here")
            value = _resolve(s[pos:end].rstrip(" \t"), t.line(pos))
        self._end_of_line(end)
        if self.i < len(self.lines) and self.lines[self.i][1] > parent_indent:
            t.fail(self.lines[self.i][0], "a multi-line scalar or unexpected indentation "
                   "is not supported")
        return value

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            pos, ind = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                self.t.fail(pos, "unexpected indentation")
            found = self._key(pos)
            if found is None:
                if self._is_item(pos):
                    self.t.fail(pos, "a sequence item where a mapping key was expected")
                self.t.fail(pos, "a mapping key ('key: value') was expected")
            key, after = found
            if isinstance(key, (list, dict)):
                self.t.fail(pos, "a collection as a key is not supported")
            if key in out:
                self.t.fail(pos, f"duplicate key {key!r}")
            after = _skip_space(self.t, after, False)
            s = self.t.s
            if after >= len(s) or s[after] in "\n#":
                self._end_of_line(after)
                if self.i < len(self.lines):
                    npos, nind = self.lines[self.i]
                    if nind > indent or (nind == indent and self._is_item(npos)):
                        out[key] = (self.node(indent) if nind > indent
                                    else self.sequence(indent))
                        continue
                out[key] = None
            else:
                out[key] = self.inline(after, indent)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            pos, ind = self.lines[self.i]
            if ind != indent or not self._is_item(pos):
                if ind > indent:
                    self.t.fail(pos, "unexpected indentation")
                break
            after = _skip_space(self.t, pos + 1, False)
            s = self.t.s
            if after >= len(s) or s[after] in "\n#":
                self._end_of_line(after)
                if self.i < len(self.lines) and self.lines[self.i][1] > indent:
                    out.append(self.node(indent))
                else:
                    out.append(None)
                continue
            if self._is_item(after):
                self.t.fail(after, "a sequence inside a sequence item is not supported")
            if self._key(after) is not None:
                self.t.fail(after, "a mapping inside a sequence item is not supported")
            out.append(self.inline(after, indent))
        return out


def safe_load(text: str) -> Any:
    """Parse ``text`` as PyYAML's ``safe_load`` would, or raise
    ``YAMLSubsetError`` for a construct outside the subset."""
    block = _Block(text)
    if not block.lines:
        return None
    value = block.node(-1)
    if block.i != len(block.lines):
        block.t.fail(block.lines[block.i][0], "unexpected content after the document")
    return value


def load(path: str) -> Any:
    """``safe_load`` of a file."""
    with open(path) as f:
        return safe_load(f.read())


def _scalar(obj: Any) -> str:
    if obj is None:
        return "null"
    if isinstance(obj, bool):
        return "true" if obj else "false"
    if isinstance(obj, numbers.Integral):
        return str(int(obj))
    if isinstance(obj, numbers.Real):
        f = float(obj)
        if not math.isfinite(f):
            raise ValueError(f"non-finite float {f!r}: YAML cannot read it back from JSON")
        text = repr(f)
        if "e" in text and "." not in text:  # 1e-05: a string to YAML 1.1
            mantissa, exponent = text.split("e")
            text = f"{mantissa}.0e{exponent}"
        return text
    if isinstance(obj, str):
        return json.dumps(obj)
    raise TypeError(f"cannot write {type(obj).__name__} {obj!r}")


def _value(obj: Any) -> str:
    if isinstance(obj, dict):
        return "{" + ", ".join(f"{_key(k)}: {_value(v)}" for k, v in obj.items()) + "}"
    if isinstance(obj, (list, tuple)):
        return "[" + ", ".join(_value(v) for v in obj) + "]"
    return _scalar(obj)


def _key(key: Any) -> str:
    if not isinstance(key, str):
        raise TypeError(f"mapping keys must be strings, got {key!r}")
    return json.dumps(key)


def dump(mapping: dict) -> str:
    """``mapping`` as a JSON document, one top-level key a line, sorted (as
    ``yaml.safe_dump`` sorts), that ``yaml.safe_load`` and ``safe_load`` read
    back to it; tuples come back as lists."""
    rows = [f" {_key(k)}: {_value(mapping[k])}" for k in sorted(mapping)]
    return "{\n" + ",\n".join(rows) + "\n}\n"
