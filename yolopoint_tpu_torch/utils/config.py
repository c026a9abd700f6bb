"""Config files: the YAML subset of `configs/*.yaml`, read and written
without PyYAML.

Counterpart of `yolopoint_tpu/utils/config.py` (`dict_update`,
`load_config`, `resolve_sub_configs`, `save_config`, `get`). The machine
that runs the port has no PyYAML, so `parse_yaml` reads the subset the
repository's configs use, with the values PyYAML's `safe_load` gives them:

* block mappings and block sequences (`- item`, also at the parent key's
  indent, and `- key: value` items that open a mapping);
* flow sequences `[a, b]` and flow mappings `{k: v}`, nested;
* plain, single- and double-quoted scalars, `#` comments, empty documents;
* YAML 1.1 scalars as PyYAML resolves them: `~`, `null` and an empty value
  are None; `yes/no/on/off/true/false` (three casings) are booleans;
  integers in decimal, `0x`, `0b`, a leading-zero octal and with `_`;
  floats need a dot and a signed exponent (`1.0e-3` is a float, `1e-3` and
  `1.0e3` are strings), `.inf` and `.nan`; everything else is a string
  (`'0-62'` and `0-62` alike).

Anchors, aliases, tags, multi-line and block scalars, timestamps and
multiple documents are outside the subset and raise `ValueError`.
`save_config` writes the same subset, so that both `yaml.safe_load` and
`load_config` read back the dict it was given.
"""

from __future__ import annotations

import copy
import math
import re
from collections.abc import Mapping
from pathlib import Path
from typing import Any

_NULL = {"~", "null", "Null", "NULL", ""}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
# PyYAML's implicit resolvers (YAML 1.1)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")


def _sexagesimal(text: str, cast) -> Any:
    sign = -1 if text.startswith("-") else 1
    value = 0
    for part in text.lstrip("+-").split(":"):
        value = value * 60 + cast(part)
    return sign * value


def resolve_scalar(text: str) -> Any:
    """The value PyYAML's `safe_load` gives the plain scalar `text`."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        t = text.replace("_", "")
        if ":" in t:
            return _sexagesimal(t, int)
        sign = -1 if t.startswith("-") else 1
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
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return -math.inf if t.startswith("-") else math.inf
        if t.endswith(".nan"):
            return math.nan
        if ":" in t:
            return _sexagesimal(t, float)
        return float(t)
    if _TIMESTAMP.match(text):
        raise ValueError(f"YAML timestamps are outside the supported subset: {text!r}")
    return text


def _strip_comment(line: str) -> str:
    """`line` without a trailing `# comment` (a `#` at the start or after
    whitespace, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
            elif ch == "\\" and quote == '"':
                continue
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


class _Flow:
    """A recursive-descent reader of one flow or scalar value."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def error(self, what: str) -> ValueError:
        return ValueError(f"YAML: {what} at column {self.i} of {self.s!r}")

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, in_flow: bool) -> Any:
        self.skip()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            return self.quoted()
        if ch in "&*!|>%@`":
            raise self.error(f"unsupported YAML syntax {ch!r}")
        return resolve_scalar(self.plain(in_flow))

    def plain(self, in_flow: bool) -> str:
        start = self.i
        stops = ",]}" if in_flow else ""
        while self.i < len(self.s):
            ch = self.s[self.i]
            if ch in stops:
                break
            if ch == ":" and in_flow and (self.i + 1 == len(self.s) or self.s[self.i + 1] in " ,]}"):
                break
            self.i += 1
        return self.s[start:self.i].strip()

    def quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = self.s[self.i + 1:self.i + 2]
                simple = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/", "0": "\0",
                          "r": "\r", " ": " "}
                if esc in simple:
                    out.append(simple[esc])
                    self.i += 2
                    continue
                if esc in ("x", "u", "U"):
                    n = {"x": 2, "u": 4, "U": 8}[esc]
                    out.append(chr(int(self.s[self.i + 2:self.i + 2 + n], 16)))
                    self.i += 2 + n
                    continue
                raise self.error(f"unsupported escape \\{esc}")
            if q == '"' and ch == '"':
                self.i += 1
                return "".join(out)
            out.append(ch)
            self.i += 1
        raise self.error("unterminated quoted scalar")

    def key(self) -> Any:
        self.skip()
        if self.i < len(self.s) and self.s[self.i] in "'\"":
            return self.quoted()
        return resolve_scalar(self.plain(True))

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.i >= len(self.s):
                raise self.error("unterminated flow sequence")
            if self.s[self.i] == "]":
                self.i += 1
                return out
            out.append(self.value(True))
            self.skip()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "]":
                raise self.error("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip()
            if self.i >= len(self.s):
                raise self.error("unterminated flow mapping")
            if self.s[self.i] == "}":
                self.i += 1
                return out
            k = self.key()
            self.skip()
            if self.i < len(self.s) and self.s[self.i] == ":":
                self.i += 1
                out[k] = self.value(True)
            else:
                out[k] = None
            self.skip()
            if self.i < len(self.s) and self.s[self.i] == ",":
                self.i += 1
            elif self.i < len(self.s) and self.s[self.i] != "}":
                raise self.error("expected ',' or '}'")


def _inline_value(text: str) -> Any:
    """A value written on one line after `key:` or `- `."""
    f = _Flow(text)
    v = f.value(False)
    f.skip()
    if f.i != len(f.s):
        raise f.error("trailing characters")
    return v


def _split_key(text: str):
    """`(key, rest)` for a `key: rest` line, else None."""
    f = _Flow(text)
    if text[:1] in "'\"":
        k = f.quoted()
    else:
        m = re.match(r"^([^#'\"{}\[\],][^#]*?)\s*:(?:\s|$)", text)
        if not m or text.startswith("- ") or text == "-":
            return None
        k = resolve_scalar(m.group(1))
        f.i = m.end(1)
    f.skip()
    if f.i >= len(text) or text[f.i] != ":":
        return None
    rest = text[f.i + 1:]
    if rest and rest[0] not in " \t":
        return None
    return k, rest.strip()


def _flow_depth(text: str) -> int:
    """Open `[`/`{` minus closed ones in `text`, outside quotes."""
    depth, quote = 0, None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " [{,:"):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
    return depth


class _Block:
    def __init__(self, text: str):
        self.lines: list[tuple[int, str]] = []
        pending = None  # a flow collection continued on the next lines
        for raw in text.splitlines():
            line = _strip_comment(raw)
            if pending is not None:
                pending = (pending[0], pending[1] + " " + line.strip())
                if _flow_depth(pending[1]) <= 0:
                    self.lines.append(pending)
                    pending = None
                continue
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                raise ValueError("YAML: tabs in indentation")
            if line.strip() in ("---", "..."):
                if self.lines:
                    raise ValueError("YAML: multiple documents are outside the supported subset")
                continue
            if line.strip():
                entry = (len(line) - len(line.lstrip(" ")), line.strip())
                if _flow_depth(entry[1]) > 0:
                    pending = entry
                else:
                    self.lines.append(entry)
        if pending is not None:
            raise ValueError(f"YAML: unterminated flow collection {pending[1]!r}")
        self.i = 0

    def parse(self) -> Any:
        if not self.lines:
            return None
        value = self.node(self.lines[0][0])
        if self.i != len(self.lines):
            raise ValueError(f"YAML: unexpected indentation at {self.lines[self.i][1]!r}")
        return value

    def node(self, indent: int) -> Any:
        ind, text = self.lines[self.i]
        if text == "-" or text.startswith("- "):
            return self.sequence(ind)
        if _split_key(text) is not None:
            return self.mapping(ind)
        self.i += 1
        return _inline_value(text)

    def child(self, parent_indent: int, allow_same_indent_seq: bool) -> Any:
        """The block under a `key:` or `-` with nothing after it."""
        if self.i >= len(self.lines):
            return None
        ind, text = self.lines[self.i]
        if ind > parent_indent:
            return self.node(ind)
        if allow_same_indent_seq and ind == parent_indent and (text == "-" or text.startswith("- ")):
            return self.sequence(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise ValueError(f"YAML: unexpected indentation at {text!r}")
            if text == "-" or text.startswith("- "):
                break
            kv = _split_key(text)
            if kv is None:
                raise ValueError(f"YAML: expected 'key: value' at {text!r}")
            k, rest = kv
            self.i += 1
            out[k] = _inline_value(rest) if rest else self.child(indent, True)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while self.i < len(self.lines):
            ind, text = self.lines[self.i]
            if ind != indent or not (text == "-" or text.startswith("- ")):
                if ind > indent:
                    raise ValueError(f"YAML: unexpected indentation at {text!r}")
                break
            rest = text[1:].strip()
            if not rest:
                self.i += 1
                out.append(self.child(indent, False))
                continue
            item_indent = indent + (len(text) - len(text[1:].lstrip()))
            if _split_key(rest) is not None or rest == "-" or rest.startswith("- "):
                # `- key: v` opens a mapping (or `- - x` a sequence) at the item's column
                self.lines[self.i] = (item_indent, rest)
                out.append(self.node(item_indent))
            else:
                self.i += 1
                out.append(_inline_value(rest))
        return out


def parse_yaml(text: str) -> Any:
    """`yaml.safe_load(text)` for the subset described in the module docstring."""
    return _Block(text).parse()


def dict_update(d: dict, u: Mapping) -> dict:
    """Recursive dict merge (update wins); mutates and returns `d`."""
    for k, v in u.items():
        if isinstance(v, Mapping):
            d[k] = dict_update(d.get(k, {}) or {}, v)
        else:
            d[k] = v
    return d


def load_config(path: str | Path, overrides: Mapping | None = None) -> dict:
    """Read a YAML config and apply overrides."""
    cfg = parse_yaml(Path(path).read_text()) or {}
    if overrides:
        dict_update(cfg, overrides)
    return cfg


def resolve_sub_configs(cfg: dict, config_dir: str | Path) -> list[dict]:
    """Expand a `sub_configs` composite into per-dataset configs: each entry
    of `data.sub_configs` names a YAML file (relative to `config_dir`) plus
    overrides; the parent config is the base."""
    data = cfg.get("data", {})
    subs = data.get("sub_configs")
    if not subs:
        return [cfg]
    out = []
    for entry in subs:
        if isinstance(entry, str):
            sub_path, sub_over = entry, {}
        else:
            sub_path, sub_over = entry["config"], entry.get("overrides", {})
        sub = load_config(Path(config_dir) / sub_path)
        merged = copy.deepcopy(cfg)
        merged.pop("data", None)
        merged["data"] = sub.get("data", {})
        dict_update(merged, {k: v for k, v in sub.items() if k != "data"})
        dict_update(merged, sub_over)
        out.append(merged)
    return out


def _dump_scalar(v: Any) -> str:
    if v is None:
        return "null"
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        if "e" in text and text[text.index("e") + 1] not in "+-":
            text = text.replace("e", "e+", 1)
        return text
    if isinstance(v, str):
        plain_ok = (
            v and v == v.strip() and resolve_scalar(v) == v and not _needs_quotes(v))
        if plain_ok:
            return v
        if any(ord(c) < 32 or ord(c) == 127 for c in v) or "\\" in v:
            return '"' + "".join(
                {"\\": "\\\\", '"': '\\"', "\n": "\\n", "\r": "\\r", "\t": "\\t"}.get(c, c)
                if c in '\\"\n\r\t' or ord(c) >= 32 else f"\\x{ord(c):02x}" for c in v) + '"'
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"save_config: cannot write a {type(v).__name__} ({v!r})")


def _needs_quotes(v: str) -> bool:
    return (v[0] in "-?:,[]{}#&*!|>'\"%@`" or ": " in v or " #" in v or v.endswith(":")
            or any(ord(c) < 32 or ord(c) == 127 for c in v)
            or any(c in v for c in ",[]{}") or _TIMESTAMP.match(v) is not None)


def dump_yaml(value: Any) -> str:
    """`value` (dicts, lists and scalars) as YAML of the subset `parse_yaml` reads."""
    lines: list[str] = []

    def emit(v: Any, indent: int) -> None:
        pad = " " * indent
        if isinstance(v, Mapping):
            for k, item in v.items():
                key = _dump_scalar(k)
                if isinstance(item, Mapping) and item:
                    lines.append(f"{pad}{key}:")
                    emit(item, indent + 2)
                elif isinstance(item, (list, tuple)) and item:
                    lines.append(f"{pad}{key}:")
                    emit(list(item), indent)
                else:
                    lines.append(f"{pad}{key}: {inline(item)}")
        else:
            for item in v:
                if isinstance(item, Mapping) and item:
                    first = len(lines)
                    emit(item, indent + 2)
                    lines[first] = pad + "- " + lines[first][indent + 2:]
                elif isinstance(item, (list, tuple)) and item:
                    first = len(lines)
                    emit(list(item), indent + 2)
                    lines[first] = pad + "- " + lines[first][indent + 2:]
                else:
                    lines.append(f"{pad}- {inline(item)}")

    def inline(item: Any) -> str:
        if isinstance(item, Mapping):
            return "{}"
        if isinstance(item, (list, tuple)):
            return "[]"
        return _dump_scalar(item)

    if isinstance(value, (Mapping, list, tuple)) and value:
        emit(value, 0)
    else:
        lines.append(inline(value))
    return "\n".join(lines) + "\n"


def save_config(cfg: dict, path: str | Path) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(dump_yaml(cfg))


def get(cfg: Mapping, dotted: str, default: Any = None) -> Any:
    """`get(cfg, 'model.superpoint.nms', 4)` — dotted access with default."""
    node: Any = cfg
    for part in dotted.split("."):
        if not isinstance(node, Mapping) or part not in node:
            return default
        node = node[part]
    return node
