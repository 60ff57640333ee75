"""Parameter files: a YAML-subset reader + physical units.

Port of the reading half of ``cmacionize_tpu/utils/params.py`` (the getters
the drivers' ``from_params`` use).  Values are addressed by colon-separated
paths ("SimulationBox:anchor") and may carry unit strings ("5. pc",
"100. cm^-3").

The JAX reader takes the document structure from PyYAML; the port reads the
subset of YAML that the repository's ``.param`` files use, with no third-party
parser:

* block mappings nested by indentation (spaces only), ``key: value`` lines;
* flow lists ``[a, b, c]`` of scalars;
* ``#`` comments, whole-line or after whitespace;
* bare and quoted scalars, resolved as YAML 1.1 (PyYAML's ``safe_load``) does:
  booleans (true/yes/on, ...), decimal ints, floats with a decimal point,
  null, and strings for everything else -- so ``1e6`` stays a string, as in
  PyYAML, and is turned into a number only when read through ``get_int`` or
  ``get_number``.

Anything outside the subset (block sequences, anchors, multi-line scalars,
non-decimal ints) raises ``ValueError`` instead of being read differently.
"""

from __future__ import annotations

import re
from typing import Any, Optional, Sequence, Union

from cmacionize_torch.utils.units import parse_quantity

_MISSING = object()

_BOOL_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_BOOL_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT_RE = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# ints YAML 1.1 reads in another base (0b.., 0x.., leading-0 octal, a:b)
_OTHER_INT_RE = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"
)
_FLOAT_RE = re.compile(
    r"^(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$"
)
_SPECIAL_FLOATS = {
    **{s: float("inf") for s in ("+.inf", ".inf", "+.Inf", ".Inf", "+.INF", ".INF")},
    **{s: float("-inf") for s in ("-.inf", "-.Inf", "-.INF")},
    **{s: float("nan") for s in (".nan", ".NaN", ".NAN")},
}
_KEY_RE = re.compile(r"^([^:\s][^:]*?)\s*:(?:\s+(.*))?$")


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        ch = line[i]
        if quote:
            if ch == "\\" and quote == '"':
                i += 1  # skip the escaped character
            elif ch == quote == "'" and line[i + 1 : i + 2] == "'":
                i += 1  # '' is a quote inside a single-quoted scalar
            elif ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
        i += 1
    return line


def _unquote(text: str) -> Optional[str]:
    """The string inside matching quotes, or None if ``text`` is unquoted."""
    if len(text) >= 2 and text[0] == text[-1] == "'":
        return text[1:-1].replace("''", "'")
    if len(text) >= 2 and text[0] == text[-1] == '"':
        return text[1:-1].replace('\\"', '"').replace("\\\\", "\\")
    return None


def _resolve_scalar(text: str) -> Any:
    """A bare or quoted scalar → Python value, as YAML 1.1 resolves it."""
    text = text.strip()
    quoted = _unquote(text)
    if quoted is not None:
        return quoted
    if text[:1] in ("&", "*", "!", "|", ">", "{", "'", '"') or text in ("-", "?") or (
        text[:2] in ("- ", "? ")
    ):
        raise ValueError(f"unsupported YAML syntax in scalar {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL_TRUE:
        return True
    if text in _BOOL_FALSE:
        return False
    if _INT_RE.match(text):
        return int(text.replace("_", ""))
    if _OTHER_INT_RE.match(text):
        raise ValueError(f"unsupported non-decimal YAML int {text!r}")
    if _FLOAT_RE.match(text):
        return float(text.replace("_", ""))
    if text in _SPECIAL_FLOATS:
        return _SPECIAL_FLOATS[text]
    return text


def _resolve_value(text: str) -> Any:
    """A mapping value: a flow list of scalars or one scalar."""
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated flow list {text!r}")
        inner = text[1:-1].strip()
        if not inner:
            return []
        if "[" in inner or "{" in inner:
            raise ValueError(f"nested flow collections unsupported: {text!r}")
        return [_resolve_scalar(item) for item in inner.split(",")]
    return _resolve_scalar(text)


def parse_yaml_subset(text: str) -> dict:
    """Parse the block-mapping YAML subset of the parameter files → dict."""
    root: dict = {}
    # (indent, mapping) of the open mappings, innermost last
    stack = None
    # (mapping, key, indent) of a key with no inline value: an indented
    # mapping may follow, otherwise its value is null
    pending = None
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw).rstrip()
        body = line.lstrip(" ")
        if not body or body == "---":
            continue
        if body[0] == "\t":
            raise ValueError(f"line {lineno}: tab indentation is not YAML")
        indent = len(line) - len(body)
        if stack is None:
            stack = [(indent, root)]
        if pending is not None:
            mapping, key, key_indent = pending
            pending = None
            if indent > key_indent:
                mapping[key] = {}
                stack.append((indent, mapping[key]))
        while len(stack) > 1 and indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise ValueError(f"line {lineno}: inconsistent indentation")
        mo = _KEY_RE.match(body)
        if mo is None or body[:2] in ("- ", "? "):
            raise ValueError(f"line {lineno}: expected 'key: value', got {raw!r}")
        key = _unquote(mo.group(1)) or mo.group(1)
        mapping = stack[-1][1]
        if key in mapping:
            raise ValueError(f"line {lineno}: duplicate key {key!r}")
        value = (mo.group(2) or "").strip()
        mapping[key] = _resolve_value(value) if value else None
        if not value:
            pending = (mapping, key, indent)
    return root


def _coerce_number(value: Any) -> float:
    """Coerce YAML scalars to float, accepting "1e6"-style strings that
    YAML 1.1 parses as strings."""
    if isinstance(value, bool):
        raise ValueError(f"expected a number, got boolean {value!r}")
    if isinstance(value, (int, float)):
        return float(value)
    return float(str(value).strip())


def _coerce_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    text = str(value).strip().lower()
    if text in ("true", "yes", "on", "y", "1"):
        return True
    if text in ("false", "no", "off", "n", "0"):
        return False
    raise ValueError(f"cannot interpret {value!r} as a boolean")


class ParameterFile:
    """Typed, unit-aware access to a parameter tree."""

    def __init__(self, source: Union[str, dict, None] = None):
        if source is None:
            self._tree: dict = {}
            self.filename = None
        elif isinstance(source, dict):
            self._tree = source
            self.filename = None
        else:
            self.filename = source
            with open(source, "r") as handle:
                self._tree = parse_yaml_subset(handle.read())

    # ------------------------------------------------------------------ raw
    def _lookup(self, path: str):
        node = self._tree
        for part in path.split(":"):
            if not isinstance(node, dict) or part not in node:
                return _MISSING
            node = node[part]
        return node

    # ---------------------------------------------------------------- typed
    def get_value(self, path: str, default: Any = _MISSING) -> Any:
        """Raw value (string/number/bool/list), or ``default``."""
        value = self._lookup(path)
        if value is _MISSING:
            if default is _MISSING:
                raise KeyError(f"parameter {path!r} not found and no default given")
            value = default
        return value

    def get_number(self, path: str, default: Any = _MISSING) -> float:
        return _coerce_number(self.get_value(path, default))

    def get_int(self, path: str, default: Any = _MISSING) -> int:
        return int(self.get_number(path, default))

    def get_physical_value(
        self,
        path: str,
        quantity: Optional[str] = None,
        default: Any = _MISSING,
    ) -> float:
        """Value with units → SI float. ``default`` may itself carry units."""
        value = self.get_value(path, default)
        return parse_quantity(value, quantity)

    def get_physical_vector(
        self,
        path: str,
        quantity: Optional[str] = None,
        default: Any = _MISSING,
    ) -> Sequence[float]:
        value = self.get_value(path, default)
        if isinstance(value, str):
            value = [part.strip() for part in value.strip("[]").split(",")]
        return [parse_quantity(component, quantity) for component in value]

    def get_int_vector(self, path: str, default: Any = _MISSING):
        value = self.get_value(path, default)
        return [int(_coerce_number(component)) for component in value]

    def get_bool_vector(self, path: str, default: Any = _MISSING):
        value = self.get_value(path, default)
        return [_coerce_bool(component) for component in value]
