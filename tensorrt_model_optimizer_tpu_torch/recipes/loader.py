"""Typed YAML recipes with import composition and dotlist overrides (port of
`recipes/loader.py`).

 - schema-tagged YAML (a `# modelopt-schema: <name>` line);
 - `imports:` composition, a file path winning over the builtin recipe of
   the same name (`builtin/`, this package's own copy of JAX's 7 recipes);
 - dotlist overrides `key.sub=value`;
 - typed dataclasses (`PTQRecipe`, `QuantRecipe`, `CalibRecipe`).

The card's machine has no PyYAML, so recipes are read by `parse_yaml`, a
reader of the YAML subset recipes use: block mappings by indentation,
flow lists `[a, b]` and flow maps `{k: v}`, plain, single- and double-quoted
scalars typed as YAML 1.1 (PyYAML's `safe_load`) types them (null, bool,
decimal int, float, str), and `#` comments. Anything else (block lists,
anchors, tags, multi-line scalars, documents, other number forms) raises
`YamlSubsetError`.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Any, Optional

BUILTIN_ROOT = os.path.join(os.path.dirname(__file__), "builtin")
SCHEMA_TAG = "# modelopt-schema:"


class YamlSubsetError(ValueError):
    """The text lies outside the YAML subset `parse_yaml` reads."""


# YAML 1.1 implicit scalar types, as PyYAML's SafeLoader resolves them; a
# token that starts like a number and is no decimal int or float (010,
# 0x1F, 1_000, 1e-3, 1:30, .inf) is outside the subset
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^[-+]?(?:[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_NUMBERISH = re.compile(r"^[-+]?[0-9.]")
_UNSUPPORTED = ("&", "*", "!", "|", ">", "%", "@", "`")


def _plain_scalar(tok: str) -> Any:
    if _NULL.match(tok):
        return None
    if _BOOL.match(tok):
        return tok.lower() in ("yes", "true", "on")
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if _NUMBERISH.match(tok) or tok[0] in _UNSUPPORTED or tok.startswith("- ") or tok == "-":
        raise YamlSubsetError(f"unsupported YAML scalar {tok!r}")
    return tok


class _Flow:
    """Recursive-descent reader of one flow value (scalar, [..], {..})."""

    def __init__(self, text: str):
        self.s, self.i = text, 0

    def _ws(self):
        while self.i < len(self.s) and self.s[self.i] == " ":
            self.i += 1

    def value(self, stops: str) -> Any:
        self._ws()
        if self.i >= len(self.s):
            return None
        c = self.s[self.i]
        if c == "[":
            return self._seq()
        if c == "{":
            return self._map()
        if c in "'\"":
            return self._quoted()
        j = self.i
        while self.i < len(self.s) and self.s[self.i] not in stops:
            if self.s[self.i] == ":" and ":" in stops and (self.i + 1 == len(self.s) or self.s[self.i + 1] == " "):
                break
            self.i += 1
        return _plain_scalar(self.s[j: self.i].strip())

    def _quoted(self) -> str:
        q = self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(self.s):
                raise YamlSubsetError(f"unterminated quoted scalar in {self.s!r}")
            c = self.s[self.i]
            if q == "'" and c == "'":
                if self.s[self.i + 1: self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return "".join(out)
            if q == '"' and c == "\\":
                esc = self.s[self.i + 1: self.i + 2]
                if esc not in ('"', "\\", "n", "t", "/"):
                    raise YamlSubsetError(f"unsupported escape \\{esc} in {self.s!r}")
                out.append({"n": "\n", "t": "\t"}.get(esc, esc))
                self.i += 2
                continue
            if q == '"' and c == '"':
                self.i += 1
                return "".join(out)
            out.append(c)
            self.i += 1

    def _expect(self, c: str):
        self._ws()
        if self.i >= len(self.s) or self.s[self.i] != c:
            raise YamlSubsetError(f"expected {c!r} at {self.i} in {self.s!r}")
        self.i += 1

    def _seq(self) -> list:
        self.i += 1
        out = []
        self._ws()
        if self.s[self.i: self.i + 1] == "]":
            self.i += 1
            return out
        while True:
            out.append(self.value(",]"))
            self._ws()
            if self.s[self.i: self.i + 1] == ",":
                self.i += 1
                continue
            self._expect("]")
            return out

    def _map(self) -> dict:
        self.i += 1
        out = {}
        self._ws()
        if self.s[self.i: self.i + 1] == "}":
            self.i += 1
            return out
        while True:
            k = self.value(":,}")
            self._expect(":")
            out[k] = self.value(",}")
            self._ws()
            if self.s[self.i: self.i + 1] == ",":
                self.i += 1
                continue
            self._expect("}")
            return out

    def done(self) -> Any:
        self._ws()
        if self.i != len(self.s):
            raise YamlSubsetError(f"trailing text {self.s[self.i:]!r}")


def parse_value(text: str) -> Any:
    """One YAML value on one line: a scalar, a flow list or a flow map."""
    f = _Flow(text.strip())
    v = f.value("")
    f.done()
    return v


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (a `#` outside quotes, after a space)."""
    q = None
    for i, c in enumerate(line):
        if q:
            if c == q:
                q = None
        elif c in "'\"":
            q = c
        elif c == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip()
    return line.rstrip()


def _split_key(body: str) -> tuple[Any, str]:
    """'key: value' -> (key, value text); the key may be quoted."""
    f = _Flow(body)
    if body[:1] in "'\"":
        key = f._quoted()
    else:
        key = f.value(":")
        if key is None or isinstance(key, (list, dict)):
            raise YamlSubsetError(f"unsupported mapping key in {body!r}")
    if f.s[f.i: f.i + 1] != ":" or (f.i + 1 < len(f.s) and f.s[f.i + 1] != " "):
        raise YamlSubsetError(f"expected 'key: value', got {body!r}")
    return key, f.s[f.i + 1:].strip()


def parse_yaml(text: str) -> dict:
    """A YAML document of the recipes' subset -> dict (an empty one: {})."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError("tabs in indentation")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        if line.strip() in ("---", "..."):
            raise YamlSubsetError("multiple documents / markers are not read")
        lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return {}
    if len(lines) == 1 and lines[0][1][:1] in "[{":
        v = parse_value(lines[0][1])
        if not isinstance(v, dict):
            raise YamlSubsetError("a recipe is a mapping")
        return v
    pos = 0

    def block(indent: int) -> dict:
        nonlocal pos
        out: dict = {}
        while pos < len(lines):
            ind, body = lines[pos]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"unexpected indentation at {body!r}")
            if body.startswith("- ") or body == "-":
                raise YamlSubsetError(f"block sequences are not read: {body!r}")
            key, rest = _split_key(body)
            pos += 1
            if rest:
                out[key] = parse_value(rest)
            elif pos < len(lines) and lines[pos][0] > indent:
                out[key] = block(lines[pos][0])
            else:
                out[key] = None
        return out

    data = block(lines[0][0])
    if pos != len(lines):
        raise YamlSubsetError(f"unexpected dedent at {lines[pos][1]!r}")
    return data


@dataclasses.dataclass
class CalibRecipe:
    num_batches: int = 8
    batch_size: int = 2
    seq_len: int = 512
    data: Optional[str] = None
    tokenizer: Optional[str] = None


@dataclasses.dataclass
class QuantRecipe:
    preset: str = "FP8_DEFAULT_CFG"
    overrides: dict = dataclasses.field(default_factory=dict)
    auto_quantize_bits: Optional[float] = None


@dataclasses.dataclass
class PTQRecipe:
    model: str = "tiny"
    quant: QuantRecipe = dataclasses.field(default_factory=QuantRecipe)
    calib: CalibRecipe = dataclasses.field(default_factory=CalibRecipe)
    export_path: Optional[str] = None
    save_state: Optional[str] = None

    def resolve_quant_config(self):
        from ..quant.config import get_preset

        cfg = get_preset(self.quant.preset)
        if self.quant.overrides:
            cfg = cfg.with_rules(self.quant.overrides)
        return cfg


SCHEMAS = {"ptq-recipe/v1": PTQRecipe}


def _find(path: str) -> str:
    """A filesystem path wins; else the builtin recipe of that name."""
    if os.path.exists(path):
        return path
    builtin = os.path.join(BUILTIN_ROOT, path)
    if os.path.exists(builtin):
        return builtin
    raise FileNotFoundError(f"recipe {path!r} not found (also tried {builtin})")


def _read_yaml(path: str) -> tuple[dict, Optional[str]]:
    with open(path) as f:
        text = f.read()
    schema = None
    for line in text.splitlines():
        if line.strip().startswith(SCHEMA_TAG):
            schema = line.split(SCHEMA_TAG, 1)[1].strip()
            break
    return parse_yaml(text), schema


def _deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in over.items():
        out[k] = _deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def _resolve_imports(data: dict, base_dir: str) -> dict:
    imports = data.pop("imports", [])
    merged: dict = {}
    for imp in imports:
        p = imp if os.path.isabs(imp) else os.path.join(base_dir, imp)
        try:
            p = _find(p)
        except FileNotFoundError:
            p = _find(imp)
        sub, _ = _read_yaml(p)
        merged = _deep_merge(merged, _resolve_imports(sub, os.path.dirname(p)))
    return _deep_merge(merged, data)


def _parse_value(v: str) -> Any:
    try:
        return parse_value(v)
    except YamlSubsetError:
        return v


def apply_dotlist(data: dict, overrides: list[str]) -> dict:
    out = dict(data)
    for item in overrides:
        key, _, val = item.partition("=")
        parts = key.strip().split(".")
        node = out
        for p in parts[:-1]:
            nxt = node.get(p)
            node[p] = dict(nxt) if isinstance(nxt, dict) else {}
            node = node[p]
        node[parts[-1]] = _parse_value(val)
    return out


_NESTED = {"quant": QuantRecipe, "calib": CalibRecipe}


def _to_dataclass(cls, data: dict):
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        v = data[f.name]
        if f.name in _NESTED and isinstance(v, dict):
            v = _to_dataclass(_NESTED[f.name], v)
        kwargs[f.name] = v
    return cls(**kwargs)


def load_recipe(path: str, overrides: Optional[list[str]] = None):
    """Load a schema-tagged YAML recipe with imports and dotlist overrides."""
    p = _find(path)
    data, schema = _read_yaml(p)
    data = _resolve_imports(data, os.path.dirname(p))
    if overrides:
        data = apply_dotlist(data, overrides)
    if schema is None:
        raise ValueError(f"{path}: missing '{SCHEMA_TAG} <name>' header")
    if schema not in SCHEMAS:
        raise ValueError(f"{path}: unknown schema {schema!r} (known: {list(SCHEMAS)})")
    return _to_dataclass(SCHEMAS[schema], data)
