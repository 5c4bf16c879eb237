"""Layered HOCON-subset configuration system.

Mirrors the reference's Typesafe-Config usage (framework/oryx-common
.../settings/ConfigUtils.java:59-154): packaged `reference.conf` defaults are
overlaid by a user config file, which tests overlay again with key/value maps
(`ConfigUtils.overlayOn`). Configs serialize to a string so they can cross
process boundaries (`ConfigUtils.serialize/deserialize`), and pretty-print
with secrets redacted (`ConfigUtils.prettyPrint` redacts keystore passwords).

The parser supports the HOCON subset the reference's conf files actually use
(see app/conf/als-example.conf): `#`/`//` comments, nested objects with
braces, dotted keys, `=` or `:` separators, lists, quoted/unquoted scalars,
and `${path}` substitution.
"""

from __future__ import annotations

import json
import re
from typing import Any, Iterable, Mapping


class ConfigError(Exception):
    """Raised for missing/mistyped keys or parse failures."""


_SECRET_RE = re.compile(r"(password|secret|token)", re.IGNORECASE)


def _parse_scalar(tok: str) -> Any:
    t = tok.strip()
    if t.startswith('"') and t.endswith('"') and len(t) >= 2:
        return t[1:-1]
    low = t.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("null", "none"):
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t


class _Parser:
    """Line-oriented HOCON-subset parser producing a nested dict."""

    def __init__(self, text: str):
        self.tokens = self._strip_comments(text)
        self.pos = 0

    @staticmethod
    def _strip_comments(text: str) -> str:
        out_lines = []
        for line in text.splitlines():
            buf = []
            in_str = False
            i = 0
            while i < len(line):
                c = line[i]
                if c == '"':
                    in_str = not in_str
                    buf.append(c)
                elif not in_str and c == "#":
                    break
                elif not in_str and c == "/" and i + 1 < len(line) and line[i + 1] == "/":
                    break
                else:
                    buf.append(c)
                i += 1
            out_lines.append("".join(buf))
        return "\n".join(out_lines)

    def parse(self) -> dict:
        root: dict = {}
        self._parse_object_body(root, top=True)
        return root

    def _skip_ws(self) -> None:
        while self.pos < len(self.tokens) and self.tokens[self.pos] in " \t\r\n,":
            self.pos += 1

    def _peek(self) -> str:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else ""

    def _read_key(self) -> str:
        self._skip_ws()
        start = self.pos
        if self._peek() == '"':
            self.pos += 1
            while self.pos < len(self.tokens) and self.tokens[self.pos] != '"':
                self.pos += 1
            key = self.tokens[start + 1 : self.pos]
            self.pos += 1
            return key
        while self.pos < len(self.tokens) and self.tokens[self.pos] not in " \t\r\n=:{":
            self.pos += 1
        return self.tokens[start : self.pos].strip()

    def _parse_object_body(self, into: dict, top: bool = False) -> None:
        while True:
            self._skip_ws()
            if self.pos >= len(self.tokens):
                if not top:
                    raise ConfigError("unexpected end of config inside object")
                return
            if self._peek() == "}":
                if top:
                    raise ConfigError("unbalanced '}'")
                self.pos += 1
                return
            key = self._read_key()
            if not key:
                raise ConfigError(f"empty key near offset {self.pos}")
            self._skip_ws()
            c = self._peek()
            if c in "=:":
                self.pos += 1
                self._skip_ws()
                c = self._peek()
            if c == "{":
                self.pos += 1
                child: dict = {}
                self._parse_object_body(child)
                self._merge_path(into, key, child)
            elif c == "[":
                self._merge_path(into, key, self._parse_list())
            else:
                self._merge_path(into, key, self._parse_value_scalar())

    def _parse_list(self) -> list:
        assert self._peek() == "["
        self.pos += 1
        items: list = []
        while True:
            self._skip_ws()
            c = self._peek()
            if c == "":
                raise ConfigError("unexpected end of config inside list")
            if c == "]":
                self.pos += 1
                return items
            if c == "{":
                self.pos += 1
                child: dict = {}
                self._parse_object_body(child)
                items.append(child)
            elif c == "[":
                items.append(self._parse_list())
            else:
                start = self.pos
                in_str = False
                while self.pos < len(self.tokens):
                    ch = self.tokens[self.pos]
                    if ch == '"':
                        in_str = not in_str
                    elif not in_str and ch in ",]\n":
                        break
                    self.pos += 1
                items.append(_parse_scalar(self.tokens[start : self.pos]))

    def _parse_value_scalar(self) -> Any:
        start = self.pos
        in_str = False
        in_subst = False
        while self.pos < len(self.tokens):
            ch = self.tokens[self.pos]
            if ch == '"':
                in_str = not in_str
            elif not in_str and ch == "$" and self.tokens[self.pos : self.pos + 2] == "${":
                in_subst = True
            elif not in_str and in_subst and ch == "}":
                in_subst = False
            elif not in_str and not in_subst and ch in ",\n}":
                break
            self.pos += 1
        return _parse_scalar(self.tokens[start : self.pos])

    @staticmethod
    def _merge_path(into: dict, dotted: str, value: Any) -> None:
        parts = dotted.split(".")
        d = into
        for p in parts[:-1]:
            nxt = d.get(p)
            if not isinstance(nxt, dict):
                nxt = {}
                d[p] = nxt
            d = nxt
        leaf = parts[-1]
        if isinstance(value, dict) and isinstance(d.get(leaf), dict):
            _deep_merge(d[leaf], value)
        else:
            d[leaf] = value


def _deep_merge(base: dict, over: Mapping) -> dict:
    for k, v in over.items():
        if isinstance(v, Mapping) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v if not isinstance(v, Mapping) else dict(v)
    return base


_SUBST_RE = re.compile(r"\$\{([^}]+)\}")


def _resolve_substitutions(root: dict) -> None:
    """Resolve ${a.b.c} references (possibly chained) against the root."""

    def lookup(path: str) -> Any:
        d: Any = root
        for p in path.split("."):
            if not isinstance(d, dict) or p not in d:
                raise ConfigError(f"unresolved substitution ${{{path}}}")
            d = d[p]
        return d

    def resolve(value: Any, depth: int = 0) -> Any:
        if depth > 16:
            raise ConfigError("substitution cycle detected")
        if isinstance(value, str):
            m = _SUBST_RE.fullmatch(value.strip())
            if m:
                return resolve(lookup(m.group(1)), depth + 1)
            return _SUBST_RE.sub(lambda m: str(resolve(lookup(m.group(1)), depth + 1)), value)
        if isinstance(value, dict):
            return {k: resolve(v, depth) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, depth) for v in value]
        return value

    for k in list(root.keys()):
        root[k] = resolve(root[k])


class Config:
    """Immutable view over a nested dict with typed dotted-path access."""

    def __init__(self, data: Mapping | None = None):
        self._data: dict = dict(data or {})

    # -- access ------------------------------------------------------------

    def _lookup(self, path: str) -> Any:
        d: Any = self._data
        for p in path.split("."):
            if not isinstance(d, dict) or p not in d:
                raise ConfigError(f"missing config key: {path}")
            d = d[p]
        return d

    def has(self, path: str) -> bool:
        try:
            self._lookup(path)
            return True
        except ConfigError:
            return False

    def get(self, path: str, default: Any = ...) -> Any:
        try:
            v = self._lookup(path)
        except ConfigError:
            if default is ...:
                raise
            return default
        return v

    def get_string(self, path: str, default: Any = ...) -> str | None:
        v = self.get(path, default)
        return None if v is None else str(v)

    def get_int(self, path: str, default: Any = ...) -> int:
        v = self.get(path, default)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(f"{path} is not a number: {v!r}")
        return int(v)

    def get_float(self, path: str, default: Any = ...) -> float:
        v = self.get(path, default)
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            raise ConfigError(f"{path} is not a number: {v!r}")
        return float(v)

    def get_bool(self, path: str, default: Any = ...) -> bool:
        v = self.get(path, default)
        if not isinstance(v, bool):
            raise ConfigError(f"{path} is not a bool: {v!r}")
        return v

    def get_list(self, path: str, default: Any = ...) -> list:
        v = self.get(path, default)
        if v is None:
            return []
        if not isinstance(v, list):
            return [v]
        return v

    def get_config(self, path: str) -> "Config":
        v = self._lookup(path)
        if not isinstance(v, dict):
            raise ConfigError(f"{path} is not an object")
        return Config(v)

    def as_dict(self) -> dict:
        return json.loads(json.dumps(self._data))

    def keys(self) -> Iterable[str]:
        return self._data.keys()

    # -- layering ----------------------------------------------------------

    def overlay(self, over: "Mapping | Config") -> "Config":
        """Deep-merge `over` on top of this config; dotted keys expand.

        Mirrors ConfigUtils.overlayOn (reference ConfigUtils.java:69-79),
        which tests use to inject per-test settings over the defaults.
        """
        if isinstance(over, Config):
            over = over._data
        base = self.as_dict()
        expanded: dict = {}
        for k, v in over.items():
            _Parser._merge_path(expanded, k, v if not isinstance(v, Mapping) else dict(v))
        _deep_merge(base, expanded)
        _resolve_substitutions(base)
        return Config(base)

    # -- serialization -----------------------------------------------------

    def serialize(self) -> str:
        """JSON string form for crossing process boundaries
        (reference ConfigUtils.serialize, ConfigUtils.java:124-130)."""
        return json.dumps(self._data, sort_keys=True)

    @staticmethod
    def deserialize(s: str) -> "Config":
        return Config(json.loads(s))

    def pretty(self) -> str:
        """Pretty form with secret-looking values redacted
        (reference ConfigUtils.prettyPrint redaction, ConfigUtils.java:141-152)."""

        def redact(d: Any) -> Any:
            if isinstance(d, dict):
                return {
                    k: ("*****" if _SECRET_RE.search(k) and v is not None else redact(v))
                    for k, v in d.items()
                }
            return d

        return json.dumps(redact(self._data), indent=2, sort_keys=True)

    def flatten(self) -> dict[str, Any]:
        """Flatten to dotted key=value pairs for shell consumption
        (reference ConfigToProperties)."""
        out: dict[str, Any] = {}

        def walk(prefix: str, d: Any) -> None:
            if isinstance(d, dict):
                for k, v in d.items():
                    walk(f"{prefix}.{k}" if prefix else k, v)
            else:
                out[prefix] = d

        walk("", self._data)
        return out

    def __repr__(self) -> str:  # pragma: no cover
        return f"Config({json.dumps(self._data)[:200]})"


def parse_config(text: str, resolve: bool = True) -> Config:
    """Parse standalone config text. Pass resolve=False when the text will be
    layered onto other config — HOCON resolves substitutions *after*
    layering, so ${refs} into keys defined by the lower layer must survive
    parsing and be resolved by overlay()."""
    data = _Parser(text).parse()
    if resolve:
        _resolve_substitutions(data)
    return Config(data)


def load_config(path: str | None = None, overlay: Mapping | None = None) -> Config:
    """Packaged defaults <- optional user file <- optional overlay map.
    Substitutions in the user file may reference packaged default keys; they
    resolve after layering, matching Typesafe Config."""
    cfg = default_config()
    if path:
        with open(path, "r", encoding="utf-8") as f:
            cfg = cfg.overlay(parse_config(f.read(), resolve=False))
    if overlay:
        cfg = cfg.overlay(overlay)
    return cfg


_DEFAULT_CONF_CACHE: Config | None = None


def default_config() -> Config:
    """Framework + app defaults, the analogue of the reference.conf files
    (framework/oryx-common reference.conf:14-291 and app/oryx-app-common
    reference.conf:16-154)."""
    global _DEFAULT_CONF_CACHE
    if _DEFAULT_CONF_CACHE is None:
        import importlib.resources as res

        text = (
            res.files("oryx_tpu_torch.common").joinpath("reference.conf").read_text(encoding="utf-8")
        )
        _DEFAULT_CONF_CACHE = parse_config(text)
    return _DEFAULT_CONF_CACHE
