"""CSV/JSON line codecs for the wire format on bus topics.

Mirrors the reference's TextUtils (framework/oryx-common .../text/TextUtils.java):
input lines are CSV (RFC-4180-ish, with quoting) or JSON arrays; update-topic
payloads are JSON with typed decoding (`convertViaJSON`).
"""

from __future__ import annotations

import csv
import io
import json
from typing import Any, Sequence


def parse_delimited(line: str, delimiter: str = ",") -> list[str]:
    """Parse one delimited line honoring quotes (TextUtils.parseDelimited)."""
    reader = csv.reader(io.StringIO(line), delimiter=delimiter)
    row = next(reader, [])
    return row


def parse_csv(line: str) -> list[str]:
    return parse_delimited(line, ",")


def join_delimited(values: Sequence[Any], delimiter: str = ",") -> str:
    """Join values into one delimited line with quoting (TextUtils.joinDelimited)."""
    buf = io.StringIO()
    writer = csv.writer(buf, delimiter=delimiter, quoting=csv.QUOTE_MINIMAL, lineterminator="")
    writer.writerow(["" if v is None else v for v in values])
    return buf.getvalue()


def join_csv(values: Sequence[Any]) -> str:
    return join_delimited(values, ",")


def parse_json_array(line: str) -> list:
    v = json.loads(line)
    if not isinstance(v, list):
        raise ValueError(f"not a JSON array: {line[:100]}")
    return v


def parse_input_line(line: str) -> list[str]:
    """Auto-detect JSON-array vs CSV input lines, the behavior of the
    reference's shared PARSE_FN (app/oryx-app-common .../fn/MLFunctions.java)."""
    s = line.strip()
    if s.startswith("["):
        return [str(x) if x is not None else "" for x in parse_json_array(s)]
    return parse_csv(s)


def to_json(value: Any) -> str:
    return json.dumps(value, separators=(",", ":"))


def from_json(s: str) -> Any:
    return json.loads(s)


def convert_via_json(value: Any, target: type) -> Any:
    """Round-trip a value through JSON to coerce it into `target`
    (TextUtils.convertViaJSON) — used to decode typed update payloads.
    String forms parse like JSON scalars would, so "false" -> False and
    "3" -> 3, never Python truthiness coercion."""
    v = json.loads(json.dumps(value))
    if target is bool:
        if isinstance(v, bool):
            return v
        if isinstance(v, str) and v.lower() in ("true", "false"):
            return v.lower() == "true"
        raise ValueError(f"cannot convert {v!r} to bool")
    if target is int:
        if isinstance(v, bool) or not isinstance(v, (int, float, str)):
            raise ValueError(f"cannot convert {v!r} to int")
        return int(float(v)) if isinstance(v, str) else int(v)
    if target is float:
        if isinstance(v, bool) or not isinstance(v, (int, float, str)):
            raise ValueError(f"cannot convert {v!r} to float")
        return float(v)
    if target is str:
        return v if isinstance(v, str) else json.dumps(v)
    if target in (list, dict):
        if not isinstance(v, target):
            raise ValueError(f"cannot convert {type(v)} to {target}")
        return v
    return v
