"""Fleet observability plumbing: metrics federation text merging (the
port's copy of oryx_tpu/fleet/observe.py).

``GET /fleet/metrics`` gives one Prometheus job the whole replicas×shards
topology: the front scrapes every routable replica's ``/metrics`` and
re-exports the UNION with an injected ``replica`` label. The merge is
textual but family-aware — a strict OpenMetrics parser (prometheus_client
is the reference consumer) rejects a page with duplicate ``# TYPE`` lines
or interleaved families, so N replica pages cannot simply be
concatenated. Instead each page is parsed into (family → metadata +
sample lines), the label is injected per sample line (exemplars and
timestamps ride along verbatim — the metric→trace join of
docs/observability.md survives federation), and each family renders
once with every replica's samples under it.
"""

from __future__ import annotations

import re

# `# HELP <name> <text>` / `# TYPE <name> <kind>` / `# UNIT <name> <u>`
_META_RE = re.compile(r"^#\s+(HELP|TYPE|UNIT)\s+(\S+)\s*(.*)$")


class _Family:
    __slots__ = ("name", "help", "type", "unit", "samples")

    def __init__(self, name: str):
        self.name = name
        self.help: str | None = None
        self.type: str | None = None
        self.unit: str | None = None
        # replica id -> sample lines in the replica's own order
        self.samples: dict[str, list[str]] = {}


def _sample_family(sample_name: str, current: str | None) -> str:
    """Family a sample line belongs to: the preceding TYPE's family when
    the sample name extends it (`foo_total` under family `foo`), else the
    sample's own base name (metadata-less stray sample)."""
    if current is not None and (
        sample_name == current or sample_name.startswith(current + "_")
    ):
        return current
    return sample_name


def _has_label(labelset: str, label: str) -> bool:
    """True when ``labelset`` (the text between the braces, opener
    included) carries ``label`` as a label NAME — anchored to a name
    boundary so ``shard_replica=`` never masquerades as ``replica=``."""
    needle = label + "="
    start = 0
    while True:
        i = labelset.find(needle, start)
        if i < 0:
            return False
        if i > 0 and labelset[i - 1] in "{,":
            return True
        start = i + 1


def inject_label(line: str, label: str, value: str) -> str:
    """Insert ``label="value"`` into one sample line's labelset. The first
    ``{`` in a sample line is always the labelset opener (metric names
    cannot contain it; exemplar braces come after the value). A sample
    already carrying the label keeps its own (a replica's self-description
    outranks the scraper's)."""
    brace = line.find("{")
    space = line.find(" ")
    pair = f'{label}="{value}"'
    if brace != -1 and (space == -1 or brace < space):
        end = line.find("}", brace)
        if _has_label(line[brace:end], label):
            return line
        sep = "" if line[brace + 1] == "}" else ","
        return line[: brace + 1] + pair + sep + line[brace + 1 :]
    if space == -1:
        return line  # not a sample line; pass through untouched
    return line[:space] + "{" + pair + "}" + line[space:]


def parse_exposition(text: str) -> tuple[dict[str, _Family], list[str]]:
    """One exposition page -> (family map, family order). Sample lines are
    kept VERBATIM (exemplars, timestamps) and grouped under their family.
    Tolerates both classic text and OpenMetrics (`# EOF` ends the page)."""
    families: dict[str, _Family] = {}
    order: list[str] = []
    current: str | None = None

    def fam(name: str) -> _Family:
        f = families.get(name)
        if f is None:
            f = _Family(name)
            families[name] = f
            order.append(name)
        return f

    for line in text.splitlines():
        if not line.strip():
            continue
        if line.startswith("#"):
            if line.strip() == "# EOF":
                break
            m = _META_RE.match(line)
            if m is None:
                continue
            keyword, name, rest = m.groups()
            f = fam(name)
            current = name
            if keyword == "HELP":
                f.help = rest
            elif keyword == "TYPE":
                f.type = rest.strip()
            else:
                f.unit = rest.strip()
            continue
        name_end = min(
            i for i in (line.find("{"), line.find(" ")) if i != -1
        ) if ("{" in line or " " in line) else -1
        if name_end <= 0:
            continue  # unparseable line: drop rather than corrupt the page
        family_name = _sample_family(line[:name_end], current)
        fam(family_name).samples.setdefault("", []).append(line)
    return families, order


def federate(pages: list[tuple[str, str]], openmetrics: bool = False) -> str:
    """[(replica id, exposition text)] -> one merged page with a
    ``replica`` label injected into every sample. Family metadata
    (HELP/TYPE/UNIT) renders once per family — first replica's wording
    wins — and families sort by name, matching the registry renderer, so
    the union is deterministic regardless of replica arrival order."""
    merged: dict[str, _Family] = {}
    for rid, text in pages:
        families, _ = parse_exposition(text)
        for name, f in families.items():
            m = merged.get(name)
            if m is None:
                m = _Family(name)
                merged[name] = m
            if m.help is None:
                m.help = f.help
            if m.type is None:
                m.type = f.type
            if m.unit is None:
                m.unit = f.unit
            lines = [
                inject_label(ln, "replica", rid)
                for ln in f.samples.get("", [])
            ]
            if lines:
                m.samples.setdefault(rid, []).extend(lines)
    out: list[str] = []
    for name in sorted(merged):
        f = merged[name]
        if not f.samples:
            continue  # metadata-only family: a sample-less TYPE is noise
        if f.help is not None:
            out.append(f"# HELP {name} {f.help}")
        # the dialects disagree on the typeless type name, and a strict
        # OpenMetrics parser rejects classic text's "untyped"
        default_type = "unknown" if openmetrics else "untyped"
        out.append(f"# TYPE {name} {f.type or default_type}")
        if f.unit:
            out.append(f"# UNIT {name} {f.unit}")
        for rid in sorted(f.samples):
            out.extend(f.samples[rid])
    if openmetrics:
        out.append("# EOF")
    return "\n".join(out) + "\n"


def merge_latency_budgets(budgets: list[dict]) -> dict:
    """Per-replica latency budgets (healthz ``latency_budget`` sections,
    shape of ``perfattr.PerfAttr.budget()``) -> one fleet-level summary.

    Phase percentiles cannot be averaged exactly from summaries, so the
    merge is deliberately honest about what it is: per-phase counts sum,
    p50/p99 are count-weighted means of the replica percentiles (an
    operator-grade approximation, labelled as such by the key names), and
    ``share`` is recomputed from the merged totals so the fleet waterfall
    still sums to ~1.0. Idle-gap cause seconds sum directly.
    """
    phases: dict[str, dict[str, float]] = {}
    gaps: dict[str, float] = {}
    window_s = 0.0
    for b in budgets:
        if not isinstance(b, dict):
            continue
        window_s = max(window_s, float(b.get("window_s") or 0.0))
        for name, row in (b.get("phases") or {}).items():
            if not isinstance(row, dict):
                continue
            n = float(row.get("count") or 0.0)
            if n <= 0:
                continue
            agg = phases.setdefault(
                name, {"count": 0.0, "_p50_w": 0.0, "_p99_w": 0.0}
            )
            agg["count"] += n
            agg["_p50_w"] += n * float(row.get("p50_ms") or 0.0)
            agg["_p99_w"] += n * float(row.get("p99_ms") or 0.0)
        for cause, row in (b.get("idle_gaps") or {}).items():
            if isinstance(row, dict):
                gaps[cause] = gaps.get(cause, 0.0) + float(
                    row.get("seconds") or 0.0
                )
    total_ms = sum(
        a["_p50_w"] for a in phases.values()
    )  # count-weighted p50 mass approximates each phase's time share
    out_phases = {}
    for name, a in phases.items():
        n = a["count"]
        out_phases[name] = {
            "count": int(n),
            "p50_ms": round(a["_p50_w"] / n, 3),
            "p99_ms": round(a["_p99_w"] / n, 3),
            "share": round(a["_p50_w"] / total_ms, 4) if total_ms else 0.0,
        }
    gap_total = sum(gaps.values())
    out_gaps = {
        cause: {
            "seconds": round(sec, 6),
            "share": round(sec / gap_total, 4) if gap_total else 0.0,
        }
        for cause, sec in sorted(
            gaps.items(), key=lambda kv: kv[1], reverse=True
        )
    }
    return {
        "window_s": window_s,
        "replicas": sum(1 for b in budgets if isinstance(b, dict)),
        "phases": out_phases,
        "idle_gaps": out_gaps,
    }
