"""Shared ALS app plumbing: input parsing, config view, update payloads
(the port's copy of oryx_tpu/apps/als/common.py).

Input lines are CSV or JSON arrays `user,item[,strength[,timestamp]]`
(reference MLFunctions.PARSE_FN semantics): empty strength = 1, "delete"
semantics = empty-string strength on DELETE paths encoded as NaN.

Update-topic payloads are JSON arrays: ["X", id, [vector], [knownItems]] and
["Y", id, [vector]] (reference ALSUpdate.publishAdditionalModelData /
ALSSpeedModelManager.buildUpdates payload shapes).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from oryx_tpu_torch.apps.updates import (  # noqa: F401 - re-exported API
    batch_update_messages,
    parse_update_message,
    vector_update_message,
)
from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_input_line


@dataclass
class ALSConfig:
    implicit: bool
    log_strength: bool
    epsilon: float
    decay_factor: float
    zero_threshold: float
    no_known_items: bool
    features: object
    lam: object
    alpha: object
    iterations: int
    sample_rate: float
    approx_recall: float
    compute_dtype: str
    checkpoint_interval: int
    candidate_partitions: int
    lsh_max_bits_differing: int | None

    @staticmethod
    def from_config(config: Config) -> "ALSConfig":
        g = lambda k, d=None: config.get(f"oryx.als.{k}", d)
        return ALSConfig(
            implicit=bool(g("implicit", True)),
            log_strength=bool(g("logStrength", False)),
            epsilon=float(g("epsilon", 1.0)),
            decay_factor=float(g("decay.factor", 1.0)),
            zero_threshold=float(g("decay.zero-threshold", 0.0)),
            no_known_items=bool(g("no-known-items", False)),
            features=g("hyperparams.features", 10),
            lam=g("hyperparams.lambda", 0.001),
            alpha=g("hyperparams.alpha", 1.0),
            iterations=int(g("hyperparams.iterations", 10)),
            sample_rate=float(g("sample-rate", 1.0)),
            approx_recall=_valid_recall(float(g("approx-recall", 1.0))),
            compute_dtype=_valid_compute_dtype(str(g("compute-dtype", "float32"))),
            checkpoint_interval=int(g("checkpoint-interval", 0)),
            candidate_partitions=_valid_nonneg(
                "candidate-partitions", int(g("candidate-partitions", 0))
            ),
            lsh_max_bits_differing=_valid_lsh_bits(g("lsh-max-bits-differing", None)),
        )


def _valid_nonneg(key: str, value: int) -> int:
    """Fail at config load, not on the first /recommend request."""
    if value < 0:
        raise ValueError(f"oryx.als.{key} must be >= 0, got {value}")
    return value


def _valid_lsh_bits(raw) -> int | None:
    if raw is None:
        return None
    return _valid_nonneg("lsh-max-bits-differing", int(raw))


def _valid_recall(value: float) -> float:
    """Fail at config load, not on the first /recommend request."""
    if not (0.0 < value <= 1.0):
        raise ValueError(
            f"oryx.als.approx-recall must be in (0, 1], got {value!r}"
        )
    return value


def _valid_compute_dtype(value: str) -> str:
    if value not in ("float32", "bfloat16"):
        raise ValueError(
            f"oryx.als.compute-dtype must be 'float32' or 'bfloat16', got {value!r}"
        )
    return value


def _native_loader():
    try:
        from oryx_tpu_torch.bus.native import NativeParser

        return NativeParser.load()
    except (FileNotFoundError, OSError, AttributeError):
        return None


def valid_event_line(line: str) -> bool:
    """True when parse_events would accept this line — the cheap
    deserialize check behind the layers' validate_record hook. Kept in
    lockstep with the per-line rules in parse_events below so quarantine
    decisions can never disagree with what the build would actually
    ingest (pinned by tests/test_chaos.py)."""
    try:
        tok = parse_input_line(line)
        if len(tok) < 2 or not tok[0] or not tok[1]:
            return False
        if len(tok) > 2 and tok[2] != "":
            float(tok[2])
        if len(tok) > 3 and tok[3] != "":
            int(float(tok[3]))
    except (ValueError, IndexError, TypeError, OverflowError):
        # OverflowError: int(float("1e400")) — an exception escaping this
        # hook would bypass the layers' quarantine sweep entirely
        return False
    return True


def valid_event_lines(lines) -> list[bool]:
    """Batch valid_event_line: ONE native parse call covers the common
    all-canonical-CSV window, and only the lines the C parser flags pay
    the per-line Python check — native ok=False means "not verbatim
    C-parseable" (JSON-array lines land there too), NOT invalid, so
    those are re-checked rather than rejected. A line-count mismatch
    (blank messages, embedded newlines) falls the whole batch back to
    Python, mirroring parse_events' own fallback discipline. Keeps the
    quarantine sweep off the per-record Python path the native loader
    exists to avoid. Deliberate cost: the sweep is one extra native
    parse per window on top of the build's own parse_events call —
    threading one parse's results through both would couple the
    validate hook to parse internals for a C call that is cheap by
    construction."""
    lines = list(lines)
    native = _native_loader()
    if native is not None and lines:
        try:
            ok = native.parse_interactions(
                ("\n".join(lines)).encode("utf-8")
            )[4]
        except Exception:
            ok = None
        if ok is not None and len(ok) == len(lines):
            return [bool(o) or valid_event_line(l) for o, l in zip(ok, lines)]
    return [valid_event_line(l) for l in lines]


def parse_events(data) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """KeyMessages -> (users, items, values, timestamps) arrays. Bad lines
    are skipped. Empty/absent strength = 1.0; empty-string with a 'delete'
    convention arrives as NaN from the /pref DELETE path.

    Hot path: when the native data loader (native/oryxbus) is built and
    every line is plain CSV with canonical-integer ids, the whole batch
    parses in C with no Python object per record (users/items come back as
    int64 arrays; aggregate_interactions factorizes those without string
    round-trips). Any line the loader can't take verbatim falls the whole
    batch back to the Python parser, so semantics never fork."""
    native = _native_loader()
    if native is not None:
        lines = [
            km.message if isinstance(km, KeyMessage) else str(km) for km in data
        ]
        if lines:
            u, i, v, t, ok = native.parse_interactions(
                ("\n".join(lines)).encode("utf-8")
            )
            # row count must match the message count exactly (catches blank
            # messages and embedded newlines) and every row must be clean
            if len(ok) == len(lines) and bool(ok.all()):
                return u, i, v, t

    users, items, vals, tss = [], [], [], []
    for km in data:
        line = km.message if isinstance(km, KeyMessage) else str(km)
        try:
            tok = parse_input_line(line)
            if len(tok) < 2 or not tok[0] or not tok[1]:
                continue
            u, i = tok[0], tok[1]
            v = 1.0
            if len(tok) > 2 and tok[2] != "":
                v = float(tok[2])
            elif len(tok) > 2 and tok[2] == "":
                v = float("nan")  # delete marker
            ts = int(float(tok[3])) if len(tok) > 3 and tok[3] != "" else 0
        except (ValueError, IndexError):
            continue
        users.append(u)
        items.append(i)
        vals.append(v)
        tss.append(ts)
    return (
        np.asarray(users, dtype=object),
        np.asarray(items, dtype=object),
        np.asarray(vals, dtype=np.float64),
        np.asarray(tss, dtype=np.int64),
    )


# ALS-named wrappers over the shared UP-message codec (apps/updates.py)
def x_update_message(user_id: str, vector, known_items) -> tuple[str, str]:
    return vector_update_message("X", user_id, vector, known=known_items)


def y_update_message(item_id: str, vector) -> tuple[str, str]:
    return vector_update_message("Y", item_id, vector)
