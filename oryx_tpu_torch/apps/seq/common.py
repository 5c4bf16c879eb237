"""Shared seq-app plumbing: config view, session-event parsing and
validation, and the windowed-sequence ingest (the port's copy of
oryx_tpu/apps/seq/common.py).

Input lines are CSV or JSON arrays ``user,session,item,ts`` — every
field required (a session event without a timestamp cannot be ordered,
so unlike ALS there is no defaulting). The windowing follows tf.data's
pipeline-of-windows design (PAPERS.md): sessions are materialized as
ordered event lists, then slid over with a fixed-length context window
so every (prefix -> next item) pair becomes one training example, and
the same windowing code serves batch training, evaluation, and the
quality gate — the numbers can never drift in meaning.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.text import parse_input_line

# Composite session key separator: unit separator cannot appear in CSV
# tokens, so "user\x1fsession" is collision-free.
SESSION_KEY_SEP = "\x1f"


@dataclass
class SeqConfig:
    window: int                # context length L of each training example
    min_session_length: int    # sessions shorter than this train nothing
    max_session_events: int    # per-session event cap (newest kept)
    dim: int                   # embedding / hidden width
    epochs: int
    lr: float
    batch: int
    fold_rate: float           # speed-tier embedding blend step
    max_sessions: int          # speed-tier session-tail LRU bound

    @staticmethod
    def from_config(config: Config) -> "SeqConfig":
        g = lambda k, d=None: config.get(f"oryx.seq.{k}", d)
        cfg = SeqConfig(
            window=int(g("window", 8)),
            min_session_length=int(g("min-session-length", 2)),
            max_session_events=int(g("max-session-events", 200)),
            dim=int(g("hyperparams.dim", 32)),
            epochs=int(g("hyperparams.epochs", 30)),
            lr=float(g("hyperparams.lr", 0.5)),
            batch=int(g("hyperparams.batch", 1024)),
            fold_rate=float(g("speed.fold-rate", 0.5)),
            max_sessions=int(g("speed.max-sessions", 20000)),
        )
        if cfg.window < 1:
            raise ValueError(f"oryx.seq.window must be >= 1, got {cfg.window}")
        if cfg.min_session_length < 2:
            raise ValueError(
                "oryx.seq.min-session-length must be >= 2 (a next-item "
                f"example needs a context and a target), got "
                f"{cfg.min_session_length}"
            )
        if not (0.0 < cfg.fold_rate <= 1.0):
            raise ValueError(
                f"oryx.seq.speed.fold-rate must be in (0, 1], got {cfg.fold_rate}"
            )
        return cfg


def valid_session_line(line: str) -> bool:
    """Cheap deserialize check behind the layers' validate_record hook:
    four non-empty tokens with a numeric timestamp. Kept in lockstep with
    the per-line rules in parse_session_events so quarantine decisions
    can never disagree with what a build would ingest (pinned by
    tests/test_chaos.py, and for the port by
    tests/test_torch_seq_app.py). Deliberately a DESERIALIZE check only: a
    timestamp that parses in Python but overflows the int64 event arrays
    is deeper poison — the speed layer's bisection pass isolates it."""
    try:
        tok = parse_input_line(line)
        if len(tok) < 4 or not all(tok[:4]):
            return False
        int(float(tok[3]))
    except (ValueError, IndexError, TypeError, OverflowError):
        # OverflowError: int(float("1e400")) — an exception escaping this
        # hook would bypass the layers' quarantine sweep entirely (the
        # sweep runs outside their build try/except)
        return False
    return True


def valid_session_lines(lines) -> list[bool]:
    return [valid_session_line(l) for l in lines]


def parse_session_events(data) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """KeyMessages -> (users, sessions, items, timestamps). Lines that
    fail the cheap per-line rules are skipped (the validate hook diverts
    them before a build in the managed layers). A timestamp that parses
    but overflows int64 raises at array construction — deterministic
    build poison the speed layer's bisection contains."""
    users, sessions, items, tss = [], [], [], []
    for km in data:
        line = km.message if isinstance(km, KeyMessage) else str(km)
        try:
            tok = parse_input_line(line)
            if len(tok) < 4 or not all(tok[:4]):
                continue
            ts = int(float(tok[3]))
        except (ValueError, IndexError, OverflowError):
            continue
        users.append(tok[0])
        sessions.append(tok[1])
        items.append(tok[2])
        tss.append(ts)
    return (
        np.asarray(users, dtype=object),
        np.asarray(sessions, dtype=object),
        np.asarray(items, dtype=object),
        np.asarray(tss, dtype=np.int64),
    )


def session_key(user: str, session: str) -> str:
    return f"{user}{SESSION_KEY_SEP}{session}"


def sort_dedup_cap(
    events: list[tuple[int, str]], max_events: int
) -> list[tuple[int, str]]:
    """Canonical per-session event order: sorted by (ts, arrival order),
    exact duplicate (ts, item) pairs collapsed (at-least-once delivery
    must not double-count a click), capped at the newest ``max_events``
    when > 0. The ONE normalization sessionize and the batch tier's
    aggregate merge share — incremental merges stay equivalent to a
    from-scratch sessionize because they normalize identically."""
    events.sort(key=lambda e: e[0])
    dedup: list[tuple[int, str]] = []
    seen: set[tuple[int, str]] = set()
    for e in events:
        if e not in seen:
            seen.add(e)
            dedup.append(e)
    if max_events > 0 and len(dedup) > max_events:
        dedup = dedup[-max_events:]
    return dedup


def sessionize(
    users, sessions, items, tss, max_events: int = 0
) -> dict[str, list[tuple[int, str]]]:
    """Group events into ordered per-(user, session) item sequences:
    key -> sort_dedup_cap'd [(ts, item), ...]."""
    out: dict[str, list[tuple[int, str]]] = {}
    for u, s, i, t in zip(users, sessions, items, tss):
        out.setdefault(session_key(u, s), []).append((int(t), i))
    for k, evs in out.items():
        out[k] = sort_dedup_cap(evs, max_events)
    return out


def pad_examples(
    ctx_rows: list, tgt_rows: list, window: int
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Variable-length row contexts -> (contexts [N,L] int32, mask [N,L]
    float32, targets [N] int32), left-padded to the fixed window so every
    example shares one compiled shape. The ONE padding implementation the
    training ingest, the batch eval, and the quality gate all use."""
    n = len(ctx_rows)
    contexts = np.zeros((n, window), dtype=np.int32)
    mask = np.zeros((n, window), dtype=np.float32)
    targets = np.asarray(tgt_rows, dtype=np.int32)
    for r, ctx in enumerate(ctx_rows):
        contexts[r, window - len(ctx):] = ctx
        mask[r, window - len(ctx):] = 1.0
    return contexts, mask, targets


def windowed_examples(
    session_items: dict[str, list[str]],
    item_to_row: dict[str, int],
    window: int,
    min_session_length: int = 2,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The pipeline-of-windows ingest: per-session item sequences ->
    pad_examples over every (items[max(0, j-window):j] -> items[j]) pair
    with j >= 1, in item-ROW space. Items missing from ``item_to_row``
    (vocab built elsewhere, e.g. eval against a trained model) drop the
    examples that touch them."""
    ctx_rows: list[list[int]] = []
    tgt_rows: list[int] = []
    for its in session_items.values():
        if len(its) < max(2, min_session_length):
            continue
        rows = [item_to_row.get(i, -1) for i in its]
        for j in range(1, len(rows)):
            if rows[j] < 0:
                continue
            ctx = rows[max(0, j - window) : j]
            if any(r < 0 for r in ctx):
                continue
            ctx_rows.append(ctx)
            tgt_rows.append(rows[j])
    return pad_examples(ctx_rows, tgt_rows, window)


def item_sequences(sessions: dict[str, list[tuple[int, str]]]) -> dict[str, list[str]]:
    """Strip timestamps: key -> ordered item list."""
    return {k: [i for _, i in evs] for k, evs in sessions.items()}
