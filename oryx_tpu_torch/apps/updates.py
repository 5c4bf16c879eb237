"""Shared update-topic vector codec (the port's copy of
oryx_tpu/apps/updates.py): every packaged app that streams factor rows as
``UP`` messages shares ONE wire format and ONE batched builder.

Payloads are JSON arrays ``[kind, id, [vector]]`` or
``[kind, id, [vector], [known...]]`` — the reference's
ALSSpeedModelManager/ALSUpdate payload shape with the first element
generalized: ALS uses kinds "X"/"Y", the seq app uses "E" for item
embeddings. Byte parity with the historical ALS payloads is pinned by
tests/test_als_state.py::test_batch_update_messages_byte_parity.
"""

from __future__ import annotations

import json

import numpy as np

# UP-message float precision, shared by the single-message and batched
# builders so their payloads stay byte-identical.
ROUND_DECIMALS = 6


def round_vector(vector) -> list:
    # vectorized: a per-element Python round() dominates UP-message cost
    # at speed-tier rates
    return np.round(np.asarray(vector, dtype=np.float64), ROUND_DECIMALS).tolist()


def vector_update_message(
    kind: str, ident: str, vector, known=None
) -> tuple[str, str]:
    """One UP message: ``[kind, id, [vector]]`` (+ sorted known list)."""
    payload = [kind, ident, round_vector(vector)]
    if known is not None:
        payload.append(sorted(known))
    return "UP", json.dumps(payload, separators=(",", ":"))


def batch_update_messages(
    kind: str, ids, vectors, known_lists=None
) -> list[tuple[str, str]]:
    """Batch of UP messages, byte-identical to the single-message path:
    ONE json.dumps serializes the whole [N,K] rounded block through the C
    encoder, and the blob splits on "],[" into per-row number strings
    (rows contain only numbers and commas, so the separator is
    unambiguous). Per-message dumps of the vector floats — 120k Python
    encoder invocations per 20k-event micro-batch — was ~45% of speed-tier
    build time. Callers must pre-filter non-finite rows (NaN/Infinity are
    not valid JSON)."""
    n = len(ids)
    if n == 0:
        return []
    vecs = np.round(np.asarray(vectors, dtype=np.float64), ROUND_DECIMALS)
    blob = json.dumps(vecs.tolist(), separators=(",", ":"))
    rows = blob[2:-2].split("],[")
    assert len(rows) == n
    out = []
    for j, ident in enumerate(ids):
        if known_lists is not None:
            out.append((
                "UP",
                f'["{kind}",{json.dumps(ident)},[{rows[j]}],'
                f'{json.dumps(sorted(known_lists[j]), separators=(",", ":"))}]',
            ))
        else:
            out.append((
                "UP", f'["{kind}",{json.dumps(ident)},[{rows[j]}]]',
            ))
    return out


def parse_update_message(message: str):
    """-> (kind, id, np float32 vector, known_ids list)."""
    arr = json.loads(message)
    kind, ident, vec = arr[0], str(arr[1]), np.asarray(arr[2], dtype=np.float32)
    known = [str(k) for k in arr[3]] if len(arr) > 3 and arr[3] else []
    return kind, ident, vec, known
