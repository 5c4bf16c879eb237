"""Update-topic vector codec: the parser of ``UP`` messages (the port's copy
of ``parse_update_message`` from oryx_tpu/apps/updates.py; the message
builders belong to the speed layer, a later slice).

Payloads are JSON arrays ``[kind, id, [vector]]`` or
``[kind, id, [vector], [known...]]`` — the reference's
ALSSpeedModelManager/ALSUpdate payload shape with the first element
generalized: ALS uses kinds "X"/"Y", the seq app uses "E" for item
embeddings.
"""

from __future__ import annotations

import json

import numpy as np


def parse_update_message(message: str):
    """-> (kind, id, np float32 vector, known_ids list)."""
    arr = json.loads(message)
    kind, ident, vec = arr[0], str(arr[1]), np.asarray(arr[2], dtype=np.float32)
    known = [str(k) for k in arr[3]] if len(arr) > 3 and arr[3] else []
    return kind, ident, vec, known
