"""Wordcount batch tier (the port's copy of oryx_tpu/apps/example/batch.py).

Mirrors ExampleBatchLayerUpdate (app/example .../batch/
ExampleBatchLayerUpdate.java:33-60): count, over all data, how many
distinct other words co-occur on a line with each word, and publish the
whole map as a JSON "MODEL" message.
"""

from __future__ import annotations

import json
from typing import Iterable, Sequence

from oryx_tpu_torch.api import BatchLayerUpdate
from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer


def count_distinct_other_words(lines: Iterable[str]) -> dict[str, int]:
    """word -> number of distinct other words it shares a line with."""
    pairs: set[tuple[str, str]] = set()
    for line in lines:
        tokens = set(line.split(" "))
        for a in tokens:
            for b in tokens:
                if a != b:
                    pairs.add((a, b))
    counts: dict[str, int] = {}
    for a, _ in pairs:
        counts[a] = counts.get(a, 0) + 1
    return counts


class ExampleBatchLayerUpdate(BatchLayerUpdate):
    def __init__(self, config=None):
        pass

    def run_update(
        self,
        timestamp_ms: int,
        new_data: Sequence[KeyMessage],
        past_data: Sequence[KeyMessage],
        model_dir: str,
        update_producer: TopicProducer,
    ) -> None:
        all_lines = [km.message for km in (*past_data, *new_data)]
        update_producer.send(
            "MODEL", json.dumps(count_distinct_other_words(all_lines))
        )
