"""Wordcount speed tier (the port's copy of oryx_tpu/apps/example/speed.py).

Mirrors ExampleSpeedModelManager (app/example .../speed/
ExampleSpeedModelManager.java): MODEL replaces the local map, UP is
ignored, and each micro-batch emits "word,newCount" CSV updates that add
the batch's distinct-co-occurrence counts to the current model's.
"""

from __future__ import annotations

import json
import threading

from oryx_tpu_torch.api import AbstractSpeedModelManager
from oryx_tpu_torch.apps.example.batch import count_distinct_other_words


class ExampleSpeedModelManager(AbstractSpeedModelManager):
    def __init__(self, config=None):
        self._words: dict[str, int] = {}
        self._lock = threading.Lock()

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == "MODEL":
            model = json.loads(message)
            with self._lock:
                self._words.clear()
                self._words.update(model)
        elif key == "UP":
            pass  # hearing our own updates
        else:
            raise ValueError(f"bad key: {key}")

    def build_updates(self, new_data):
        counts = count_distinct_other_words(km.message for km in new_data)
        out = []
        with self._lock:
            for word, count in counts.items():
                new_count = count + self._words.get(word, 0)
                self._words[word] = new_count
                out.append(("UP", f"{word},{new_count}"))
        return out
