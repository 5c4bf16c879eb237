"""Wordcount serving tier (the port's copy of
oryx_tpu/apps/example/serving.py).

Mirrors ExampleServingModel(Manager) (app/example .../serving/): MODEL
replaces the word map wholesale; UP "word,count" sets one entry; the
model serves reads for the /distinct endpoints.
"""

from __future__ import annotations

import json
import threading

from oryx_tpu_torch.api import AbstractServingModelManager, ServingModel
from oryx_tpu_torch.common.config import Config


class ExampleServingModel(ServingModel):
    def __init__(self):
        self._words: dict[str, int] = {}
        self._lock = threading.Lock()

    def fraction_loaded(self) -> float:
        return 1.0

    def get_words(self) -> dict[str, int]:
        with self._lock:
            return dict(self._words)

    def get_count(self, word: str) -> int | None:
        with self._lock:
            return self._words.get(word)

    def replace(self, words: dict[str, int]) -> None:
        with self._lock:
            self._words.clear()
            self._words.update(words)

    def set_count(self, word: str, count: int) -> None:
        with self._lock:
            self._words[word] = count


class ExampleServingModelManager(AbstractServingModelManager):
    def __init__(self, config: Config):
        super().__init__(config)
        self.model = ExampleServingModel()

    def get_model(self) -> ExampleServingModel:
        return self.model

    def consume_key_message(self, key: str | None, message: str) -> None:
        if key == "MODEL":
            self.model.replace(json.loads(message))
        elif key == "UP":
            # rsplit: the word itself may contain commas
            word, count = message.rsplit(",", 1)
            self.model.set_count(word, int(count))
        else:
            raise ValueError(f"bad key: {key}")
