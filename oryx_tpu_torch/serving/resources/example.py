"""Wordcount example REST endpoints (the port's copy of
oryx_tpu/serving/resources/example.py) — parity with app/example
.../serving/{Distinct,Add}.java:

  GET  /distinct            -> the whole word -> count map
  GET  /distinct/{word}     -> one word's count (400 if absent)
  POST /add  (or /add/{line}) -> send lines to the input topic
"""

from __future__ import annotations

from oryx_tpu_torch.serving.app import OryxServingException, Request, ServingApp
from oryx_tpu_torch.serving.resources.common import send_input_lines


def register(app: ServingApp) -> None:
    @app.route("GET", "/distinct")
    def distinct(a: ServingApp, req: Request):
        return a.get_serving_model().get_words()

    @app.route("GET", "/distinct/{word}")
    def distinct_word(a: ServingApp, req: Request):
        count = a.get_serving_model().get_count(req.params["word"])
        if count is None:
            raise OryxServingException(400, "No such word")
        return count

    @app.route("POST", "/add/{line}")
    def add_one(a: ServingApp, req: Request):
        a.send_input(req.params["line"])
        return 200, None

    @app.route("POST", "/add")
    def add(a: ServingApp, req: Request):
        # unlike /ingest, an empty flush has always been a 200 no-op here
        send_input_lines(a, req.body_text(), "lines", required=False)
        return 200, None

    def _example_console(a: ServingApp) -> list[tuple[str, object]]:
        model = a.get_serving_model()
        words = model.get_words()
        return [("distinct words", len(words))]

    app.console_sections.append(("Word count model", _example_console))
