"""Seq REST endpoint surface — the session next-item recommender (the
port's copy of oryx_tpu/serving/resources/seq.py).

  GET /recommend-next/{itemID}/{itemID}/...   next items for a session
      whose history is the given item path (oldest -> newest);
      ?howMany= caps the count; the session's own items are excluded.
  POST /event                                 raw session-event lines
      (user,session,item,ts) -> input topic, the app-named alias of
      /ingest (clustering's /add, classreg's /train).
"""

from __future__ import annotations

from oryx_tpu_torch.serving.app import (
    OryxServingException, Request, ServingApp, deferred_map,
)
from oryx_tpu_torch.serving.resources.common import send_input_lines


def _how_many(req: Request, default: int = 10) -> int:
    try:
        how_many = int(req.q1("howMany", str(default)))
    except ValueError as e:
        raise OryxServingException(400, f"bad howMany: {e}") from None
    if how_many <= 0:
        raise OryxServingException(400, "howMany must be positive")
    return how_many


def register(app: ServingApp) -> None:
    # NOT nonblocking: the plan path can rebuild the device view after a
    # model update (full E upload under the sync lock) — too heavy for
    # inline event-loop dispatch; the worker-pool hop stays.
    @app.route("GET", "/recommend-next/{items:rest}")
    def recommend_next(a: ServingApp, req: Request):
        model = a.get_serving_model()
        items = [i for i in req.params["items"].split("/") if i]
        if not items:
            raise OryxServingException(400, "no session items given")
        how_many = _how_many(req)
        fut = model.next_items_async(items, how_many, exclude=set(items))

        def _render(pairs):
            if pairs is None:
                raise OryxServingException(
                    404, "no known item in the session context"
                )
            return pairs

        return deferred_map(fut, _render)

    @app.route("POST", "/event")
    def post_event(a: ServingApp, req: Request):
        n = send_input_lines(a, req.body_text(), "session events")
        return 200, {"ingested": n}

    def _console_rows(a: ServingApp):
        model = a.get_serving_model()
        st = model.state
        return [
            ("Seq model items", len(st.items)),
            ("dim", st.dim),
            ("window", st.window),
            ("served view version", model.served_version()),
        ]

    app.console_sections.append(("Seq next-item model", _console_rows))
