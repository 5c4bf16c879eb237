"""Clustering REST endpoints (the port's copy of
oryx_tpu/serving/resources/clustering.py) — parity with the reference's generic
clustering resources (app/oryx-app-serving .../clustering/{Assign,
DistanceToNearest,Add}.java):

  GET  /assign/{datum}            -> assigned cluster ID
  POST /assign                    -> one ID per input line
  GET  /distanceToNearest/{datum} -> distance to closest centroid
  POST /add  (or /add/{datum})    -> send data points to the input topic
"""

from __future__ import annotations

from oryx_tpu_torch.serving.app import OryxServingException, Request, ServingApp


def _vectorize_or_400(model, datum: str):
    try:
        return model.vectorize(datum)
    except ValueError as e:
        raise OryxServingException(400, f"bad datum: {e}") from None


def register(app: ServingApp) -> None:
    @app.route("GET", "/assign/{datum}")
    def assign(a: ServingApp, req: Request):
        model = a.get_serving_model()
        cid, _ = model.closest_cluster(_vectorize_or_400(model, req.params["datum"]))
        return str(cid)

    @app.route("POST", "/assign")
    def assign_post(a: ServingApp, req: Request):
        model = a.get_serving_model()
        out = []
        for line in req.body_text().splitlines():
            line = line.strip()
            if line:
                cid, _ = model.closest_cluster(_vectorize_or_400(model, line))
                out.append(str(cid))
        if not out:
            raise OryxServingException(400, "no data points given")
        return out

    @app.route("GET", "/distanceToNearest/{datum}")
    def distance_to_nearest(a: ServingApp, req: Request):
        model = a.get_serving_model()
        _, dist = model.closest_cluster(_vectorize_or_400(model, req.params["datum"]))
        return str(dist)

    @app.route("POST", "/add/{datum}")
    def add_one(a: ServingApp, req: Request):
        a.send_input(req.params["datum"])
        return 200, None

    @app.route("POST", "/add")
    def add(a: ServingApp, req: Request):
        from oryx_tpu_torch.serving.resources.common import send_input_lines

        send_input_lines(a, req.body_text())
        return 200, None

    def _clustering_console(a: ServingApp) -> list[tuple[str, object]]:
        model = a.get_serving_model()
        counts = getattr(model, "counts", None)
        rows: list[tuple[str, object]] = [("clusters", model.num_clusters)]
        if counts is not None:
            import numpy as _np

            c = _np.asarray(counts)
            rows += [
                ("points assigned", int(c.sum())),
                ("largest cluster", int(c.max()) if c.size else 0),
                ("smallest cluster", int(c.min()) if c.size else 0),
            ]
        return rows

    app.console_sections.append(("Clustering model", _clustering_console))
