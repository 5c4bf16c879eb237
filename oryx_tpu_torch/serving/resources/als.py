"""ALS REST endpoint surface (the port's copy of
oryx_tpu/serving/resources/als.py) — full parity with the reference's 19 ALS
resources (SURVEY.md §2.11, app/oryx-app-serving .../als/*.java), re-based
on the single-matmul serving model:

  /recommend/{user}                /recommendToMany/{users...}
  /recommendToAnonymous/{prefs..}  /recommendWithContext/{user}/{prefs..}
  /similarity/{items...}           /similarityToItem/{to}/{items...}
  /estimate/{user}/{items...}      /estimateForAnonymous/{to}/{prefs..}
  /because/{user}/{item}           /mostSurprising/{user}
  /knownItems/{user}               /mostActiveUsers
  /mostPopularItems                /popularRepresentativeItems
  /user/allIDs                     /item/allIDs
  /pref/{user}/{item} POST/DELETE  (+ /ready and /ingest in common.py)

Query params: howMany (clamped), offset, considerKnownItems, rescorerParams.
"""

from __future__ import annotations

import numpy as np

from oryx_tpu_torch.common.text import join_csv
from oryx_tpu_torch.serving.app import (
    OryxServingException, Request, ServingApp, deferred_map,
)


def _model(a: ServingApp):
    return a.get_serving_model()


def _how_many(req: Request, default: int = 10) -> tuple[int, int]:
    try:
        how_many = int(req.q1("howMany", str(default)))
        offset = int(req.q1("offset", "0"))
    except ValueError as e:
        raise OryxServingException(400, f"bad howMany/offset: {e}") from None
    # separate checks so the 400 names the parameter that's actually
    # wrong — a negative offset used to be blamed on howMany
    if how_many <= 0:
        raise OryxServingException(400, "howMany must be positive")
    if offset < 0:
        raise OryxServingException(400, "offset must not be negative")
    return how_many, offset

def _page(pairs, how_many, offset):
    return [[i, float(s)] for i, s in pairs[offset : offset + how_many]]


def _parse_prefs(rest: str) -> list[tuple[str, float]]:
    """Path-tail item prefs: itemID(=strength)? segments."""
    out = []
    for seg in rest.split("/"):
        if not seg:
            continue
        if "=" in seg:
            ident, s = seg.split("=", 1)
            try:
                out.append((ident, float(s)))
            except ValueError:
                raise OryxServingException(400, f"bad strength in {seg!r}") from None
        else:
            out.append((seg, 1.0))
    if not out:
        raise OryxServingException(400, "no items given")
    return out


def _rescorer(a: ServingApp, method: str, req: Request, *args):
    provider = getattr(a.model_manager, "rescorer_provider", lambda: None)()
    if provider is None:
        return None
    params = req.q_list("rescorerParams")
    return getattr(provider, method)(*args, *params)


def _user_vector_or_404(model, user: str) -> np.ndarray:
    xu = model.get_user_vector(user)
    if xu is None:
        raise OryxServingException(404, f"unknown user: {user}")
    return xu


def register(app: ServingApp) -> None:
    # -- recommend family --------------------------------------------------

    # NOT nonblocking: the plan path can rebuild the device view (full Y
    # copy + staged upload under _sync_lock after a model update) — far
    # too heavy for inline event-loop dispatch. The worker-pool hop stays.
    @app.route("GET", "/recommend/{userID}")
    def recommend(a: ServingApp, req: Request):
        model = _model(a)
        user = req.params["userID"]
        xu = _user_vector_or_404(model, user)
        how_many, offset = _how_many(req)
        consider_known = req.q1("considerKnownItems", "false") == "true"
        exclude = set() if consider_known else model.state.get_known_items(user)
        rescorer = _rescorer(a, "get_recommend_rescorer", req, [user], model)
        return deferred_map(
            model.top_n_async(xu, how_many + offset, exclude, rescorer),
            lambda pairs: _page(pairs, how_many, offset),
        )

    @app.route("GET", "/recommendToMany/{userIDs:rest}")
    def recommend_to_many(a: ServingApp, req: Request):
        model = _model(a)
        users = [u for u in req.params["userIDs"].split("/") if u]
        vecs, known = [], set()
        for u in users:
            xu = model.get_user_vector(u)
            if xu is not None:
                vecs.append(xu)
                known |= model.state.get_known_items(u)
        if not vecs:
            raise OryxServingException(404, "no known users")
        how_many, offset = _how_many(req)
        consider_known = req.q1("considerKnownItems", "false") == "true"
        rescorer = _rescorer(a, "get_recommend_rescorer", req, users, model)
        mean_vec = np.mean(vecs, axis=0)
        return deferred_map(
            model.top_n_async(mean_vec, how_many + offset,
                              set() if consider_known else known, rescorer),
            lambda pairs: _page(pairs, how_many, offset),
        )

    @app.route("GET", "/recommendToAnonymous/{itemPrefs:rest}")
    def recommend_to_anonymous(a: ServingApp, req: Request):
        model = _model(a)
        prefs = _parse_prefs(req.params["itemPrefs"])
        xu = model.fold_in_user_vector(prefs)
        if xu is None:
            raise OryxServingException(404, "no known items")
        how_many, offset = _how_many(req)
        rescorer = _rescorer(a, "get_recommend_to_anonymous_rescorer", req,
                             [i for i, _ in prefs], model)
        return deferred_map(
            model.top_n_async(xu, how_many + offset, {i for i, _ in prefs}, rescorer),
            lambda pairs: _page(pairs, how_many, offset),
        )

    @app.route("GET", "/recommendWithContext/{userID}/{itemPrefs:rest}")
    def recommend_with_context(a: ServingApp, req: Request):
        """User's vector nudged by session-context prefs before top-N."""
        model = _model(a)
        user = req.params["userID"]
        xu = _user_vector_or_404(model, user).copy()
        prefs = _parse_prefs(req.params["itemPrefs"])
        ctx = model.fold_in_user_vector(prefs)
        if ctx is not None:
            xu = xu + ctx
        how_many, offset = _how_many(req)
        exclude = model.state.get_known_items(user) | {i for i, _ in prefs}
        rescorer = _rescorer(a, "get_recommend_rescorer", req, [user], model)
        return deferred_map(
            model.top_n_async(xu, how_many + offset, exclude, rescorer),
            lambda pairs: _page(pairs, how_many, offset),
        )

    # -- similarity family -------------------------------------------------

    @app.route("GET", "/similarity/{itemIDs:rest}")
    def similarity(a: ServingApp, req: Request):
        model = _model(a)
        items = [i for i in req.params["itemIDs"].split("/") if i]
        mean_vec = model.cosine_to_items(items)
        if mean_vec is None:
            raise OryxServingException(404, "no known items")
        how_many, offset = _how_many(req)
        rescorer = _rescorer(a, "get_most_similar_items_rescorer", req, model)
        return deferred_map(
            model.top_n_async(
                mean_vec, how_many + offset, set(items), rescorer, cosine=True
            ),
            lambda pairs: _page(pairs, how_many, offset),
        )

    @app.route("GET", "/similarityToItem/{toItemID}/{itemIDs:rest}")
    def similarity_to_item(a: ServingApp, req: Request):
        model = _model(a)
        to_vec = model.get_item_vector(req.params["toItemID"])
        if to_vec is None:
            raise OryxServingException(404, "unknown item")
        out = []
        for item in req.params["itemIDs"].split("/"):
            if not item:
                continue
            yi = model.get_item_vector(item)
            if yi is None:
                raise OryxServingException(404, f"unknown item: {item}")
            denom = float(np.linalg.norm(to_vec) * np.linalg.norm(yi))
            out.append([item, float(to_vec @ yi) / denom if denom else 0.0])
        return out

    # -- estimate family ---------------------------------------------------

    @app.route("GET", "/estimate/{userID}/{itemIDs:rest}")
    def estimate(a: ServingApp, req: Request):
        model = _model(a)
        xu = _user_vector_or_404(model, req.params["userID"])
        out = []
        for item in req.params["itemIDs"].split("/"):
            if not item:
                continue
            yi = model.get_item_vector(item)
            out.append([item, float(xu @ yi) if yi is not None else 0.0])
        return out

    @app.route("GET", "/estimateForAnonymous/{toItemID}/{itemPrefs:rest}")
    def estimate_for_anonymous(a: ServingApp, req: Request):
        model = _model(a)
        to_vec = model.get_item_vector(req.params["toItemID"])
        if to_vec is None:
            raise OryxServingException(404, "unknown item")
        xu = model.fold_in_user_vector(_parse_prefs(req.params["itemPrefs"]))
        if xu is None:
            raise OryxServingException(404, "no known items")
        return [[req.params["toItemID"], float(xu @ to_vec)]]

    # -- explain family ----------------------------------------------------

    @app.route("GET", "/because/{userID}/{itemID}")
    def because(a: ServingApp, req: Request):
        """Known items most similar to the recommended item — 'because you
        interacted with these' (Because.java cosine ranking)."""
        model = _model(a)
        yi = model.get_item_vector(req.params["itemID"])
        if yi is None:
            raise OryxServingException(404, "unknown item")
        known = model.state.get_known_items(req.params["userID"])
        if not known:
            raise OryxServingException(404, "no known items for user")
        how_many, offset = _how_many(req)
        ni = float(np.linalg.norm(yi))
        scored = []
        for item in known:
            yk = model.get_item_vector(item)
            if yk is None:
                continue
            denom = ni * float(np.linalg.norm(yk))
            scored.append((item, float(yi @ yk) / denom if denom else 0.0))
        scored.sort(key=lambda t: -t[1])
        return _page(scored, how_many, offset)

    @app.route("GET", "/mostSurprising/{userID}")
    def most_surprising(a: ServingApp, req: Request):
        """Known items with the LOWEST predicted strength — interactions the
        model least expects (MostSurprising.java)."""
        model = _model(a)
        user = req.params["userID"]
        xu = _user_vector_or_404(model, user)
        known = model.state.get_known_items(user)
        if not known:
            raise OryxServingException(404, "no known items for user")
        how_many, offset = _how_many(req)
        scored = []
        for item in known:
            yk = model.get_item_vector(item)
            if yk is not None:
                scored.append((item, float(xu @ yk)))
        scored.sort(key=lambda t: t[1])
        return _page(scored, how_many, offset)

    # -- introspection -----------------------------------------------------

    @app.route("GET", "/knownItems/{userID}")
    def known_items(a: ServingApp, req: Request):
        model = _model(a)
        known = model.state.get_known_items(req.params["userID"])
        if not known:
            raise OryxServingException(404, "no known items for user")
        return sorted(known)

    @app.route("GET", "/mostActiveUsers")
    def most_active_users(a: ServingApp, req: Request):
        model = _model(a)
        how_many, offset = _how_many(req)
        return _page(model.most_active_users(how_many + offset), how_many, offset)

    @app.route("GET", "/mostPopularItems")
    def most_popular_items(a: ServingApp, req: Request):
        model = _model(a)
        how_many, offset = _how_many(req)
        rescorer = _rescorer(a, "get_most_popular_items_rescorer", req, model)
        return _page(model.most_popular_items(how_many + offset, rescorer), how_many, offset)

    @app.route("GET", "/popularRepresentativeItems")
    def popular_representative_items(a: ServingApp, req: Request):
        """One item per LSH partition when LSH is on (reference
        PopularRepresentativeItems), else an even stride over the store."""
        model = _model(a)
        how_many, _ = _how_many(req)
        return model.representative_items(how_many)

    @app.route("GET", "/user/allIDs")
    def user_all_ids(a: ServingApp, req: Request):
        return _model(a).state.x.ids()

    @app.route("GET", "/item/allIDs")
    def item_all_ids(a: ServingApp, req: Request):
        return _model(a).state.y.ids()

    # -- writes ------------------------------------------------------------

    @app.route("POST", "/pref/{userID}/{itemID}")
    def set_pref(a: ServingApp, req: Request):
        model = _model(a)
        user, item = req.params["userID"], req.params["itemID"]
        body = req.body_text().strip()
        try:
            strength = float(body) if body else 1.0
        except ValueError:
            raise OryxServingException(400, f"bad strength: {body!r}") from None
        a.send_input(join_csv([user, item, strength]))
        # read-your-write: apply locally right away (Preference.java:44-66)
        model.state.add_known_items(user, [item])
        return 200, None

    @app.route("DELETE", "/pref/{userID}/{itemID}")
    def delete_pref(a: ServingApp, req: Request):
        model = _model(a)
        user, item = req.params["userID"], req.params["itemID"]
        # empty strength = delete marker (NaN downstream)
        a.send_input(join_csv([user, item, ""]))
        model.state.remove_known_item(user, item)
        return 200, None

    def _als_console(a: ServingApp) -> list[tuple[str, object]]:
        model = _model(a)  # 503s before the model is queryable
        st = model.state
        known = st.known_items_snapshot()
        mb = (st.x.nbytes() + st.y.nbytes()) / 1e6
        # the JAX console's LSH sample rate and measured live recall wait
        # for LSH and the quality plane (ROADMAP queue 1 item 4)
        return [
            ("users (X rows)", len(st.x)),
            ("items (Y rows)", len(st.y)),
            ("features", st.features),
            ("feedback", "implicit" if st.implicit else "explicit"),
            ("users with known items", len(known)),
            ("known-item pairs", sum(len(s) for s in known.values())),
            ("score mode", model.score_mode),
            ("host factor arenas", f"{mb:.1f} MB"),
        ]

    app.console_sections.append(("ALS model", _als_console))

    # memory parity metric: the reference's performance page tracks heap MB
    # per (users+items) x features; this is the equivalent host-side figure
    import weakref

    from oryx_tpu_torch.common.metrics import GaugeSeriesGone, get_registry

    ref = weakref.ref(app)

    def _model_bytes() -> float:
        a = ref()
        if a is None:
            raise GaugeSeriesGone("app gone")
        model = a.model_manager.get_model()
        if model is None:
            return 0.0
        return float(model.state.x.nbytes() + model.state.y.nbytes())

    get_registry().gauge(
        "oryx_als_model_bytes", "Host factor-arena bytes (X + Y)"
    ).set_function(_model_bytes, manager=type(app.model_manager).__name__)
