"""The serving layer as users reach it, in both packages side by side: a JAX
``ServingLayer`` and the port's ``ServingLayer`` (its ALS manager on
``device="cpu"``), each on its own mem:// topics, load the same model from
the same MODEL-REF artifact over the update topic, then take the same UP
rows, and must answer the same HTTP requests alike -- every ALS route,
/ready, /ingest and /pref, JSON and CSV, under both frontends, before and
after the UP rows.

Tolerance: values within 1e-5 relative (both packages re-rank candidates in
exact f32 on the host); ids equal at every slot except where the two
entries' scores, as either package returned them, are within 1e-6 relative
of each other (a near-tie ordered the other way).
"""

from __future__ import annotations

import http.client
import json
import socket
import struct
import time

import numpy as np
import pytest

from oryx_tpu.apps.spi import app_overlay as jax_app_overlay
from oryx_tpu.bus.broker import get_broker as jax_get_broker
from oryx_tpu.common.artifact import ModelArtifact
from oryx_tpu.common.config import load_config as jax_load_config
from oryx_tpu.serving.server import ServingLayer as JaxServingLayer
from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
from oryx_tpu_torch.apps.spi import app_overlay
from oryx_tpu_torch.bus import get_broker
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.serving.server import ServingLayer

N_ITEMS, N_USERS, FEATURES, KNOWN = 2000, 300, 8, 5
VALUE_RTOL = 1e-5
TIE_RTOL = 1e-6
FRONTENDS = ("async", "threaded")
JSON = {"Accept": "application/json"}
CSV = {"Accept": "text/csv"}

# (name, method, path, body): the 18 routes of serving/resources/als.py,
# then /ready and /ingest of resources/common.py. The writes come last in
# each phase, so the reads see the same state in both packages; "{a}" in a
# write is "j" when it is sent as JSON and "c" as CSV, so each line it
# writes is its own.
ROUTES = [
    ("recommend", "GET", "/recommend/u3?howMany=7", None),
    ("recommend-paged", "GET", "/recommend/u4?howMany=4&offset=3", None),
    ("recommendToMany", "GET", "/recommendToMany/u5/u6?howMany=6", None),
    ("recommendToAnonymous", "GET",
     "/recommendToAnonymous/i3/i10=2.0/i77?howMany=5", None),
    ("recommendWithContext", "GET",
     "/recommendWithContext/u7/i11/i12=0.5?howMany=5", None),
    ("similarity", "GET", "/similarity/i7/i8?howMany=6", None),
    ("similarityToItem", "GET", "/similarityToItem/i9/i1/i2/i3", None),
    ("estimate", "GET", "/estimate/u8/i1/i2/i999", None),
    ("estimateForAnonymous", "GET", "/estimateForAnonymous/i4/i5/i6=3", None),
    ("because", "GET", "/because/u9/i13?howMany=3", None),
    ("mostSurprising", "GET", "/mostSurprising/u10?howMany=3", None),
    ("knownItems", "GET", "/knownItems/u11", None),
    ("mostActiveUsers", "GET", "/mostActiveUsers?howMany=5", None),
    ("mostPopularItems", "GET", "/mostPopularItems?howMany=5", None),
    ("popularRepresentativeItems", "GET",
     "/popularRepresentativeItems?howMany=6", None),
    ("user-allIDs", "GET", "/user/allIDs", None),
    ("item-allIDs", "GET", "/item/allIDs", None),
    ("unknown-user", "GET", "/recommend/nobody", None),
    ("ready", "GET", "/ready", None),
    ("pref-post", "POST", "/pref/u12/i14{a}", "2.5"),
    ("pref-delete", "DELETE", "/pref/u13/i15{a}", None),
    ("ingest", "POST", "/ingest", "u14,i16{a},1.0\nu15,i17{a},3\n"),
]
ROUTE_NAMES = [r[0] for r in ROUTES]

# UP rows, the same to both packages: a moved item, a new user, and two
# new items (the last two make convergence observable: i-new is u0's best
# item and i-twin is i7's nearest neighbour)
_RNG = np.random.default_rng(20240611)
_MODEL = {
    "x": _RNG.standard_normal((N_USERS, FEATURES), dtype=np.float32),
    "y": _RNG.standard_normal((N_ITEMS, FEATURES), dtype=np.float32),
}
# each user's two best items are known items, so every answer that
# excludes them differs from one that does not
_MODEL["known"] = np.concatenate([
    np.argsort(-(_MODEL["x"] @ _MODEL["y"].T), axis=1)[:, :2],
    _RNG.integers(0, N_ITEMS, size=(N_USERS, KNOWN - 2)),
], axis=1)


def _up_rows() -> list[str]:
    x, y = _MODEL["x"], _MODEL["y"]
    rng = np.random.default_rng(7)
    vec = lambda v: [float(a) for a in v]
    return [
        json.dumps(["Y", "i20", vec(rng.standard_normal(FEATURES))]),
        json.dumps(["X", "u-new", vec(rng.standard_normal(FEATURES)),
                    ["i21", "i22"]]),
        json.dumps(["Y", "i-new", vec(10.0 * x[0])]),
        json.dumps(["Y", "i-twin", vec(3.0 * y[7])]),
    ]


@pytest.fixture(scope="module")
def model_ref(tmp_path_factory) -> str:
    """The model artifact both packages load (written with the JAX
    package's writer; the port reads the same layout)."""
    x_ids = [f"u{j}" for j in range(N_USERS)]
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    known = {u: [f"i{int(j)}" for j in row]
             for u, row in zip(x_ids, _MODEL["known"])}
    art = ModelArtifact("als", content={"knownItems": known},
                        tensors={"X": _MODEL["x"], "Y": _MODEL["y"]})
    art.set_extension("features", str(FEATURES))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", x_ids)
    art.set_extension("YIDs", y_ids)
    path = tmp_path_factory.mktemp("als-model") / "model"
    art.write(path)
    return str(path)


def _overlay(spi_overlay: dict, bus: str, frontend: str, flight) -> dict:
    overlay = dict(spi_overlay)
    overlay.update({
        "oryx.monitoring.flight.dir": str(flight),
        "oryx.input-topic.broker": bus,
        "oryx.update-topic.broker": bus,
        "oryx.serving.api.port": 0,
        "oryx.serving.api.server": frontend,
        "oryx.serving.api.loops": 2,
        "oryx.serving.api.workers": 8,
    })
    return overlay


def _create_topics(broker) -> None:
    for topic in ("OryxInput", "OryxUpdate"):
        if not broker.topic_exists(topic):
            broker.create_topic(topic, 1)


def _request(port: int, method: str, path: str, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return r.status, r.getheader("Content-Type"), r.read()
    finally:
        conn.close()


def _wait(port: int, path: str, done, timeout_s: float = 60.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        status, _, body = _request(port, "GET", path, headers=JSON)
        if done(status, body):
            return
        time.sleep(0.02)
    raise TimeoutError(f"{path} never converged on port {port}")


def _top_is(item: str):
    return lambda status, body: (
        status == 200 and json.loads(body)[0][0] == item
    )


def _run_phase(port: int) -> dict:
    """Every route with either Accept header: {(name, accept): (status,
    content type, body)}."""
    out = {}
    for name, method, path, body in ROUTES:
        for accept, headers in (("json", JSON), ("csv", CSV)):
            a = accept[0]
            out[(name, accept)] = _request(
                port, method, path.format(a=a),
                None if body is None else body.format(a=a).encode(), headers)
    return out


def _input_lines(broker) -> list[tuple[str | None, str]]:
    recs = broker.read("OryxInput", 0, 0, 1000)
    return [(k, m) for _, k, m in recs]


@pytest.fixture(scope="module", params=FRONTENDS)
def served(request, model_ref, tmp_path_factory):
    """Both packages' layers under one frontend, driven through both
    phases; yields the recorded responses and the input topics."""
    frontend = request.param
    jbus, pbus = f"mem://jax-sl-{frontend}", f"mem://port-sl-{frontend}"
    jbroker, pbroker = jax_get_broker(jbus), get_broker(pbus)
    _create_topics(jbroker)
    _create_topics(pbroker)
    flight = tmp_path_factory.mktemp(f"flight-{frontend}")
    jcfg = jax_load_config(overlay=_overlay(jax_app_overlay("als"), jbus,
                                            frontend, flight / "jax"))
    pcfg = load_config(overlay=_overlay(app_overlay("als"), pbus, frontend,
                                        flight / "port"))
    jlayer = JaxServingLayer(jcfg)
    player = ServingLayer(
        pcfg, model_manager=ALSServingModelManager(pcfg, device="cpu"))
    jlayer.start()
    try:
        player.start()
        try:
            layers = {"jax": (jlayer, jbroker), "port": (player, pbroker)}
            before_ready = {
                pkg: _request(sl.port, "GET", "/ready", headers=JSON)[0]
                for pkg, (sl, _b) in layers.items()
            }
            for _pkg, (sl, broker) in layers.items():
                broker.send("OryxUpdate", "MODEL-REF", model_ref)
            for _pkg, (sl, _b) in layers.items():
                _wait(sl.port, "/ready", lambda s, _body: s == 200)
            phases = {"before": {}, "after": {}}
            for pkg, (sl, _b) in layers.items():
                phases["before"][pkg] = _run_phase(sl.port)
            for _pkg, (sl, broker) in layers.items():
                for row in _up_rows():
                    broker.send("OryxUpdate", "UP", row)
            for _pkg, (sl, _b) in layers.items():
                # the planted rows come last: once both views serve them,
                # every UP row is in every view
                _wait(sl.port, "/recommend/u0?howMany=1", _top_is("i-new"))
                _wait(sl.port, "/similarity/i7?howMany=1", _top_is("i-twin"))
            for pkg, (sl, _b) in layers.items():
                phases["after"][pkg] = _run_phase(sl.port)
            h1 = h2 = None
            if frontend == "async":  # the threaded frontend has no h2
                h2 = _h2_get(player.port, "/recommend/u3?howMany=7")
                h1 = _request(player.port, "GET", "/recommend/u3?howMany=7")
            yield {
                "frontend": frontend, "phases": phases,
                "before_ready": before_ready,
                "input": {"jax": _input_lines(jbroker),
                          "port": _input_lines(pbroker)},
                "h1_h2": (h1, h2),
            }
        finally:
            player.close()
    finally:
        jlayer.close()


# -- comparison -------------------------------------------------------------


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def _same_pairs(jp: list, pp: list) -> None:
    """[id, value] rows: values within VALUE_RTOL; a slot's ids may differ
    only at a near-tie."""
    assert len(jp) == len(pp), (jp, pp)
    for (ji, jv), (pi, pv) in zip(jp, pp):
        assert _close(float(jv), float(pv), VALUE_RTOL), (ji, jv, pi, pv)
        if ji != pi:
            assert _close(float(jv), float(pv), TIE_RTOL), (ji, jv, pi, pv)


def _same_json(jb: bytes, pb: bytes) -> None:
    jd, pd = json.loads(jb), json.loads(pb)
    if (isinstance(jd, list) and jd and isinstance(jd[0], list)
            and len(jd[0]) == 2 and isinstance(jd[0][1], (int, float))):
        _same_pairs(jd, pd)
    else:
        assert jd == pd


def _same_csv(jb: bytes, pb: bytes) -> None:
    jrows = [r.split(",") for r in jb.decode().splitlines()]
    prows = [r.split(",") for r in pb.decode().splitlines()]
    if jrows and len(jrows[0]) == 2:
        try:
            float(jrows[0][1])
            numeric = True
        except ValueError:
            numeric = False
        if numeric:
            _same_pairs(jrows, prows)
            return
    assert jrows == prows


def _same_response(j, p) -> None:
    jstatus, jtype, jbody = j
    pstatus, ptype, pbody = p
    assert (jstatus, jtype) == (pstatus, ptype)
    if jtype == "application/json" and jbody:
        _same_json(jbody, pbody)
    elif jtype == "text/csv":
        _same_csv(jbody, pbody)
    else:
        assert jbody == pbody


@pytest.mark.parametrize("accept", ["json", "csv"])
@pytest.mark.parametrize("route", ROUTE_NAMES)
@pytest.mark.parametrize("phase", ["before", "after"])
def test_same_answer(served, phase, route, accept):
    got = served["phases"][phase]
    key = (route, accept)
    _same_response(got["jax"][key], got["port"][key])
    status = got["port"][key][0]
    # the read routes answer 200 for a loaded model (the unknown user 404s)
    assert status == (404 if route == "unknown-user" else 200), got["port"][key]


def test_ready_before_model_is_503_in_both(served):
    assert served["before_ready"] == {"jax": 503, "port": 503}


def test_writes_reach_the_input_topic_alike(served):
    jlines, plines = served["input"]["jax"], served["input"]["port"]
    assert jlines == plines
    messages = [m for _k, m in plines]
    # /pref POST and DELETE, then /ingest's two lines, per Accept header
    # and phase
    for a in "jc":
        assert messages.count(f"u12,i14{a},2.5") == 2
        assert messages.count(f"u13,i15{a},") == 2
        assert messages.count(f"u14,i16{a},1.0") == 2
        assert messages.count(f"u15,i17{a},3") == 2
    assert len(messages) == 16


def test_after_up_the_planted_items_are_served(served):
    after = served["phases"]["after"]["port"]
    user_ids = json.loads(after[("user-allIDs", "json")][2])
    item_ids = json.loads(after[("item-allIDs", "json")][2])
    assert "u-new" in user_ids and "i-new" in item_ids
    assert "i-twin" in item_ids


@pytest.mark.parametrize("served", ["async"], indirect=True)
def test_h2_prior_knowledge_matches_h1(served):
    (h1_status, _h1_type, h1_body), (h2_status, h2_body) = served["h1_h2"]
    assert h1_status == h2_status == 200
    assert h2_body == h1_body


# -- a minimal HTTP/2 client (prior knowledge, one stream) -------------------


def _frame(ftype: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    return (struct.pack(">I", len(payload))[1:] + bytes([ftype, flags])
            + struct.pack(">I", sid) + payload)


def _read_frame(f):
    head = f.read(9)
    assert len(head) == 9, "connection closed mid-frame"
    length = int.from_bytes(head[:3], "big")
    sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
    return head[3], head[4], sid, f.read(length)


def _h2_get(port: int, path: str) -> tuple[int, bytes]:
    from oryx_tpu_torch.serving.hpack import Decoder, encode

    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n" + _frame(0x4, 0, 0))
        block = encode([(b":method", b"GET"), (b":scheme", b"http"),
                        (b":path", path.encode()),
                        (b":authority", b"localhost")])
        s.sendall(_frame(0x1, 0x1 | 0x4, 1, block))  # END_STREAM|END_HEADERS
        f = s.makefile("rb")
        dec, status, body = Decoder(), None, b""
        while True:
            ftype, flags, sid, payload = _read_frame(f)
            if ftype == 0x4 and not flags & 0x1:
                s.sendall(_frame(0x4, 0x1, 0))  # ack the server's SETTINGS
            elif ftype == 0x1 and sid == 1:
                status = int(dict(dec.decode(payload))[b":status"])
                if flags & 0x1:
                    break
            elif ftype == 0x0 and sid == 1:
                body += payload
                if flags & 0x1:
                    break
        s.sendall(_frame(0x7, 0, 0, struct.pack(">II", 0, 0)))  # GOAWAY
        return status, body
