"""The HTTP layer's copied modules, held to the same cases in both packages:
HPACK, HTTP/2's upgrade-settings decoding, auth, W3C traceparent, the
metrics exposition, the phase ledger, the route table and rendering. Each
case runs once against the JAX package's module and once against the
port's; the same case must pass on both. Cross-package cases feed one
package's output to the other's input."""

from __future__ import annotations

import hashlib
import importlib
import json

import pytest

PKGS = ("oryx_tpu", "oryx_tpu_torch")


def mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


# -- HPACK (RFC 7541) ---------------------------------------------------------

# RFC 7541 C.3: three requests on one connection, no Huffman coding
RFC_C3 = [
    ("828684410f7777772e6578616d706c652e636f6d",
     [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
      (b":authority", b"www.example.com")]),
    ("828684be58086e6f2d6361636865",
     [(b":method", b"GET"), (b":scheme", b"http"), (b":path", b"/"),
      (b":authority", b"www.example.com"), (b"cache-control", b"no-cache")]),
    ("828785bf400a637573746f6d2d6b65790c637573746f6d2d76616c7565",
     [(b":method", b"GET"), (b":scheme", b"https"), (b":path", b"/index.html"),
      (b":authority", b"www.example.com"), (b"custom-key", b"custom-value")]),
]

# RFC 7541 C.4: the same requests, Huffman coded
RFC_C4 = [
    "828684418cf1e3c2e5f23a6ba0ab90f4ff",
    "828684be5886a8eb10649cbf",
    "828785bf408825a849e95ba97d7f8925a849e95bb8e8b4bf",
]


@pytest.mark.parametrize("pkg", PKGS)
def test_hpack_decodes_rfc7541_examples(pkg):
    hpack = mod(pkg, "serving.hpack")
    plain, huff = hpack.Decoder(), hpack.Decoder()
    for (hexblock, want), hexhuff in zip(RFC_C3, RFC_C4):
        assert plain.decode(bytes.fromhex(hexblock)) == want
        assert huff.decode(bytes.fromhex(hexhuff)) == want


@pytest.mark.parametrize("enc_pkg", PKGS)
@pytest.mark.parametrize("dec_pkg", PKGS)
def test_hpack_round_trip_across_packages(enc_pkg, dec_pkg):
    headers = [(b":status", b"200"), (b"content-type", b"application/json"),
               (b"vary", b"Accept-Encoding"), (b"x-long", b"v" * 300),
               (b"content-length", b"12345")]
    block = mod(enc_pkg, "serving.hpack").encode(headers)
    assert mod(dec_pkg, "serving.hpack").Decoder().decode(block) == headers


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("value,prefix", [(10, 5), (1337, 5), (42, 8), (0, 7),
                                          (2 ** 20, 4)])
def test_hpack_integers(pkg, value, prefix):
    hpack = mod(pkg, "serving.hpack")
    raw = hpack.encode_int(value, prefix)
    assert hpack.decode_int(raw, 0, prefix) == (value, len(raw))


@pytest.mark.parametrize("pkg", PKGS)
def test_hpack_rejects_a_bad_index(pkg):
    hpack = mod(pkg, "serving.hpack")
    with pytest.raises(hpack.HpackError):
        hpack.Decoder().decode(bytes([0x80 | 0x7E]))  # index 126: no entry


# -- HTTP/2 upgrade settings ---------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("value,want", [
    ("", b""),
    ("AAMAAABkAAQAAP__", bytes.fromhex("00030000006400040000ffff")),
    ("AAMAAABkAAQAAP__==", bytes.fromhex("00030000006400040000ffff")),
    ("AAMAAABkAAQAAP//", None),    # standard alphabet, not base64url
    ("AAMAAABk!AQAAP__", None),    # outside the alphabet
    ("AAMAAA", None),              # 4 bytes: not a multiple of 6
])
def test_h2c_settings_decoding(pkg, value, want):
    assert mod(pkg, "serving.http2").decode_h2c_settings(value) == want


# -- auth -----------------------------------------------------------------------

def _digest_header(user, password, method, uri, challenge, nc="00000001",
                   cnonce="0a4f113b"):
    p = dict(kv.split("=", 1) for kv in
             (part.strip() for part in challenge[len("Digest "):].split(",")))
    p = {k: v.strip('"') for k, v in p.items()}
    md5 = lambda s: hashlib.md5(s.encode()).hexdigest()
    ha1 = md5(f"{user}:{p['realm']}:{password}")
    ha2 = md5(f"{method}:{uri}")
    resp = md5(f"{ha1}:{p['nonce']}:{nc}:{cnonce}:auth:{ha2}")
    return (f'Digest username="{user}", realm="{p["realm"]}", '
            f'nonce="{p["nonce"]}", uri="{uri}", qop=auth, nc={nc}, '
            f'cnonce="{cnonce}", response="{resp}", opaque="{p["opaque"]}"')


@pytest.mark.parametrize("pkg", PKGS)
def test_digest_auth(pkg):
    auth = mod(pkg, "serving.auth")
    a = auth.DigestAuthenticator("oryx", "pass", secret=b"k" * 32)
    challenge = a.check("GET", "/ready", None)
    assert isinstance(challenge, str) and challenge.startswith("Digest ")
    ok = _digest_header("oryx", "pass", "GET", "/ready", challenge)
    assert a.check("GET", "/ready", ok) is True
    bad = _digest_header("oryx", "wrong", "GET", "/ready", challenge)
    assert a.check("GET", "/ready", bad) is not True
    # a response computed for another target is refused
    assert a.check("GET", "/metrics", ok) is not True


@pytest.mark.parametrize("pkg", PKGS)
def test_basic_auth_and_config(pkg):
    auth = mod(pkg, "serving.auth")
    config = mod(pkg, "common.config")
    a = auth.BasicAuthenticator("oryx", "pass")
    assert a.check("GET", "/", "Basic b3J5eDpwYXNz") is True
    assert a.check("GET", "/", "Basic b3J5eDp4") == 'Basic realm="Oryx"'
    assert auth.make_authenticator(config.load_config()) is None
    made = auth.make_authenticator(config.load_config(overlay={
        "oryx.serving.api.user-name": "u", "oryx.serving.api.password": "p",
        "oryx.serving.api.auth-scheme": "basic"}))
    assert isinstance(made, auth.BasicAuthenticator)


# -- tracing ----------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("value,ok", [
    ("00-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01", True),
    ("00-4BF92F3577B34DA6A3CE929D0E0E4736-00f067aa0ba902b7-01", True),
    ("00-00000000000000000000000000000000-00f067aa0ba902b7-01", False),
    ("00-4bf92f3577b34da6a3ce929d0e0e4736-0000000000000000-01", False),
    ("ff-4bf92f3577b34da6a3ce929d0e0e4736-00f067aa0ba902b7-01", False),
    ("garbage", False),
    (None, False),
])
def test_traceparent(pkg, value, ok):
    tracing = mod(pkg, "common.tracing")
    ctx = tracing.parse_traceparent(value)
    assert (ctx is not None) == ok
    if ok:
        assert ctx.trace_id == "4bf92f3577b34da6a3ce929d0e0e4736"
        assert tracing.format_traceparent(ctx.trace_id, ctx.span_id) == \
            value.lower()


@pytest.mark.parametrize("pkg", PKGS)
def test_span_forest_and_chrome_export(pkg):
    tracing = mod(pkg, "common.tracing")
    tr = tracing.Tracer(capacity=16)
    tr.configure(enabled=True)
    root = tr.start("http.request", method="GET")
    child = tr.start("http.dispatch", parent=root)
    tr.finish(child, status=200)
    tr.finish(root, status=200)
    spans = tr.snapshot()
    forest = tracing.span_forest(spans)
    assert [r["name"] for r in forest] == ["http.request"]
    assert [c["name"] for c in forest[0]["children"]] == ["http.dispatch"]
    events = tracing.chrome_trace(spans)["traceEvents"]
    assert {e["name"] for e in events} == {"http.request", "http.dispatch"}


# -- metrics exposition -------------------------------------------------------------

def _fill(metrics_mod):
    reg = metrics_mod.MetricsRegistry()
    c = reg.counter("oryx_t_requests_total", "Requests by status", labeled=True)
    c.inc(status="200")
    c.inc(2, status="503")
    reg.gauge("oryx_t_depth", "Queue depth").set(3.5)
    h = reg.histogram("oryx_t_seconds", "Latency", buckets=(0.1, 1.0))
    h.observe(0.05, trace_id="4bf92f3577b34da6a3ce929d0e0e4736")
    h.observe(0.5)
    h.observe(7.0)
    return reg


@pytest.mark.parametrize("openmetrics", [False, True])
def test_metrics_rendering_is_the_same_in_both(openmetrics):
    texts = [_fill(mod(pkg, "common.metrics")).render_prometheus(openmetrics)
             for pkg in PKGS]
    exemplar = "# {trace_id=" in texts[1]
    assert exemplar == openmetrics  # exemplars ride OpenMetrics only
    # exemplar timestamps differ between the two fills
    strip = lambda t: [ln.split(" # ")[0] for ln in t.splitlines()]
    assert strip(texts[0]) == strip(texts[1])


@pytest.mark.parametrize("pkg", PKGS)
def test_metrics_text_format(pkg):
    text = _fill(mod(pkg, "common.metrics")).render_prometheus()
    assert '# TYPE oryx_t_requests_total counter' in text
    assert 'oryx_t_requests_total{status="503"} 2' in text
    assert 'oryx_t_seconds_bucket{le="1"} 2' in text
    assert 'oryx_t_seconds_bucket{le="+Inf"} 3' in text
    assert 'oryx_t_depth 3.5' in text


# -- phase ledger -------------------------------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_phase_ledger(pkg):
    perfattr = mod(pkg, "common.perfattr")
    ledger = perfattr.PhaseLedger()
    ledger.add("parse", 0.002, start=10.0)
    ledger.add("device", 0.010, start=10.004)
    ledger.add("write", -1.0)  # clock skew: dropped
    assert [p for p, _s, _d in ledger.items()] == ["parse", "device"]
    assert ledger.last_end() == pytest.approx(10.014)
    prev = perfattr.swap_ledger(ledger)
    assert perfattr.current_ledger() is ledger
    perfattr.swap_ledger(prev)


# -- routes and rendering (ServingApp) ---------------------------------------------

class _Model:
    def fraction_loaded(self):
        return 1.0


def _app(pkg, tmp_path):
    app_mod = mod(pkg, "serving.app")
    api = mod(pkg, "api")
    config = mod(pkg, "common.config")

    class Manager(api.ServingModelManager):
        def consume(self, updates):
            pass

        def get_model(self):
            return _Model()

    cfg = config.load_config(overlay={
        "oryx.serving.application-resources": [],
        "oryx.serving.api.context-path": "/ctx",
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
    })
    app = app_mod.ServingApp(cfg, Manager(cfg))

    @app.route("GET", "/items/{id}", nonblocking=True)
    def item(a, req):
        return [[req.params["id"], 1.5], ["b", 2]]

    @app.route("GET", "/items/all")
    def all_items(a, req):
        return {"n": 2}

    @app.route("GET", "/{tail:rest}")
    def fallback(a, req):
        raise app_mod.ShedLoad("busy", retry_after_sec=3)

    return app_mod, app


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("method,path,accept,want", [
    ("GET", "/ctx/items/x%20y", "application/json",
     (200, b'[["x y", 1.5], ["b", 2]]', "application/json")),
    ("GET", "/ctx/items/x", "text/csv", (200, b"x,1.5\nb,2\n", "text/csv")),
    ("GET", "/ctx/items/all", "", (200, b'{"n": 2}', "application/json")),
    ("POST", "/ctx/items/x", "text/csv",
     (405, b"405 method not allowed\n", "text/plain")),
    ("GET", "/elsewhere", "application/json",
     (404, b'{"status": 404, "error": "outside context path /ctx"}',
      "application/json")),
    ("GET", "/ctx/other/path", "application/json",
     (503, b'{"status": 503, "error": "busy"}', "application/json")),
])
def test_routing_and_rendering(pkg, method, path, accept, want, tmp_path):
    app_mod, app = _app(pkg, tmp_path)
    req = app_mod.Request(method=method, path=path, params={}, query={},
                          body=b"", headers={"accept": accept})
    assert app.dispatch(req) == want
    if want[0] == 503:
        assert ("Retry-After", "3") in req.response_headers


@pytest.mark.parametrize("pkg", PKGS)
def test_fast_segments(pkg, tmp_path):
    _app_mod, app = _app(pkg, tmp_path)
    # a blocking param-first route makes every path a worker-pool path
    assert not app.is_fast("/ctx/items/x")
    assert app._exact_routes[("GET", "/items/all")].handler.__name__ == \
        "all_items"


@pytest.mark.parametrize("pkg", PKGS)
def test_deferred_results_render_at_completion(pkg, tmp_path):
    from concurrent.futures import Future

    app_mod, app = _app(pkg, tmp_path)

    @app.route("GET", "/later/{id}")
    def later(a, req):
        return app_mod.deferred_map(fut, lambda v: [[req.params["id"], v]])

    fut = Future()
    req = app_mod.Request(method="GET", path="/ctx/later/q", params={},
                          query={}, body=b"", headers={"accept": "text/csv"})
    out = app.dispatch_nowait(req)
    assert isinstance(out, app_mod.Deferred) and not out.future.done()
    fut.set_result(0.25)
    assert out.future.result(timeout=5) == (200, b"q,0.25\n", "text/csv")
    assert json.loads(app_mod._render_error(
        500, "x", app_mod.Request("GET", "/", {}, {}, b"", {}))[1]) == {
            "status": 500, "error": "x"}


# -- HTTP/2 framing through each package's async frontend ---------------------

def _h2_frame(ftype: int, flags: int, sid: int, payload: bytes = b"") -> bytes:
    import struct

    return (struct.pack(">I", len(payload))[1:] + bytes([ftype, flags])
            + struct.pack(">I", sid) + payload)


def _h2_responses(sock, hpack, want: set[int]) -> dict[int, tuple]:
    """Read frames until every stream in ``want`` has ended: {stream id:
    (headers, body)}. Acks the server's SETTINGS."""
    f = sock.makefile("rb")
    dec, heads, bodies, ended = hpack.Decoder(), {}, {}, set()
    settings_seen = False
    while not want <= ended:
        head = f.read(9)
        assert len(head) == 9, "connection closed mid-frame"
        length = int.from_bytes(head[:3], "big")
        ftype, flags = head[3], head[4]
        sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
        payload = f.read(length)
        if ftype == 0x4 and not flags & 0x1:  # SETTINGS, not an ack
            settings_seen = True
            sock.sendall(_h2_frame(0x4, 0x1, 0))
        elif ftype == 0x1:  # HEADERS
            heads[sid] = dict(dec.decode(payload))
            if flags & 0x1:
                ended.add(sid)
        elif ftype == 0x0:  # DATA
            bodies[sid] = bodies.get(sid, b"") + payload
            if flags & 0x1:
                ended.add(sid)
    assert settings_seen
    return {sid: (heads[sid], bodies.get(sid, b"")) for sid in want}


@pytest.mark.parametrize("pkg", PKGS)
def test_h2_streams_and_h2c_upgrade(pkg, tmp_path):
    """Prior knowledge: two GET streams opened before either is read, and a
    POST whose body rides a DATA frame; then an h2c upgrade, whose HTTP/1.1
    request becomes stream 1. Each answer equals the route's rendering."""
    import socket

    hpack = mod(pkg, "serving.hpack")
    aserver = mod(pkg, "serving.aserver")
    app_mod, app = _app(pkg, tmp_path)

    @app.route("POST", "/echo")
    def echo(a, req):
        return {"got": req.body_text()}

    server = aserver.AsyncHTTPServer(app, None, 0, workers=4, loops=1)
    server.start()
    try:
        with socket.create_connection(("127.0.0.1", server.port), 30) as s:
            s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n" + _h2_frame(0x4, 0, 0))

            def headers(sid, method, path, end):
                block = hpack.encode([
                    (b":method", method), (b":scheme", b"http"),
                    (b":path", path), (b":authority", b"localhost"),
                    (b"accept", b"application/json")])
                s.sendall(_h2_frame(0x1, 0x4 | (0x1 if end else 0), sid,
                                    block))

            headers(1, b"GET", b"/ctx/items/a", True)
            headers(3, b"GET", b"/ctx/items/b", True)
            headers(5, b"POST", b"/ctx/echo", False)
            s.sendall(_h2_frame(0x0, 0x1, 5, b"hello h2"))
            got = _h2_responses(s, hpack, {1, 3, 5})
            s.sendall(_h2_frame(0x7, 0, 0, bytes(8)))  # GOAWAY
        assert got[1][0][b":status"] == b"200"
        assert json.loads(got[1][1]) == [["a", 1.5], ["b", 2]]
        assert json.loads(got[3][1]) == [["b", 1.5], ["b", 2]]
        assert json.loads(got[5][1]) == {"got": "hello h2"}
        assert got[5][0][b"content-type"] == b"application/json"

        with socket.create_connection(("127.0.0.1", server.port), 30) as s:
            s.sendall(b"GET /ctx/items/c HTTP/1.1\r\nHost: localhost\r\n"
                      b"Accept: text/csv\r\n"
                      b"Connection: Upgrade, HTTP2-Settings\r\n"
                      b"Upgrade: h2c\r\nHTTP2-Settings: AAMAAABkAAQAAP__\r\n\r\n")
            line = b""
            while not line.endswith(b"\r\n\r\n"):
                chunk = s.recv(1)
                assert chunk, "closed before the 101"
                line += chunk
            assert line.startswith(b"HTTP/1.1 101")
            s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n" + _h2_frame(0x4, 0, 0))
            up = _h2_responses(s, hpack, {1})
            s.sendall(_h2_frame(0x7, 0, 0, bytes(8)))
        assert up[1][0][b":status"] == b"200"
        assert up[1][1] == b"c,1.5\nb,2\n"
    finally:
        server.close()
