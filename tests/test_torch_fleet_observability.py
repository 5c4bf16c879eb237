"""The port's fleet observability plane held to
tests/test_fleet_observability.py, case for case: cross-process trace
stitching, metrics federation with exemplar fidelity, the /fleet/status
NaN rule, and one real two-replica end to end run of the port's serving
processes on the CPU (``oryx.compute.platform = cpu``): ONE stitched trace
holding front-hop and replica-side spans under the same trace id, and a
federated OpenMetrics page that strict parsers round-trip."""

from __future__ import annotations

import http.client
import json
import math
import os
import subprocess
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.tracing import (
    flatten_forest,
    get_tracer,
    stitch_traces,
    stitched_chrome,
)
from oryx_tpu_torch.fleet import FleetFront
from oryx_tpu_torch.fleet.observe import federate, inject_label, parse_exposition


# ---- federation text merging (units) ---------------------------------------


def test_inject_label_shapes():
    assert inject_label("m 1", "replica", "r0") == 'm{replica="r0"} 1'
    assert (
        inject_label('m{a="b"} 1', "replica", "r0")
        == 'm{replica="r0",a="b"} 1'
    )
    assert inject_label("m{} 1", "replica", "r0") == 'm{replica="r0"} 1'
    # a sample already carrying the label keeps its own
    assert (
        inject_label('m{replica="own"} 1', "replica", "r0")
        == 'm{replica="own"} 1'
    )
    # exemplar braces after the value are NOT the labelset
    line = 'm_bucket{le="0.1"} 3 # {trace_id="ff"} 0.05 1.5'
    assert inject_label(line, "replica", "r1") == (
        'm_bucket{replica="r1",le="0.1"} 3 # {trace_id="ff"} 0.05 1.5'
    )
    # a label name merely ENDING in "replica" is not the replica label —
    # a substring match here would collide two replicas' series into one
    assert inject_label('m{shard_replica="1"} 3', "replica", "r0") == (
        'm{replica="r0",shard_replica="1"} 3'
    )


def test_federate_dedupes_family_metadata():
    page = "# HELP m help text\n# TYPE m gauge\nm 1\n"
    merged = federate([("r0", page), ("r1", page)])
    assert merged.count("# TYPE m gauge") == 1
    assert merged.count("# HELP m help text") == 1
    assert 'm{replica="r0"} 1' in merged
    assert 'm{replica="r1"} 1' in merged


def test_federate_union_keeps_one_sided_families():
    merged = federate([
        ("r0", "# TYPE only_r0 counter\nonly_r0_total 1\n"),
        ("r1", "# TYPE only_r1 gauge\nonly_r1 2\n"),
    ])
    assert 'only_r0_total{replica="r0"} 1' in merged
    assert 'only_r1{replica="r1"} 2' in merged


def test_parse_exposition_stops_at_eof():
    fams, order = parse_exposition("# TYPE m gauge\nm 1\n# EOF\nnoise 2\n")
    assert order == ["m"] and "noise" not in fams


def test_federated_openmetrics_round_trips_strict_parser():
    """The merged page must survive
    prometheus_client's strict OpenMetrics parser with exemplars intact
    and the replica label on every series."""
    parser = pytest.importorskip("prometheus_client.openmetrics.parser")
    from oryx_tpu_torch.common.metrics import MetricsRegistry

    pages = []
    for rid, trace in (("r0", "aa" * 16), ("r1", "bb" * 16)):
        reg = MetricsRegistry()
        reg.counter(
            "oryx_serving_requests_total", "reqs", labeled=True
        ).inc(method="GET", status="200")
        reg.histogram("oryx_serving_request_seconds", "lat").observe(
            0.003, trace_id=trace, method="GET"
        )
        pages.append((rid, reg.render_prometheus(openmetrics=True)))
    merged = federate(pages, openmetrics=True)
    fams = {f.name: f for f in parser.text_string_to_metric_families(merged)}
    assert set(fams) == {
        "oryx_serving_requests", "oryx_serving_request_seconds",
    }
    exemplars = {
        s.labels["replica"]: s.exemplar.labels["trace_id"]
        for s in fams["oryx_serving_request_seconds"].samples
        if s.exemplar
    }
    assert exemplars == {"r0": "aa" * 16, "r1": "bb" * 16}
    for f in fams.values():
        for s in f.samples:
            assert s.labels.get("replica") in ("r0", "r1")


# ---- stitching (units) -----------------------------------------------------


def _node(name, trace, span, parent=None, start=1.0, children=()):
    return {
        "name": name, "trace_id": trace, "span_id": span,
        "parent_id": parent, "start_ms": start, "duration_ms": 2.0,
        "attrs": {}, "children": list(children),
    }


def test_stitch_groups_by_trace_and_labels_processes():
    t = "t" * 32
    front = [_node("front.route", t, "f1", start=1.0,
                   children=[_node("front.proxy", t, "f2", "f1", 1.2)])]
    replica = [_node("http.request", t, "r1", "f2", 1.3)]
    other = [_node("http.request", "u" * 32, "x1", start=9.0)]
    traces = stitch_traces([("front", front), ("r0", replica + other)])
    by_id = {x["trace_id"]: x for x in traces}
    assert by_id[t]["processes"] == ["front", "r0"]
    assert [s["name"] for s in by_id[t]["spans"]] == [
        "front.route", "front.proxy", "http.request",
    ]
    assert by_id["u" * 32]["processes"] == ["r0"]


def test_stitch_dedupes_shared_rings():
    # co-resident processes (tests) can return overlapping rings; a span
    # id must appear once in the stitched trace
    t = "t" * 32
    span = _node("http.request", t, "s1")
    traces = stitch_traces([("front", [span]), ("r0", [dict(span)])])
    assert len(traces[0]["spans"]) == 1


def test_stitched_chrome_gives_each_process_a_lane():
    t = "t" * 32
    doc = stitched_chrome([
        ("front", [_node("front.route", t, "f1")]),
        ("r0", [_node("http.request", t, "r1", "f1")]),
    ])
    names = {
        e["args"]["name"] for e in doc["traceEvents"]
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    assert names == {"front", "r0"}
    x_pids = {e["pid"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert len(x_pids) == 2  # one lane per process


def test_flatten_forest_strips_children():
    t = "t" * 32
    flat = flatten_forest(
        [_node("a", t, "1", children=[_node("b", t, "2", "1")])]
    )
    assert {s["name"] for s in flat} == {"a", "b"}
    assert all("children" not in s for s in flat)


# ---- front endpoints against stub replicas ---------------------------------


class _StubReplica:
    """Scripted backend serving /healthz, /metrics, /debug/traces, and a
    catch-all that records the traceparent it was forwarded."""

    def __init__(self, rid: str):
        self.rid = rid
        self.seen_traceparent: dict[str, str | None] = {}
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    body = b'{"status":"up","degraded":[]}'
                elif self.path == "/metrics":
                    om = "application/openmetrics-text" in (
                        self.headers.get("accept") or ""
                    )
                    text = (
                        "# HELP oryx_stub_up help\n# TYPE oryx_stub_up gauge\n"
                        f'oryx_stub_up{{src="{stub.rid}"}} 1\n'
                    )
                    body = (text + ("# EOF\n" if om else "")).encode()
                elif self.path.startswith("/debug/traces"):
                    body = json.dumps({"traces": [
                        {"name": "http.request", "trace_id": "ab" * 16,
                         "span_id": stub.rid * 4, "parent_id": None,
                         "start_ms": 5.0, "duration_ms": 1.0, "attrs": {},
                         "children": []},
                    ]}).encode()
                else:
                    stub.seen_traceparent[self.path] = self.headers.get(
                        "traceparent"
                    )
                    body = b'{"ok":true}'
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _front_for(tmp_path, backends, **overlay):
    cfg = load_config(overlay={
        "oryx.fleet.front.probe-interval-sec": 0.2,
        "oryx.monitoring.flight.dir": str(tmp_path / "front-flight"),
        **overlay,
    })
    front = FleetFront(
        cfg,
        backends=[(s.rid, "127.0.0.1", s.port) for s in backends],
        port=0,
    )
    front.start()
    return front


def _get(port, path, headers=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path, headers=headers or {})
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def test_fleet_status_renders_nan_gauges_as_null(tmp_path):
    """A NaN per-replica gauge (mfu on a peak-less host) must render null, not bare NaN — pinned with a strict
    json.loads that rejects NaN tokens."""
    a = _StubReplica("r0")
    front = _front_for(tmp_path, [a])
    try:
        front.replicas[0].mfu = float("nan")
        front.replicas[0].staleness_seconds = float("inf")
        status, _, body = _get(front.port, "/fleet/status")
        assert status == 200
        assert b"NaN" not in body and b"Infinity" not in body
        doc = json.loads(
            body.decode(),
            parse_constant=lambda s: (_ for _ in ()).throw(ValueError(s)),
        )
        assert doc["replicas"][0]["mfu"] is None
        assert doc["replicas"][0]["staleness_seconds"] is None
    finally:
        front.close()
        a.close()


def test_fleet_metrics_federates_with_replica_labels(tmp_path):
    a, b = _StubReplica("r0"), _StubReplica("r1")
    front = _front_for(tmp_path, [a, b])
    try:
        status, headers, body = _get(front.port, "/fleet/metrics")
        assert status == 200
        assert headers["Content-Type"].startswith("text/plain")
        text = body.decode()
        assert text.count("# TYPE oryx_stub_up gauge") == 1
        assert 'oryx_stub_up{replica="r0",src="r0"} 1' in text
        assert 'oryx_stub_up{replica="r1",src="r1"} 1' in text
        # OpenMetrics negotiation passes through and terminates with EOF
        status, headers, body = _get(
            front.port, "/fleet/metrics",
            headers={"Accept": "application/openmetrics-text"},
        )
        assert headers["Content-Type"].startswith(
            "application/openmetrics-text"
        )
        assert body.decode().rstrip().endswith("# EOF")
    finally:
        front.close()
        a.close()
        b.close()


def test_fleet_metrics_skips_dead_replica_and_counts_it(tmp_path):
    a = _StubReplica("r0")
    dead = _StubReplica("r1")
    front = _front_for(
        tmp_path, [a, dead],
        **{"oryx.fleet.front.probe-interval-sec": 30},  # r1 stays "routable"
    )
    dead.close()  # port now refuses connections
    try:
        status, _, body = _get(front.port, "/fleet/metrics")
        assert status == 200
        assert 'oryx_stub_up{replica="r0",src="r0"} 1' in body.decode()
        assert front._m_fed_errors.value(endpoint="/metrics", replica="r1") >= 1
    finally:
        front.close()
        a.close()


def test_fleet_traces_excludes_ejected_replicas(tmp_path):
    a, b = _StubReplica("r0"), _StubReplica("r1")
    front = _front_for(
        tmp_path, [a, b], **{"oryx.fleet.front.eject-after": 1}
    )
    try:
        b.close()  # r1 dies; prober ejects it
        deadline = time.time() + 10
        while front.replicas[1].routable:
            assert time.time() < deadline
            time.sleep(0.05)
        status, _, body = _get(front.port, "/fleet/traces")
        doc = json.loads(body)
        assert "r0" in doc["processes"] and "r1" not in doc["processes"]
    finally:
        front.close()
        a.close()


def test_front_originates_and_injects_traceparent(tmp_path):
    a = _StubReplica("r0")
    front = _front_for(
        tmp_path, [a], **{"oryx.monitoring.tracing.enabled": True}
    )
    try:
        # client sent NO traceparent: the front originates one
        status, headers, _ = _get(front.port, "/x/originate")
        assert status == 200
        tp = a.seen_traceparent["/x/originate"]
        assert tp and tp.startswith("00-")
        # client DID send one: same trace id, front's own span id
        client_trace = "cd" * 16
        _get(front.port, "/x/join", headers={
            "traceparent": f"00-{client_trace}-{'ab' * 8}-01",
        })
        tp = a.seen_traceparent["/x/join"]
        assert tp is not None and tp.split("-")[1] == client_trace
        assert tp.split("-")[2] != "ab" * 8  # the front's hop, not the client's
        # the front's own ring now holds the joined front.route tree.
        # Bounded wait: the route span finishes in the handler's finally
        # AFTER the response bytes drain, so a client can legitimately
        # read the full response a tick before the span lands in the ring
        deadline = time.time() + 5
        while True:
            spans = [
                s for s in get_tracer().snapshot()
                if s.trace_id == client_trace
            ]
            if {s.name for s in spans} >= {"front.route", "front.proxy"}:
                break
            assert time.time() < deadline, {s.name for s in spans}
            time.sleep(0.02)
        # /fleet/traces stitches the stub's foreign spans + the front's
        status, _, body = _get(front.port, "/fleet/traces")
        doc = json.loads(body)
        assert doc["enabled"] is True
        ids = {t["trace_id"] for t in doc["traces"]}
        assert client_trace in ids and "ab" * 16 in ids
        # chrome export is lane-per-process
        status, _, body = _get(front.port, "/fleet/traces?format=chrome")
        chrome = json.loads(body)
        lanes = {
            e["args"]["name"] for e in chrome["traceEvents"]
            if e.get("name") == "process_name"
        }
        assert lanes == {"front", "r0"}
    finally:
        front.close()
        a.close()
        get_tracer().configure(enabled=False)


def test_untraced_front_forwards_client_traceparent_verbatim(tmp_path):
    a = _StubReplica("r0")
    front = _front_for(tmp_path, [a])  # tracing off (default)
    try:
        tp = f"00-{'ee' * 16}-{'ff' * 8}-01"
        _get(front.port, "/x/passthrough", headers={"traceparent": tp})
        assert a.seen_traceparent["/x/passthrough"] == tp
    finally:
        front.close()
        a.close()


# ---- real two-replica e2e (the acceptance criterion) -----------------------


def _model_message(gen: int) -> str:
    import numpy as np

    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(gen)
    n_users, n_items, f = 32, 64, 4
    art = ModelArtifact(
        "als",
        extensions={
            "features": str(f), "lambda": "0.001", "alpha": "1.0",
            "implicit": "true", "logStrength": "false",
        },
        tensors={
            "X": rng.standard_normal((n_users, f), dtype=np.float32),
            "Y": rng.standard_normal((n_items, f), dtype=np.float32),
        },
    )
    art.set_extension("XIDs", [f"u{j}" for j in range(n_users)])
    art.set_extension("YIDs", [f"i{j}" for j in range(n_items)])
    return art.to_string()


def test_two_replica_front_yields_one_stitched_trace_and_exemplars(tmp_path):
    """A traced request through a 2-replica front of the port's replicas
    (on the CPU, as the platform overlay asks)
    yields ONE stitched trace on /fleet/traces containing front-hop and
    replica-side (request + batcher device) spans under the same trace
    id, Perfetto-loadable under ?format=chrome; and the traced request's
    trace id appears in the same latency bucket's exemplar on the
    federated OpenMetrics page as on the replica's own /metrics."""
    parser = pytest.importorskip("prometheus_client.openmetrics.parser")
    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common.executil import (
        config_overlay_from_sets, free_port_run,
    )
    from oryx_tpu_torch.common.freshness import publish_stamp
    from oryx_tpu_torch.fleet import FleetSupervisor

    bus = f"file://{tmp_path / 'bus'}"
    topics.maybe_create(bus, "OryxInput", 1)
    topics.maybe_create(bus, "OryxUpdate", 1)
    broker = get_broker(bus)
    broker.send("OryxUpdate", "MODEL", _model_message(1))
    broker.send("OryxUpdate", "TRACE", publish_stamp(generation=1))

    base_port = free_port_run(2)
    sets = [
        "oryx.id=obs-e2e",
        f"oryx.input-topic.broker={bus}",
        f"oryx.update-topic.broker={bus}",
        "oryx.serving.model-manager-class="
        "oryx_tpu_torch.apps.als.serving.ALSServingModelManager",
        'oryx.serving.application-resources='
        '["oryx_tpu_torch.serving.resources.common",'
        '"oryx_tpu_torch.serving.resources.als"]',
        "oryx.compute.platform=cpu",
        "oryx.serving.api.read-only=true",
        "oryx.serving.api.loops=1",
        "oryx.fleet.replicas=2",
        f"oryx.fleet.base-port={base_port}",
        f"oryx.fleet.data-dir={tmp_path / 'fleet'}",
        "oryx.fleet.front.probe-interval-sec=0.3",
        # the whole fleet traces: children AND the front
        "oryx.monitoring.tracing.enabled=true",
        f"oryx.monitoring.flight.dir={tmp_path / 'front-flight'}",
    ]
    cfg = load_config(overlay=config_overlay_from_sets(sets))
    argv = [x for s in sets for x in ("--set", s)]
    sup = FleetSupervisor(
        cfg, argv=argv,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    front = None
    try:
        sup.start()
        sup.wait_listening(90)
        for _, host, port in sup.backends():
            deadline = time.time() + 60
            while True:
                c = http.client.HTTPConnection(host, port, timeout=5)
                c.request("GET", "/ready")
                r = c.getresponse()
                r.read()
                c.close()
                if r.status == 200:
                    break
                assert time.time() < deadline, f"replica :{port} never ready"
                time.sleep(0.3)
        front = FleetFront(cfg, backends=sup.backends(), port=0)
        front.start()

        trace_id = os.urandom(16).hex()
        status, headers, body = _get(
            front.port, "/recommend/u1?howMany=3",
            headers={"traceparent": f"00-{trace_id}-{'12' * 8}-01"},
        )
        assert status == 200, (status, body)
        # the replica's response traceparent rode through the front and
        # stayed in OUR trace
        assert headers.get("traceparent", "").split("-")[1] == trace_id

        # ONE stitched trace holding front-hop AND replica-side spans
        stitched = None
        deadline = time.time() + 20
        while time.time() < deadline:
            status, _, body = _get(front.port, "/fleet/traces")
            doc = json.loads(body)
            match = [t for t in doc["traces"] if t["trace_id"] == trace_id]
            if match:
                names = {s["name"] for s in match[0]["spans"]}
                if {"front.route", "http.request", "batcher.device"} <= names:
                    stitched = match[0]
                    break
            time.sleep(0.3)
        assert stitched is not None, "stitched trace never materialized"
        assert "front" in stitched["processes"]
        replica_procs = [p for p in stitched["processes"] if p != "front"]
        assert len(replica_procs) == 1  # one replica answered
        rid = replica_procs[0]
        by_proc = {}
        for s in stitched["spans"]:
            by_proc.setdefault(s["process"], set()).add(s["name"])
        assert {"front.route", "front.proxy"} <= by_proc["front"]
        assert {"http.request", "http.dispatch", "batcher.device"} <= by_proc[rid]

        # Perfetto-loadable chrome export: our trace's events span 2 lanes
        status, _, body = _get(front.port, "/fleet/traces?format=chrome")
        chrome = json.loads(body)
        pids = {
            e["pid"] for e in chrome["traceEvents"]
            if e.get("ph") == "X" and e["args"].get("trace_id") == trace_id
        }
        assert len(pids) == 2, "front and replica must be separate lanes"

        # exemplar fidelity through federation (OpenMetrics negotiation)
        om = {"Accept": "application/openmetrics-text"}
        ports = dict(
            (replica_id, port) for replica_id, _, port in sup.backends()
        )

        def _exemplars(text, tid, replica):
            fams = {
                f.name: f
                for f in parser.text_string_to_metric_families(text)
            }
            out = {}
            fam = fams.get("oryx_serving_request_seconds")
            for s in (fam.samples if fam else ()):
                if s.exemplar and s.exemplar.labels.get("trace_id") == tid:
                    if replica is not None:
                        assert s.labels.get("replica") == replica
                    out[s.labels["le"]] = s.exemplar.labels["trace_id"]
            return out

        def _own(replica, tid):
            c = http.client.HTTPConnection("127.0.0.1", ports[replica], timeout=10)
            c.request("GET", "/metrics", headers=om)
            page = c.getresponse().read().decode()
            c.close()
            return _exemplars(page, tid, None)

        # A bucket's exemplar is its latest traced observation, and the
        # front's /healthz probes and these scrapes are traced requests
        # too: a round whose own exemplar changed between the own scrapes
        # taken before and after the federated one compares nothing, and
        # runs again with a fresh traced request.
        tid, who, compared = trace_id, rid, False
        for attempt in range(5):
            if attempt:
                tid = os.urandom(16).hex()
                status, _, _ = _get(
                    front.port, "/recommend/u1?howMany=3",
                    headers={"traceparent": f"00-{tid}-{'12' * 8}-01"},
                )
                assert status == 200
                who = next((r for r in ports if _own(r, tid)), None)
                if who is None:
                    continue
            own = _own(who, tid)
            assert own or attempt, "replica's own /metrics lost the traced exemplar"
            status, headers, body = _get(front.port, "/fleet/metrics", headers=om)
            assert headers["Content-Type"].startswith("application/openmetrics-text")
            fed = _exemplars(body.decode(), tid, who)
            if own and _own(who, tid) == own:
                assert fed == own, (
                    "the traced request's trace id must ride the SAME latency "
                    f"bucket's exemplar through federation (own={own}, fed={fed})"
                )
                compared = True
                break
        assert compared, "no round kept its exemplar across the federated scrape"
    finally:
        if front is not None:
            front.close()
        sup.stop()
        get_tracer().configure(enabled=False)
