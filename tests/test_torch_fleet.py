"""The port's fleet (oryx_tpu_torch/fleet/) held to tests/test_fleet.py,
case for case: consistent-hash ring stability, the front's retry-on-shed
and ejection semantics against scripted backends, shared model
distribution through the port's artifact relay, replica-tagged health,
supervisor overlays, drain, the elastic ring, the autoscaler and the
crash-loop give-up. No process here opens a device: the backends are
scripted HTTP servers and the supervisor's spawns are stubbed (the
process-level scenarios live in test_torch_fleet_chaos.py)."""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.fleet import FleetFront, HashRing, replica_overlays
from oryx_tpu_torch.fleet.front import ReplicaInfo  # noqa: F401 - public surface


# ---- consistent-hash ring -------------------------------------------------

KEYS = [f"user-{i}" for i in range(3000)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_grow_moves_only_the_new_nodes_slice(n):
    """Property: same user -> same replica across a
    fleet resize, except the minimal slice the new replica takes over —
    every remapped key must land on the ADDED node, and the slice should
    be ~1/(n+1) of the keyspace, nothing like a full reshuffle."""
    ring = HashRing([f"r{i}" for i in range(n)])
    before = {k: ring.lookup(k) for k in KEYS}
    ring.add(f"r{n}")
    moved = {k for k in KEYS if ring.lookup(k) != before[k]}
    assert all(ring.lookup(k) == f"r{n}" for k in moved)
    # minimal-disruption bound: expected |moved| ~ len(KEYS)/(n+1); allow
    # generous slack for hash variance, but far below "most keys moved"
    assert len(moved) <= 3.0 * len(KEYS) / (n + 1)


@pytest.mark.parametrize("n", [2, 3, 4, 5])
def test_ring_shrink_moves_only_the_removed_nodes_keys(n):
    ring = HashRing([f"r{i}" for i in range(n)])
    before = {k: ring.lookup(k) for k in KEYS}
    ring.remove("r0")
    for k in KEYS:
        if before[k] != "r0":
            assert ring.lookup(k) == before[k]
        else:
            assert ring.lookup(k) != "r0"


def test_ring_deterministic_across_instances():
    a = HashRing(["x", "y", "z"])
    b = HashRing(["z", "y", "x"])  # insertion order must not matter
    assert [a.lookup(k) for k in KEYS[:200]] == [b.lookup(k) for k in KEYS[:200]]


def test_ring_successor_walk_covers_all_nodes_once():
    ring = HashRing(["a", "b", "c"])
    seq = list(ring.lookup_seq("some-user"))
    assert sorted(seq) == ["a", "b", "c"]
    assert seq[0] == ring.lookup("some-user")


# ---- front behavior against scripted backends -----------------------------


class _StubReplica:
    """Scripted HTTP backend: /healthz answers 200; every other GET/POST
    runs the injected behavior. Counts the non-probe requests it served."""

    def __init__(self, behave, healthz: bytes = b'{"status":"up","degraded":[]}'):
        self.behave = behave
        self.healthz = healthz
        self.hits = 0
        self.lock = threading.Lock()
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):
                pass

            def _serve(self, method):
                length = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(length) if length else b""
                if self.path == "/healthz":
                    body = stub.healthz
                    self.send_response(200)
                else:
                    with stub.lock:
                        stub.hits += 1
                    status, headers, body = stub.behave(method, self.path)
                    self.send_response(status)
                    for k, v in headers:
                        self.send_header(k, v)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                self._serve("GET")

            def do_POST(self):
                self._serve("POST")

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        self.thread = threading.Thread(
            target=self.httpd.serve_forever, daemon=True
        )
        self.thread.start()

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


def _front_for(backends, **front_keys):
    overlay = {"oryx.fleet.front.probe-interval-sec": 0.2}
    overlay.update(
        {f"oryx.fleet.front.{k.replace('_', '-')}": v for k, v in front_keys.items()}
    )
    cfg = load_config(overlay=overlay)
    front = FleetFront(
        cfg,
        backends=[(f"r{i}", "127.0.0.1", s.port) for i, s in enumerate(backends)],
        port=0,
    )
    front.start()
    return front


def _get(port, path, method="GET", body=b""):
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request(method, path, body=body)
        r = c.getresponse()
        return r.status, dict(r.getheaders()), r.read()
    finally:
        c.close()


def test_front_retries_shed_on_another_replica_exactly_once():
    """A deliberate shed (503 + Retry-After) did NOT process the request:
    the front must re-place it on a different replica, the client sees
    ONE 200, and fleet-wide the request was processed exactly once."""
    shedder = _StubReplica(
        lambda m, p: (503, [("Retry-After", "1")], b'{"error":"overloaded"}')
    )
    worker = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'))
    front = _front_for([shedder, worker])
    try:
        # drive enough requests that round-robin hits the shedder first at
        # least once (rr order is request-arrival dependent)
        oks = 0
        for i in range(8):
            status, headers, body = _get(front.port, f"/recommend/u{i}")
            assert status == 200, (status, body)
            assert body == b'{"ok":true}'
            oks += 1
        assert worker.hits == oks  # every request answered exactly once
        assert shedder.hits >= 1  # the shed path actually exercised
        retries = front._m_retries.value(reason="shed")
        assert retries == shedder.hits  # one re-placement per shed, no loops
    finally:
        front.close()
        shedder.close()
        worker.close()


def test_front_retries_a_replica_whose_model_is_not_loaded(tmp_path):
    """A port replica with no model yet (a restarted one answers its probes
    before its model loads) answers 503 with Retry-After: the front
    retries it on another replica like any shed, so the client sees 200."""
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.serving.server import ServingLayer

    cfg = load_config(overlay={
        "oryx.id": "tnotready",
        "oryx.input-topic.broker": "mem://tnotready",
        "oryx.update-topic.broker": "mem://tnotready",
        "oryx.serving.api.port": 0,
        "oryx.serving.api.read-only": True,
        "oryx.serving.init-topics": True,
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common",
            "oryx_tpu_torch.serving.resources.als",
        ],
    })
    layer = ServingLayer(cfg, model_manager=ALSServingModelManager(cfg, device="cpu"))
    layer.start()
    worker = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'))
    front = FleetFront(
        load_config(overlay={"oryx.fleet.front.probe-interval-sec": 0.2}),
        backends=[("r0", "127.0.0.1", layer.port), ("r1", "127.0.0.1", worker.port)],
        port=0,
    )
    front.start()
    try:
        status, headers, _ = _get(layer.port, "/recommend/u0")
        assert status == 503 and headers.get("Retry-After") == "1"
        sheds0 = front._m_retries.value(reason="shed")
        for i in range(6):
            status, _, body = _get(front.port, f"/recommend/u{i}")
            assert (status, body) == (200, b'{"ok":true}')
        assert worker.hits == 6
        assert front._m_retries.value(reason="shed") - sheds0 >= 1
    finally:
        front.close()
        worker.close()
        layer.close()


def test_front_surfaces_shed_when_every_replica_sheds():
    a = _StubReplica(
        lambda m, p: (503, [("Retry-After", "7")], b'{"error":"overloaded"}')
    )
    b = _StubReplica(
        lambda m, p: (503, [("Retry-After", "7")], b'{"error":"overloaded"}')
    )
    front = _front_for([a, b])
    try:
        status, headers, body = _get(front.port, "/recommend/u1")
        assert status == 503
        # the backpressure signal (Retry-After) survives to the client
        assert headers.get("Retry-After") == "7"
        assert a.hits + b.hits == 2  # tried each replica once, no loops
    finally:
        front.close()
        a.close()
        b.close()


def test_front_hash_policy_sticks_users_to_one_replica():
    replicas = [
        _StubReplica(lambda m, p, i=i: (200, [], b"%d" % i)) for i in range(3)
    ]
    front = _front_for(replicas, policy="hash")
    try:
        for u in range(20):
            answers = {
                _get(front.port, f"/recommend/user{u}?howMany=2")[2]
                for _ in range(3)
            }
            assert len(answers) == 1  # same user -> same replica, always
    finally:
        front.close()
        for s in replicas:
            s.close()


def test_front_post_connect_failure_is_not_replayed():
    """A POST that may have reached a dead backend must NOT be replayed on
    a sibling (double-ingest risk); the front answers 502 instead."""
    worker = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'))
    dead_port_holder = _StubReplica(lambda m, p: (200, [], b"{}"))
    dead_port = dead_port_holder.port
    dead_port_holder.close()  # port now refuses connections
    import http.client

    cfg = load_config(overlay={"oryx.fleet.front.probe-interval-sec": 30})
    front = FleetFront(
        cfg,
        backends=[
            ("rdead", "127.0.0.1", dead_port),
            ("rok", "127.0.0.1", worker.port),
        ],
        port=0,
    )
    front.start()
    try:
        got = {"ok": 0, "bad": 0}
        for i in range(6):
            status, _, _ = _get(front.port, "/ingest", method="POST", body=b"x,y,1")
            if status == 200:
                got["ok"] += 1
            else:
                assert status == 502
                got["bad"] += 1
        # round-robin sent some POSTs at the dead replica: those must be
        # 502s (not silently replayed), the rest clean 200s
        assert got["bad"] >= 1 and got["ok"] >= 1
        assert worker.hits == got["ok"]
        # while the same failure on a GET IS retried transparently
        status, _, body = _get(front.port, "/recommend/u1")
        assert status == 200 and body == b'{"ok":true}'
    finally:
        front.close()
        worker.close()


def test_front_ejects_and_readmits_on_health():
    flaky_degraded = {"on": False}

    class _Probe(_StubReplica):
        pass

    worker = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'))
    front = _front_for([worker], eject_after=1, readmit_after=1)
    try:
        r = front.replicas[0]
        deadline = time.time() + 10
        while not r.routable or r.state != "up":
            assert time.time() < deadline
            time.sleep(0.05)
        worker.close()  # probe target gone -> unreachable -> eject
        deadline = time.time() + 10
        while r.routable:
            assert time.time() < deadline, "dead replica never ejected"
            time.sleep(0.05)
        assert r.state == "down"
        assert front._m_ejections.value(replica="r0") >= 1
    finally:
        front.close()


# ---- shared model distribution (amortization acceptance) ------------------


def _chunk_messages(serialized: str, ref: str, max_size: int = 2048):
    """Capture the MODEL-CHUNK train publish_model_ref would emit."""
    from oryx_tpu_torch.common.artifact import publish_model_ref

    sent: list[tuple[str, str]] = []

    class _Capture:
        def send(self, key, message):
            sent.append((key, message))

        def send_batch(self, records):
            sent.extend(records)

    publish_model_ref(_Capture(), serialized, ref, max_size)
    chunks = [m for k, m in sent if k == "MODEL-CHUNK"]
    assert sent[-1] == ("MODEL-REF", ref)
    assert len(chunks) > 1  # the scenario needs a real chunk train
    return chunks


def _fresh_relay(tmp_path, shared: bool):
    from oryx_tpu_torch.common.artifact import ArtifactRelay

    r = ArtifactRelay(tmp_path)  # all "replicas" share one host cache
    r.shared_distribution = shared
    return r


def _make_artifact():
    import numpy as np

    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(11)
    art = ModelArtifact(
        "als",
        extensions={"features": "4"},
        tensors={"Y": rng.standard_normal((256, 4), dtype=np.float32)},
    )
    return art


def test_shared_distribution_amortizes_to_one_decode_per_host(tmp_path):
    """A chunked MODEL publish consumed by 3 replicas
    on one host counts ~1x the artifact bytes under mode=shared — not 3x —
    because replicas 2 and 3 adopt the first one's cache materialization
    instead of re-assembling."""
    from oryx_tpu_torch.common.artifact import ModelArtifact, _distribution_bytes

    serialized = _make_artifact().to_string()
    ref = str(tmp_path / "models" / "gen-1")
    chunks = _chunk_messages(serialized, ref)
    counter = _distribution_bytes()
    shared0 = counter.value(mode="shared")
    per0 = counter.value(mode="per-replica")

    relays = [_fresh_relay(tmp_path / "cache", shared=True) for _ in range(3)]
    for relay in relays:
        for m in chunks:
            relay.offer(m)
        # every replica can serve the model from the shared cache
        art = ModelArtifact.read(relay.resolve(ref))
        assert art.tensors["Y"].shape == (256, 4)

    artifact_bytes = len(serialized.encode("utf-8"))
    assert counter.value(mode="shared") - shared0 == artifact_bytes  # 1x, not 3x
    assert counter.value(mode="per-replica") - per0 == 0


def test_per_replica_distribution_counts_every_decode(tmp_path):
    from oryx_tpu_torch.common.artifact import _distribution_bytes

    serialized = _make_artifact().to_string()
    ref = str(tmp_path / "models" / "gen-2")
    chunks = _chunk_messages(serialized, ref)
    counter = _distribution_bytes()
    per0 = counter.value(mode="per-replica")
    for _ in range(3):
        relay = _fresh_relay(tmp_path / "cache", shared=False)
        for m in chunks:
            relay.offer(m)
    artifact_bytes = len(serialized.encode("utf-8"))
    assert counter.value(mode="per-replica") - per0 == 3 * artifact_bytes


def test_shared_distribution_survives_republished_content(tmp_path):
    """A republish of the SAME ref with different bytes (new sha) must not
    be satisfied from the stale cache — the new stream re-assembles."""
    from oryx_tpu_torch.common.artifact import ModelArtifact

    ref = str(tmp_path / "models" / "gen-3")
    first = _make_artifact()
    chunks1 = _chunk_messages(first.to_string(), ref)
    second = _make_artifact()
    second.extensions["features"] = "9"  # different bytes, same ref
    chunks2 = _chunk_messages(second.to_string(), ref)

    r1 = _fresh_relay(tmp_path / "cache", shared=True)
    for m in chunks1:
        r1.offer(m)
    r2 = _fresh_relay(tmp_path / "cache", shared=True)
    for m in chunks2:
        r2.offer(m)
    art = ModelArtifact.read(r2.resolve(ref))
    assert art.get_extension("features") == "9"


# ---- replica-tagged health ------------------------------------------------


class _NoModelManager:
    def __init__(self, config=None):
        self.config = config

    def consume(self, it):
        pass

    def get_model(self):
        return None


def test_degraded_reasons_name_replica_and_port():
    from oryx_tpu_torch.serving.app import ServingApp

    cfg = load_config(overlay={"oryx.fleet.replica.id": "r3"})
    app = ServingApp(cfg, _NoModelManager(cfg), None)
    app.listen_port = 8103
    app.model_staleness = lambda: 99.0  # force the degraded condition
    assert "model-stale@r3:8103" in app.degraded_reasons()

    # outside a fleet the reasons stay bare
    cfg2 = load_config()
    app2 = ServingApp(cfg2, _NoModelManager(cfg2), None)
    app2.model_staleness = lambda: 99.0
    assert "model-stale" in app2.degraded_reasons()


# ---- supervisor overlays --------------------------------------------------


def test_replica_overlays_namespace_identity_and_ports():
    cfg = load_config(
        overlay={"oryx.id": "prod", "oryx.fleet.data-dir": "/tmp/fx"}
    )
    ov = replica_overlays(cfg, n=3, base_port=9100)
    assert [o["oryx.serving.api.port"] for o in ov] == [9100, 9101, 9102]
    assert [o["oryx.fleet.replica.id"] for o in ov] == ["r0", "r1", "r2"]
    assert [o["oryx.id"] for o in ov] == ["prod-r0", "prod-r1", "prod-r2"]
    dirs = {o["oryx.monitoring.quarantine.dir"] for o in ov}
    assert len(dirs) == 3  # per-replica dead-letter dirs never interleave
    for o in ov:
        assert o["oryx.serving.api.processes"] == 1


def test_front_shard_topology_mismatch_degrades():
    """Shard-aware health: with oryx.fleet.shards=2, a replica
    whose /healthz reports the matching shard count stays routable, and
    a replica serving the WRONG topology (unsharded — restarted with
    stale config) counts degraded probes and is ejected with a
    shard-topology reason; both replicas' shard counts are published."""
    good = _StubReplica(
        lambda m, p: (200, [], b'{"ok":true}'),
        healthz=b'{"status":"up","degraded":[],"shards":2}',
    )
    bad = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'))  # no shards
    overlay = {
        "oryx.fleet.front.probe-interval-sec": 0.2,
        "oryx.fleet.front.eject-after": 1,
        "oryx.fleet.shards": 2,
    }
    cfg = load_config(overlay=overlay)
    front = FleetFront(
        cfg,
        backends=[("r0", "127.0.0.1", good.port), ("r1", "127.0.0.1", bad.port)],
        port=0,
    )
    front.start()
    try:
        r0, r1 = front.replicas
        deadline = time.time() + 10
        while r1.routable or not r0.routable:
            assert time.time() < deadline, (r0.snapshot(), r1.snapshot())
            time.sleep(0.05)
        assert r0.state == "up" and r0.shards == 2
        assert r1.state == "degraded" and (r1.shards or 1) == 1
        assert any("shard-topology" in x for x in r1.last_reasons)
        assert front._g_shards.value(replica="r0") == 2.0
        assert front._g_shards.value(replica="r1") == 1.0
        # /fleet/status carries the expected topology + per-replica counts
        status, _, body = _get(front.port, "/fleet/status")
        assert status == 200
        doc = json.loads(body)
        assert doc["shards"] == 2
        assert {r["id"]: r["shards"] for r in doc["replicas"]} == {
            "r0": 2, "r1": 1,
        }
    finally:
        front.close()
        good.close()
        bad.close()


def test_replica_overlays_shards_dimension():
    """replicas x shards: every replica overlay of a sharded fleet
    carries the shard-count knob; an unsharded fleet's overlays don't
    (the serving default stays authoritative), and a nonsense shard
    count is rejected loudly."""
    cfg = load_config(overlay={"oryx.fleet.replicas": 3})
    for o in replica_overlays(cfg, shards=2):
        assert o["oryx.serving.api.sync.shard-count"] == 2
    for o in replica_overlays(cfg):
        assert "oryx.serving.api.sync.shard-count" not in o
    cfg2 = load_config(
        overlay={"oryx.fleet.replicas": 2, "oryx.fleet.shards": 4}
    )
    assert all(
        o["oryx.serving.api.sync.shard-count"] == 4
        for o in replica_overlays(cfg2)
    )
    with pytest.raises(ValueError):
        replica_overlays(cfg, shards=0)


def test_replica_overlays_reject_empty_fleet():
    with pytest.raises(ValueError):
        replica_overlays(load_config(), n=0)


def test_wait_listening_outlasts_a_probe_that_reads_itself():
    """A probe that connects before the replica listens may reach a socket
    that answers with the probe's own request (a TCP self-connect in the
    ephemeral port range): ``wait_listening`` keeps polling instead of
    raising ``BadStatusLine``."""
    import socket

    from oryx_tpu_torch.fleet.supervisor import FleetSupervisor

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(4)
    port = srv.getsockname()[1]

    def serve():
        for reply in (None, b"HTTP/1.0 200 OK\r\nContent-Length: 0\r\n\r\n"):
            conn, _ = srv.accept()
            with conn:
                got = conn.recv(4096)
                conn.sendall(reply if reply is not None else got)

    t = threading.Thread(target=serve, daemon=True)
    t.start()
    sup = FleetSupervisor(load_config(
        overlay={"oryx.fleet.replicas": 1, "oryx.fleet.base-port": port}))
    try:
        sup.wait_listening(10)
    finally:
        srv.close()
    t.join(5)
    assert not t.is_alive()


def test_supervisor_counts_deaths_not_poll_ticks():
    """A corpse waiting out its restart backoff must not be re-counted as
    a fresh fast fail by every supervision tick — crash-loop detection
    counts DEATHS (regression: two real deaths used to trip
    max-fast-fails=6 after a few 1s ticks)."""
    from oryx_tpu_torch.fleet.supervisor import FleetSupervisor

    cfg = load_config(
        overlay={"oryx.fleet.replicas": 1, "oryx.fleet.base-port": 9300}
    )
    sup = FleetSupervisor(cfg)

    class _Dead:
        returncode = 1

        def poll(self):
            return 1

    spawns = []
    sup._spawn = lambda i: spawns.append(i) or _Dead()  # type: ignore[assignment]
    sup.procs[0] = _Dead()
    sup._spawned_at[0] = time.monotonic()  # died instantly = fast fail

    sup.poll()  # counts the death, restarts (backoff now pending)
    assert sup._fast_fails == 1 and len(spawns) == 1
    # respawned corpse sits through many ticks inside the backoff window:
    # its death is counted ONCE, and no further restarts fire early
    for _ in range(20):
        sup.poll()
    assert sup._fast_fails == 2
    assert len(spawns) == 1
    assert not sup.crash_looping


# ---- control plane: drain / elastic ring / autoscaler / give-up -----------
# (the in-process halves; the full canary rollout+rollback story runs as
# the `fleet-canary` scenario of test_torch_fleet_chaos.py)


def test_front_drain_finishes_inflight_and_blocks_new_traffic():
    """begin_drain is scale-down's graceful half: the draining replica
    takes no NEW requests (its keys re-place on siblings) while the
    request already inside it still gets its answer, and healthy probes
    never readmit it — draining is an operator state, not a health
    state."""
    gate = threading.Event()

    def slow(m, p):
        gate.wait(15)
        return (200, [], b'"r0"')

    s0 = _StubReplica(slow)
    s1 = _StubReplica(lambda m, p: (200, [], b'"r1"'))
    front = _front_for([s0, s1], policy="hash", readmit_after=1)
    try:
        r0 = front._by_id["r0"]
        deadline = time.time() + 10
        while not all(r.routable for r in front.replicas):
            assert time.time() < deadline
            time.sleep(0.05)
        # a user the ring places on r0, so the drain actually re-places it
        u = next(k for k in KEYS if front._ring.lookup(k) == "r0")
        got: list = []
        t = threading.Thread(
            target=lambda: got.append(_get(front.port, f"/recommend/{u}"))
        )
        t.start()
        deadline = time.time() + 10
        while front.inflight("r0") != 1:
            assert time.time() < deadline, "request never reached r0"
            time.sleep(0.02)

        assert front.begin_drain("r0") is True
        assert front.begin_drain("nope") is False
        assert r0.state == "draining" and not r0.routable
        # the SAME user's new requests re-place onto the sibling now
        status, _, body = _get(front.port, f"/recommend/{u}")
        assert (status, body) == (200, b'"r1"')
        # ...while the in-flight request is still being answered
        assert front.inflight("r0") == 1
        gate.set()
        t.join(timeout=10)
        assert got and got[0][0] == 200 and got[0][2] == b'"r0"'
        deadline = time.time() + 10
        while front.inflight("r0") != 0:
            assert time.time() < deadline
            time.sleep(0.02)
        # sticky: several healthy probe cycles later it is still draining
        time.sleep(0.7)
        assert r0.state == "draining" and not r0.routable
    finally:
        gate.set()
        front.close()
        s0.close()
        s1.close()


def test_front_add_remove_replica_minimal_reshuffle():
    """The autoscaler's ring surface: add_replica joins unroutable (the
    prober readmits it like any recovered replica) and remaps only the
    ~1/N slice the new node takes over; remove_replica restores the
    previous placement exactly and drops the canary pointer if the
    victim held it."""
    stubs = [
        _StubReplica(lambda m, p: (200, [], b'{"ok":true}')) for _ in range(3)
    ]
    extra = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'))
    front = _front_for(stubs, policy="hash", readmit_after=1)
    try:
        before = {k: front._ring.lookup(k) for k in KEYS}
        r3 = front.add_replica("r3", "127.0.0.1", extra.port)
        assert r3.state == "down" and not r3.routable  # prober's call
        assert [r.id for r in front.replicas] == ["r0", "r1", "r2", "r3"]
        with pytest.raises(ValueError):
            front.add_replica("r3", "127.0.0.1", extra.port)
        moved = {k for k in KEYS if front._ring.lookup(k) != before[k]}
        assert moved, "a grown ring must take over some keys"
        assert all(front._ring.lookup(k) == "r3" for k in moved)
        assert len(moved) <= 3.0 * len(KEYS) / 4
        deadline = time.time() + 10
        while not r3.routable:
            assert time.time() < deadline, "healthy new replica never readmitted"
            time.sleep(0.05)
        front.set_canary("r3", 0.25)
        assert front.canary() == ("r3", 0.25)
        front.remove_replica("r3")
        assert front.canary() is None
        assert [r.id for r in front.replicas] == ["r0", "r1", "r2"]
        assert {k: front._ring.lookup(k) for k in KEYS} == before
        front.remove_replica("r3")  # removing twice is a no-op
    finally:
        front.close()
        for s in stubs:
            s.close()
        extra.close()


def _fresh_front_slo():
    """The front-availability SLO is one per process: drop the samples
    earlier tests' fronts left in its window, so a controller's scale-up
    signal reads only its own fleet's answers."""
    from oryx_tpu_torch.common import slo

    t = slo.tracker("front-availability")
    if t is not None:
        with t._lock:
            t._samples.clear()


def test_controller_scale_down_drains_then_stops(tmp_path):
    """Sustained low occupancy scales the fleet down through the graceful
    sequence: pick the highest-index non-canary victim, drain it, THEN
    stop the process and drop it from the ring — with the decision
    evidence (drain + stopped phases) in the flight ring."""
    from oryx_tpu_torch.common.flightrec import configure_flightrec, read_events
    from oryx_tpu_torch.fleet.control import FleetController

    idle = json.dumps(
        {
            "status": "up",
            "degraded": [],
            "occupancy": {"mean": 0.01, "dispatches": 100},
        }
    ).encode()
    stubs = [
        _StubReplica(lambda m, p: (200, [], b'{"ok":true}'), healthz=idle)
        for _ in range(3)
    ]
    front = _front_for(stubs, readmit_after=1)

    class _Sup:
        gave_up: list = []

        def __init__(self):
            self.stopped: list[str] = []

        def stop_replica(self, rid, timeout=15.0):
            self.stopped.append(rid)
            return True

    _fresh_front_slo()
    cfg = load_config(
        overlay={
            "oryx.fleet.autoscale.enabled": True,
            "oryx.fleet.autoscale.min-replicas": 2,
            "oryx.fleet.autoscale.max-replicas": 3,
            "oryx.fleet.autoscale.scale-down-occupancy": 0.15,
            "oryx.fleet.autoscale.scale-down-after-sec": 0.0,
            "oryx.fleet.autoscale.cooldown-sec": 0.0,
            "oryx.fleet.autoscale.drain-timeout-sec": 5.0,
            "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        }
    )
    configure_flightrec(cfg)
    sup = _Sup()
    ctl = FleetController(cfg, sup, front)  # never started: manual ticks
    try:
        deadline = time.time() + 10
        while not all(
            r.routable and isinstance(r.occupancy, dict) for r in front.replicas
        ):
            assert time.time() < deadline, [r.snapshot() for r in front.replicas]
            time.sleep(0.05)
        down0 = ctl._m_autoscale.value(direction="down")
        ctl.tick()  # arms the low-occupancy clock
        assert ctl._draining is None
        ctl.tick()  # sustained low occupancy: begins the drain
        assert ctl._draining is not None and ctl._draining[0] == "r2"
        assert front._by_id["r2"].state == "draining"
        assert sup.stopped == []  # process still running: drain first
        ctl.tick()  # nothing in flight: stop + remove
        assert sup.stopped == ["r2"]
        assert [r.id for r in front.replicas] == ["r0", "r1"]
        assert ctl._m_autoscale.value(direction="down") - down0 == 1
        phases = [
            (e.get("phase"), e.get("replica"))
            for e in read_events(str(tmp_path / "flight"))
            if e["kind"] == "autoscale"
        ]
        assert ("drain", "r2") in phases and ("stopped", "r2") in phases
        # min-replicas floor: the fleet never drains below it
        for _ in range(6):
            ctl.tick()
        assert len(front.replicas) == 2 and ctl._draining is None
        assert sup.stopped == ["r2"]
    finally:
        front.close()
        for s in stubs:
            s.close()


def test_controller_failed_rollback_quarantines_canary(tmp_path):
    """A rollback verdict whose pointer swap FAILS (409: the canary's
    gate has no prior adoption in history, e.g. the incumbent loaded
    before the gate armed) must NOT hand the canary's keys back to the
    hash ring — the replica is still serving the vetoed generation. The
    controller pins the split at fraction 0.0 instead (quarantine: no
    cohort routes there, everyone else avoids it), and the next
    rollout's set_canary replaces the quarantine."""
    from oryx_tpu_torch.common.flightrec import configure_flightrec, read_events
    from oryx_tpu_torch.fleet.control import FleetController

    def _canary_healthz(gens, samples):
        return json.dumps(
            {
                "status": "up",
                "degraded": [],
                "model_generation": gens[-1],
                "model_gate": {"mode": "canary", "generations": gens},
                "quality": {"samples": samples, "live_recall_at_10": 0.0},
                "slo_burn": {"quality": {"fast": 20.0}},
            }
        ).encode()

    hold_h = json.dumps(
        {
            "status": "up",
            "degraded": [],
            "model_generation": 1,
            "model_gate": {"mode": "hold", "watermark": 1},
            "quality": {"samples": 50, "live_recall_at_10": 1.0},
        }
    ).encode()
    posts: list[str] = []

    def refuse(method, path):
        posts.append(f"{method} {path}")
        return (409, [], b'{"status": 409, "error": "no history"}')

    s0 = _StubReplica(refuse, healthz=_canary_healthz([2], 50))
    s1 = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'), healthz=hold_h)
    front = _front_for([s0, s1], policy="hash", readmit_after=1)

    class _Sup:
        gave_up: list = []

    cfg = load_config(
        overlay={
            "oryx.fleet.canary.enabled": True,
            "oryx.fleet.canary.traffic-fraction": 0.25,
            "oryx.fleet.canary.min-samples": 1,
            "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        }
    )
    configure_flightrec(cfg)
    ctl = FleetController(cfg, _Sup(), front)  # never started: manual ticks
    try:
        deadline = time.time() + 10
        while not all(
            r.routable and isinstance(r.model_gate, dict) for r in front.replicas
        ):
            assert time.time() < deadline, [r.snapshot() for r in front.replicas]
            time.sleep(0.05)
        ctl.tick()  # generation 2 on the canary: the split opens
        assert front.canary() == ("r0", 0.25)
        # the canary accumulates quality evidence that breaches the gate
        s0.healthz = _canary_healthz([2], 58)
        deadline = time.time() + 10
        while (front._by_id["r0"].quality or {}).get("samples") != 58:
            assert time.time() < deadline
            time.sleep(0.05)
        ctl.tick()  # verdict: rollback — but the pointer swap 409s
        assert any(p == "POST /control/model/rollback" for p in posts)
        assert front.canary() == ("r0", 0.0)  # quarantined, NOT cleared
        assert ctl._rollout is None and 2 in ctl._vetoed
        ev = [
            e
            for e in read_events(str(tmp_path / "flight"))
            if e["kind"] == "canary-rollback"
        ]
        assert ev and ev[-1]["quarantined"] is True
        assert ev[-1]["rolled_back_to"] is None
        # zero traffic reaches the quarantined replica; its keys re-place
        for k in KEYS:
            picked = front._pick(f"/recommend/{k}", set())
            assert picked is not None and picked.id == "r1"
        # the vetoed generation cannot restart a rollout...
        ctl.tick()
        assert front.canary() == ("r0", 0.0)
        # ...but the NEXT generation's rollout replaces the quarantine
        s0.healthz = _canary_healthz([2, 3], 58)
        deadline = time.time() + 10
        while (front._by_id["r0"].model_gate or {}).get("generations") != [2, 3]:
            assert time.time() < deadline
            time.sleep(0.05)
        ctl.tick()
        assert front.canary() == ("r0", 0.25)
    finally:
        front.close()
        s0.close()
        s1.close()


def test_supervisor_crash_loop_gives_up_with_flight_event_and_front_state(
    tmp_path,
):
    """max-fast-fails deaths within the fast-fail window stop the restart
    churn: the supervisor records a crash-loop flight event with the
    evidence an operator needs, and the controller mirrors the give-up
    into the front as a sticky state=gave_up (healthy probes must NOT
    readmit a replica the supervisor abandoned on purpose)."""
    from oryx_tpu_torch.common.flightrec import configure_flightrec, read_events
    from oryx_tpu_torch.fleet.control import FleetController
    from oryx_tpu_torch.fleet.supervisor import FleetSupervisor

    cfg = load_config(
        overlay={
            "oryx.fleet.replicas": 1,
            "oryx.fleet.base-port": 9400,
            "oryx.fleet.supervisor.max-fast-fails": 2,
            "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        }
    )
    configure_flightrec(cfg)
    sup = FleetSupervisor(cfg)

    class _Dead:
        returncode = 9

        def poll(self):
            return 9

    spawns: list[int] = []
    sup._spawn = lambda i: spawns.append(i) or _Dead()  # type: ignore[assignment]
    sup.procs[0] = _Dead()
    sup._spawned_at[0] = time.monotonic()  # dies instantly = fast fail
    sup._backoff = 0.01  # the restart gate opens almost immediately

    deadline = time.time() + 10
    while not sup.crash_looping:
        assert time.time() < deadline, (sup._fast_fails, spawns)
        sup.poll()
        time.sleep(0.02)
    assert sup.gave_up == ["r0"]
    assert len(spawns) == 1  # one restart attempt, then the give-up
    ev = [
        e
        for e in read_events(str(tmp_path / "flight"))
        if e["kind"] == "crash-loop"
    ]
    assert len(ev) == 1
    assert ev[0]["replica"] == "r0"
    assert ev[0]["fast_fails"] == 2 and ev[0]["max_fast_fails"] == 2
    assert ev[0]["returncode"] == 9

    stub = _StubReplica(lambda m, p: (200, [], b'{"ok":true}'))
    front = _front_for([stub], readmit_after=1)
    try:
        r0 = front.replicas[0]
        deadline = time.time() + 10
        while not r0.routable:
            assert time.time() < deadline
            time.sleep(0.05)
        ctl = FleetController(load_config(), sup, front)
        ctl.tick()
        assert r0.state == "gave_up" and not r0.routable
        # sticky across healthy probe cycles
        time.sleep(0.7)
        assert r0.state == "gave_up" and not r0.routable
        status, _, body = _get(front.port, "/fleet/status")
        assert status == 200
        doc = json.loads(body)
        assert {r["id"]: r["state"] for r in doc["replicas"]}["r0"] == "gave_up"
    finally:
        front.close()
        stub.close()


# ---- the `fleet` command ----------------------------------------------------


def test_fleet_child_flags_keep_app_and_drop_fleet_flags():
    """The replicas' command line: the fleet-only flags and the subcommand
    drop out, --app and --set ride through with their values."""
    from oryx_tpu.cli import _fleet_child_flags as jax_child_flags
    from oryx_tpu_torch.cli import _fleet_child_flags

    raw = ["fleet", "--app", "seq", "--replicas", "2", "--conf", "x.conf",
           "--policy=hash", "--front-port", "8090", "--shards", "1",
           "--set", "a=b"]
    child = _fleet_child_flags(raw)
    assert child == ["--app", "seq", "--conf", "x.conf", "--set", "a=b"]
    assert child == jax_child_flags(raw)


def test_cli_fleet_serves_through_the_front(tmp_path):
    """``python -m oryx_tpu_torch.cli fleet --replicas 2 --policy hash`` on
    the CPU (the platform overlay): both replicas load the published model,
    /fleet/healthz answers 200, /recommend answers through the front on a
    replica the ring chose, both replicas take users, and SIGTERM stops the
    whole fleet with exit code 0."""
    import os
    import signal
    import subprocess
    import sys

    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common.executil import free_port_run

    root = __import__("pathlib").Path(__file__).resolve().parents[1]
    bus = f"file://{tmp_path / 'bus'}"
    topics.maybe_create(bus, "OryxInput", 1)
    topics.maybe_create(bus, "OryxUpdate", 1)
    get_broker(bus).send("OryxUpdate", "MODEL", _model_message())
    front_port = free_port_run(1)
    base_port = free_port_run(2)
    sets = [
        f"oryx.input-topic.broker={bus}", f"oryx.update-topic.broker={bus}",
        "oryx.compute.platform=cpu", "oryx.serving.api.read-only=true",
        "oryx.serving.api.loops=1", f"oryx.fleet.base-port={base_port}",
        f"oryx.fleet.data-dir={tmp_path / 'fleet'}",
        "oryx.fleet.front.probe-interval-sec=0.2",
        f"oryx.monitoring.flight.dir={tmp_path / 'front-flight'}",
    ]
    p = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "fleet", "--app", "als",
         "--replicas", "2", "--policy", "hash", "--front-port", str(front_port),
         *[x for s in sets for x in ("--set", s)]],
        cwd=root, env=dict(os.environ, TMPDIR=str(tmp_path)),
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True,
        start_new_session=True,
    )
    try:
        deadline = time.time() + 90
        while True:
            assert p.poll() is None, "fleet exited early"
            try:
                if _get(front_port, "/fleet/healthz")[0] == 200:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "front never healthy"
            time.sleep(0.2)
        for port in (base_port, base_port + 1):
            deadline = time.time() + 60
            while _get(port, "/ready")[0] != 200:
                assert time.time() < deadline, f"replica :{port} never ready"
                time.sleep(0.2)
        ring = HashRing(["r0", "r1"])
        owners = set()
        for u in range(16):
            status, _, body = _get(front_port, f"/recommend/u{u}?howMany=3")
            assert status == 200, body
            assert len(json.loads(body)) == 3
            owners.add(ring.lookup(f"u{u}"))
        assert owners == {"r0", "r1"}
        status, _, body = _get(front_port, "/fleet/status")
        doc = json.loads(body)
        assert doc["policy"] == "hash"
        assert [r["id"] for r in doc["replicas"]] == ["r0", "r1"]
        assert all(r["routable"] for r in doc["replicas"])
        p.send_signal(signal.SIGTERM)
        assert p.wait(timeout=60) == 0
        assert "front :%d (hash)" % front_port in p.stdout.read()
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait(timeout=10)


def _model_message() -> str:
    import numpy as np

    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(5)
    art = ModelArtifact(
        "als",
        extensions={"features": "4", "lambda": "0.001", "alpha": "1.0",
                    "implicit": "true", "logStrength": "false"},
        tensors={
            "X": rng.standard_normal((16, 4), dtype=np.float32),
            "Y": rng.standard_normal((64, 4), dtype=np.float32),
        },
    )
    art.set_extension("XIDs", [f"u{j}" for j in range(16)])
    art.set_extension("YIDs", [f"i{j}" for j in range(64)])
    return art.to_string()


def test_controller_post_waits_for_a_slow_delivery():
    """An approve or rollback POST returns once the replica has delivered
    the generation, which at the serving catalog's width takes seconds:
    the controller waits the front's backend timeout for it (past the JAX
    package's fixed 5 s), and gives up after it."""
    from oryx_tpu_torch.fleet.control import FleetController

    def slow(method, path):
        time.sleep(5.5)
        return (200, [], b'{"watermark": 2, "adopted": true}')

    stub = _StubReplica(slow)
    r = ReplicaInfo("r0", "127.0.0.1", stub.port)
    try:
        ctl = FleetController(load_config(), None, None)
        assert ctl.post_timeout == 60.0
        assert ctl._post(r, "/control/model/approve", {"generation": 2}) == {
            "watermark": 2, "adopted": True}
        short = FleetController(load_config(overlay={
            "oryx.fleet.front.backend-timeout-sec": 1.0}), None, None)
        assert short._post(r, "/control/model/approve", {"generation": 2}) is None
    finally:
        stub.close()


def test_canary_samples_count_only_once_the_canary_serves_the_generation(tmp_path):
    """The canary's gate lists generation 3 while its view still builds and
    it serves generation 2: samples landing then (recall 1.0, the
    incumbent's answers) must not count toward generation 3's verdict. The
    controller promoted a corrupted generation on such evidence in a card
    run; it now counts from the first probe that finds the canary serving
    the generation, and rolls it back on the new generation's own
    samples."""
    from oryx_tpu_torch.common.flightrec import configure_flightrec
    from oryx_tpu_torch.fleet.control import FleetController

    def canary_h(served, gens, samples, recall):
        return json.dumps({
            "status": "up", "degraded": [], "model_generation": served,
            "model_gate": {"mode": "canary", "generations": gens},
            "quality": {"samples": samples, "live_recall_at_10": recall},
            "slo_burn": {"quality": {"fast": 0.0}},
        }).encode()

    hold_h = json.dumps({
        "status": "up", "degraded": [], "model_generation": 2,
        "model_gate": {"mode": "hold", "watermark": 2},
        "quality": {"samples": 50, "live_recall_at_10": 1.0},
    }).encode()
    posts: list[str] = []

    def ok(method, path):
        posts.append(f"{method} {path}")
        return (200, [], b'{"ok":true}')

    s0 = _StubReplica(ok, healthz=canary_h(2, [2, 3], 40, 1.0))
    s1 = _StubReplica(ok, healthz=hold_h)
    front = _front_for([s0, s1], policy="hash", readmit_after=1)

    class _Sup:
        gave_up: list = []

    cfg = load_config(overlay={
        "oryx.fleet.canary.enabled": True,
        "oryx.fleet.canary.traffic-fraction": 0.5,
        "oryx.fleet.canary.min-samples": 8,
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
    })
    configure_flightrec(cfg)
    ctl = FleetController(cfg, _Sup(), front)  # never started: manual ticks

    def probed(samples, served):
        deadline = time.time() + 10
        while ((front._by_id["r0"].quality or {}).get("samples") != samples
               or front._by_id["r0"].generation != served):
            assert time.time() < deadline
            time.sleep(0.05)

    try:
        deadline = time.time() + 10
        while not all(
            r.routable and isinstance(r.model_gate, dict) for r in front.replicas
        ):
            assert time.time() < deadline, [r.snapshot() for r in front.replicas]
            time.sleep(0.05)
        probed(40, 2)
        ctl.tick()  # generation 3 in the canary's gate: the split opens
        assert front.canary() == ("r0", 0.5)
        # still serving generation 2: 20 more samples at recall 1.0
        s0.healthz = canary_h(2, [2, 3], 60, 1.0)
        probed(60, 2)
        ctl.tick()
        assert ctl._rollout is not None and not ctl._rollout.promoting
        assert not any("approve" in p for p in posts)
        # the view is built: generation 3 serves, its window restarted
        s0.healthz = canary_h(3, [2, 3], 62, 0.2)
        probed(62, 3)
        ctl.tick()  # counting starts here
        assert ctl._rollout is not None and not ctl._rollout.promoting
        s0.healthz = canary_h(3, [2, 3], 70, 0.2)
        probed(70, 3)
        ctl.tick()  # 8 samples of generation 3 at recall 0.2: rollback
        assert ctl._rollout is None
        assert 3 in ctl.vetoed()
        assert any("rollback" in p for p in posts), posts
        assert not any("approve" in p for p in posts), posts
    finally:
        front.close()
        for s in (s0, s1):
            s.close()
