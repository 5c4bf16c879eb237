"""Fleet front: a thin L7 router over N serving replicas (the port's copy
of oryx_tpu/fleet/front.py).

Reuses the async frontend's loop machinery (``serving/aserver.py``
handles accept/h2/shutdown) and replaces the dispatch stage: instead of
routing into a local ServingApp, the front picks a replica and proxies
the request over a pooled keep-alive connection. Plain HTTP/1.1 — the
hot path — takes a raw-bytes fast lane (``_handle_conn`` override) that
scans the request head once, forwards it minus hop-by-hop lines, and
relays the backend's response head verbatim; h2 rides the generic
``_process``/``_proxy_once`` machinery. Placement policies:

- ``round-robin``: next routable replica per request.
- ``hash``: consistent-hash-by-user (``fleet/ring.py``) on a path
  segment (``oryx.fleet.front.hash-path-segment``, default segment 1 —
  the user id of ``/recommend/<user>``), walking the ring's successor
  order past ejected replicas so an ejection remaps only that replica's
  users.

Health-driven ejection: a prober thread polls each replica's
``GET /healthz`` (the degraded-readiness surface) and ejects after
``eject-after`` consecutive degraded/unreachable probes, readmitting
after ``readmit-after`` healthy ones. The probe body also carries the
replica's model generation / staleness / serving MFU, aggregated here as
``oryx_fleet_replica_*`` gauges and ``oryx_fleet_generation_skew``.

Failure semantics at the front:

- A deliberate shed (503 + ``Retry-After``) did NOT process the
  request, so it is retried once per remaining replica; only when every
  routable replica sheds does the 503 reach the client (with the last
  ``Retry-After`` intact).
- A connect/transport failure retries on another replica for
  idempotent methods (GET/HEAD) only — a POST that may have reached the
  backend must not be replayed, so it returns 502 instead of risking a
  double ingest.
- A replica whose card dispatch fails answers 503 + ``Retry-After`` from
  its watchdog, which the front retries like any shed: no request is ever
  scored on the host in place of the card.

The front keeps three local paths off the proxy: ``/fleet/status``
(JSON replica table), ``/fleet/healthz`` (200 while >= 1 replica is
routable), and ``/metrics`` (the front's own registry, which carries
the ``oryx_fleet_*`` families).
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import threading
import time
from urllib.parse import parse_qs

from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.flightrec import configure_flightrec, get_flightrec
from oryx_tpu_torch.common.metrics import GaugeSeriesGone, get_registry
from oryx_tpu_torch.common.slo import ensure_front_slos
from oryx_tpu_torch.common.tracing import (
    configure_tracing,
    format_traceparent,
    get_tracer,
    parse_traceparent,
    span_forest,
    stitch_traces,
    stitched_chrome,
)
from oryx_tpu_torch.fleet.observe import federate
from oryx_tpu_torch.fleet.ring import HashRing
from oryx_tpu_torch.serving.aserver import (
    MAX_BODY_BYTES,
    MAX_HEADER_BYTES,
    READ_TIMEOUT,
    AsyncHTTPServer,
)

log = logging.getLogger(__name__)

# the tracer singleton, bound once like serving/aserver.py: the
# disabled-tracing cost on the proxy hot path is one attribute read
_TRACER = get_tracer()

# Response headers the backend's answer carries through the front
# verbatim (content-type/length are re-derived by the front's writer).
_FORWARD_RESPONSE_HEADERS = (
    "retry-after",
    "warning",
    "traceparent",
    "content-disposition",
    "www-authenticate",
)

# Hop-by-hop / front-owned request headers never forwarded to a backend.
# accept-encoding is stripped so backends answer uncompressed and the h1
# fast path can relay the response head verbatim (no re-render, no
# double-compression risk); proxied responses reach the client identity-
# encoded.
_DROP_REQUEST_HEADERS = (
    "host",
    "connection",
    "keep-alive",
    "upgrade",
    "transfer-encoding",
    "content-length",
    "accept-encoding",
    "http2-settings",
)

# bytes-level twin of _DROP_REQUEST_HEADERS for the h1 fast path (the
# hot proxy loop never builds a str header dict)
_DROP_REQUEST_HEADERS_B = frozenset(
    h.encode("ascii") for h in _DROP_REQUEST_HEADERS
)

_STATES = ("up", "degraded", "down", "draining", "gave_up")


class ReplicaInfo:
    """One replica's routing state, owned by the front's prober thread
    (the request path only reads ``routable``/``state``)."""

    def __init__(self, replica_id: str, host: str, port: int):
        self.id = replica_id
        self.host = host
        self.port = port
        # optimistic until the first probe: a front that starts before
        # its replicas finish binding must not reject all traffic
        self.state = "up"
        self.routable = True
        self.consecutive_bad = 0
        self.consecutive_ok = 0
        self.generation: int | None = None
        self.staleness_seconds: float | None = None
        self.mfu: float | None = None
        self.update_lag: int | None = None
        self.shards: int | None = None
        # the replica's live-quality scorecard from its /healthz body
        # (windowed shadow-rescore recall, generation eval metrics,
        # drift) — federated verbatim into /fleet/status so trained-vs-
        # live skew is visible fleet-wide
        self.quality: dict | None = None
        # the replica's own SLO source-read failures (slo -> last error)
        self.slo_errors: dict | None = None
        # the replica's live latency budget from its /healthz body
        # (per-phase p50/p99/share + ranked idle-gap causes, common/
        # perfattr.py) — federated verbatim into /fleet/status so "where
        # does the millisecond go" is answerable fleet-wide
        self.latency_budget: dict | None = None
        # the replica's staged-adoption state (common/modelgate.py
        # healthz_section) — the fleet controller reads canary/hold
        # progress from here via /fleet/status
        self.model_gate: dict | None = None
        # the replica's own SLO burn snapshot (slo -> fast/slow burn) —
        # the canary gate's promotion evidence
        self.slo_burn: dict | None = None
        # the replica's rolling dispatch-occupancy window — the
        # autoscaler's scale-down signal
        self.occupancy: dict | None = None
        # proxied exchanges currently in flight to this replica
        # (guarded-by: front._inflight_lock) — drain completion is
        # "routable off AND inflight zero"
        self.inflight = 0
        self.last_reasons: list[str] = []

    def snapshot(self) -> dict:
        # NaN/Inf gauges (mfu on peak-less hosts) render as null: bare
        # NaN in the /fleet/status body is invalid JSON and breaks every
        # strict client parser
        return {
            "id": self.id,
            "host": self.host,
            "port": self.port,
            "state": self.state,
            "routable": self.routable,
            "consecutive_failures": self.consecutive_bad,
            "model_generation": self.generation,
            "staleness_seconds": _finite_or_none(self.staleness_seconds),
            "mfu": _finite_or_none(self.mfu),
            "update_lag": self.update_lag,
            "shards": self.shards,
            "quality": self.quality,
            "slo_errors": self.slo_errors,
            "latency_budget": self.latency_budget,
            "model_gate": self.model_gate,
            "slo_burn": self.slo_burn,
            "occupancy": self.occupancy,
            "inflight": self.inflight,
            "degraded": self.last_reasons,
        }


class _FrontApp:
    """Minimal stand-in for the ServingApp the base server tracks: the
    front overrides dispatch entirely, so only the fan-out counter the
    base start() writes is needed."""

    loop_count = 1

    def is_fast(self, path: str) -> bool:  # pragma: no cover - unused
        return False


def _finite_or_none(v: float | None) -> float | None:
    """JSON-safe float: NaN/Inf -> None (json.dumps would emit bare NaN,
    which strict json.loads rejects)."""
    if isinstance(v, float) and not math.isfinite(v):
        return None
    return v


def _states_reader(ref, state: str):
    def read() -> float:
        front = ref()
        if front is None:
            raise GaugeSeriesGone("fleet front gone")
        return float(sum(1 for r in front.replicas if r.state == state))

    return read


class FleetFront(AsyncHTTPServer):
    def __init__(
        self,
        config: Config,
        backends: list[tuple[str, str, int]] | None = None,
        port: int | None = None,
    ):
        # literal key reads throughout (tools/check_config.py resolves
        # accessor keys statically; f-string composition would hide them)
        loops = config.get_int("oryx.fleet.front.loops", 1)
        super().__init__(
            _FrontApp(),
            auth=None,
            port=config.get_int("oryx.fleet.front.port", 8090)
            if port is None
            else port,
            workers=2,  # the proxy path is pure async I/O; no pool use
            loops=loops,
        )
        self.policy = config.get_string("oryx.fleet.front.policy", "round-robin")
        if self.policy not in ("round-robin", "hash"):
            raise ValueError(
                "oryx.fleet.front.policy must be round-robin or hash, "
                f"got {self.policy!r}"
            )
        self.hash_segment = config.get_int("oryx.fleet.front.hash-path-segment", 1)
        self.retry_shed = config.get_bool("oryx.fleet.front.retry-shed", True)
        self.probe_interval = config.get_float(
            "oryx.fleet.front.probe-interval-sec", 2.0
        )
        self.eject_after = max(
            1, config.get_int("oryx.fleet.front.eject-after", 2)
        )
        self.readmit_after = max(
            1, config.get_int("oryx.fleet.front.readmit-after", 2)
        )
        self.backend_timeout = config.get_float(
            "oryx.fleet.front.backend-timeout-sec", 60.0
        )
        # idle keep-alive backend connections kept per (loop, replica);
        # must cover the expected in-flight depth or completions churn
        # through connect/close instead of reusing sockets
        self.pool_size = config.get_int("oryx.fleet.front.pool-size", 256)
        # shard-aware health: the shards-per-replica topology this fleet
        # was launched with (oryx.fleet.shards). A replica whose /healthz
        # reports a DIFFERENT shard count is mis-sharded — restarted with
        # stale config, about to overrun one card's memory at pod scale —
        # and is treated like a degraded probe: routing never lands on a
        # half-sharded view
        self.expect_shards = config.get_int("oryx.fleet.shards", 1)
        if backends is None:
            # derive the local fleet the supervisor would launch: replicas
            # r0..rN-1 on base-port..base-port+N-1 of this host
            n = config.get_int("oryx.fleet.replicas", 2)
            base = config.get_int("oryx.fleet.base-port", 8100)
            backends = [(f"r{i}", "127.0.0.1", base + i) for i in range(n)]
        self.replicas = [ReplicaInfo(rid, host, p) for rid, host, p in backends]
        if not self.replicas:
            raise ValueError("fleet front needs at least one replica")
        if len({r.id for r in self.replicas}) != len(self.replicas):
            raise ValueError("replica ids must be unique")
        self._by_id = {r.id: r for r in self.replicas}
        self._ring = HashRing(
            (r.id for r in self.replicas),
            vnodes=config.get_int("oryx.fleet.front.vnodes", 64),
        )
        self._rr_lock = threading.Lock()
        self._rr = 0  # guarded-by: _rr_lock
        # canary traffic split (set_canary/clear_canary, driven by the
        # fleet controller): while set, a stable hash cohort of request
        # keys lands on the canary replica and everyone else stays on
        # the incumbent fleet — same key, same cohort, every request
        # (sessions stay sticky through the rollout)
        self._canary_id: str | None = None
        self._canary_fraction = 0.0
        self._inflight_lock = threading.Lock()
        # keep-alive connection pool, keyed per (event loop, replica):
        # asyncio streams are loop-bound, so loops never share sockets
        self._pools: dict[tuple[int, str], list] = {}
        self._prober: threading.Thread | None = None
        self._prober_stop = threading.Event()
        self._register_fleet_metrics()
        # fleet-plane observability adopts this process's config: span
        # tracing (front.route trees + traceparent origination), the
        # flight recorder (ejection/readmission lifecycle events), and
        # the front-availability SLO burn-rate gauges
        configure_tracing(config)
        configure_flightrec(config)
        ensure_front_slos(config)

    # -- metrics -----------------------------------------------------------

    def _register_fleet_metrics(self) -> None:
        import weakref

        reg = get_registry()
        ref = weakref.ref(self)
        g_states = reg.gauge(
            "oryx_fleet_replicas",
            "Serving replicas known to the fleet front, by routing state",
            labeled=True,
        )
        for state in _STATES:
            g_states.set_function(_states_reader(ref, state), state=state)
        self._g_skew = reg.gauge(
            "oryx_fleet_generation_skew",
            "Newest minus oldest model generation across replicas not "
            "marked down (ms of batch publish timestamp); growth means a "
            "replica stopped consuming the update topic",
        )
        self._g_gen = reg.gauge(
            "oryx_fleet_replica_generation",
            "Model generation each replica reports on /healthz",
            labeled=True,
        )
        self._g_stale = reg.gauge(
            "oryx_fleet_replica_staleness_seconds",
            "Model staleness each replica reports on /healthz",
            labeled=True,
        )
        self._g_mfu = reg.gauge(
            "oryx_fleet_replica_mfu",
            "Serving-kind device MFU each replica reports on /healthz "
            "(NaN where the replica knows no device peak)",
            labeled=True,
        )
        self._g_lag = reg.gauge(
            "oryx_fleet_replica_update_lag",
            "Update-topic records each replica still has to consume "
            "(its /healthz update_lag); sustained growth on one replica "
            "means it stopped keeping up with model distribution",
            labeled=True,
        )
        self._g_shards = reg.gauge(
            "oryx_fleet_replica_shards",
            "Device-view shard count each replica reports on /healthz "
            "(1 where unsharded); a replica disagreeing with the fleet's "
            "configured oryx.fleet.shards is treated as degraded",
            labeled=True,
        )
        self._g_occ = reg.gauge(
            "oryx_fleet_replica_occupancy",
            "Mean serving dispatch batch occupancy each replica reports "
            "on /healthz over its rolling perf window — the autoscaler's "
            "scale-DOWN signal (sustained low occupancy across the fleet "
            "means capacity is idle)",
            labeled=True,
        )
        self._g_canary_fraction = reg.gauge(
            "oryx_fleet_canary_traffic_fraction",
            "Traffic fraction the front currently splits to the canary "
            "replica (0 = no canary rollout in progress)",
        )
        self._m_canary_requests = reg.counter(
            "oryx_fleet_canary_requests_total",
            "Requests routed while a canary split was active, by cohort: "
            "cohort=canary landed on the canary replica, cohort=fleet "
            "stayed on the incumbent fleet (cohort membership is a "
            "stable hash of the placement key, so one session never "
            "flaps between generations mid-rollout)",
            labeled=True,
        )
        self._m_requests = reg.counter(
            "oryx_fleet_front_requests_total",
            "Requests the front completed, by replica that answered "
            "(replica=none: the FRONT answered with its own error — no "
            "routable replica, or a transport failure on a request that "
            "could not be retried). The front-availability SLO counts "
            "replica=none as the bad fraction, so the label must follow "
            "who actually answered, not who was attempted",
            labeled=True,
        )
        self._m_retries = reg.counter(
            "oryx_fleet_front_retries_total",
            "Requests re-routed to another replica: reason=shed a "
            "deliberate 503 + Retry-After, reason=connect a transport "
            "failure on an idempotent request",
            labeled=True,
        )
        self._m_ejections = reg.counter(
            "oryx_fleet_ejections_total",
            "Health-driven replica ejections at the front",
            labeled=True,
        )
        self._m_fed_errors = reg.counter(
            "oryx_fleet_federation_errors_total",
            "Replica fetches the fleet federation endpoints "
            "(/fleet/metrics, /fleet/traces) could not complete, by "
            "endpoint and replica — that replica's series/spans are "
            "missing from the federated page",
            labeled=True,
        )

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        super().start()
        self._prober = threading.Thread(
            target=self._probe_loop, name="oryx-fleet-prober", daemon=True
        )
        self._prober.start()

    def close(self) -> None:
        self._prober_stop.set()
        if self._prober is not None:
            self._prober.join(timeout=10)
        super().close()
        # pooled backend connections belong to loops that just stopped;
        # closing the transports here only releases the sockets
        for pool in self._pools.values():
            for _, writer in pool:
                try:
                    writer.close()
                except Exception:  # pragma: no cover - loop already dead
                    pass
        self._pools.clear()

    # -- health probing / ejection ----------------------------------------

    def _probe_loop(self) -> None:  # oryxlint: offloop (prober thread)
        while not self._prober_stop.is_set():
            for r in self.replicas:
                self._probe_one(r)
            self._update_skew()
            self._prober_stop.wait(self.probe_interval)

    # blocking http.client exchanges are legal here because the prober is
    # a dedicated thread — never one of the front's event loops
    def _probe_one(self, r: ReplicaInfo) -> None:  # oryxlint: offloop (prober thread)
        import http.client

        status, body = 0, {}
        try:
            conn = http.client.HTTPConnection(
                r.host, r.port, timeout=max(1.0, self.probe_interval)
            )
            try:
                conn.request("GET", "/healthz")
                resp = conn.getresponse()
                status = resp.status
                body = json.loads(resp.read().decode("utf-8", "replace"))
            finally:
                conn.close()
        except Exception:
            status = 0
        if isinstance(body, dict):
            gen = body.get("model_generation")
            r.generation = int(gen) if isinstance(gen, (int, float)) else None
            stale = body.get("staleness_seconds")
            r.staleness_seconds = (
                float(stale) if isinstance(stale, (int, float)) else None
            )
            m = body.get("mfu")
            r.mfu = float(m) if isinstance(m, (int, float)) else None
            lag = body.get("update_lag")
            r.update_lag = int(lag) if isinstance(lag, (int, float)) else None
            # shard-topology rule: this parse is the vocabulary leg
            # ReplicaInfo.shards is fed by — serving's /healthz emits it
            sh = body.get("shards")
            r.shards = (
                int(sh) if isinstance(sh, (int, float))
                else (1 if status in (200, 503) else None)
            )
            q = body.get("quality")
            r.quality = q if isinstance(q, dict) else None
            se = body.get("slo_errors")
            r.slo_errors = se if isinstance(se, dict) else None
            lb = body.get("latency_budget")
            r.latency_budget = lb if isinstance(lb, dict) else None
            mg = body.get("model_gate")
            r.model_gate = mg if isinstance(mg, dict) else None
            sb = body.get("slo_burn")
            r.slo_burn = sb if isinstance(sb, dict) else None
            occ = body.get("occupancy")
            r.occupancy = occ if isinstance(occ, dict) else None
            r.last_reasons = [str(x) for x in body.get("degraded") or []]
        if r.generation is not None:
            self._g_gen.set(float(r.generation), replica=r.id)
        if r.staleness_seconds is not None:
            self._g_stale.set(r.staleness_seconds, replica=r.id)
        if r.mfu is not None:
            self._g_mfu.set(r.mfu, replica=r.id)
        if r.update_lag is not None:
            self._g_lag.set(float(r.update_lag), replica=r.id)
        if r.shards is not None:
            self._g_shards.set(float(r.shards), replica=r.id)
        if isinstance(r.occupancy, dict) and isinstance(
            r.occupancy.get("mean"), (int, float)
        ):
            self._g_occ.set(float(r.occupancy["mean"]), replica=r.id)

        if r.state in ("draining", "gave_up"):
            # a draining replica answers probes healthily ON PURPOSE (it
            # is finishing in-flight work before a scale-down stop) and a
            # gave-up one is dead on purpose (the supervisor stopped
            # restarting it): neither re-enters routing through the
            # readmit counter below
            return

        expect = max(1, self.expect_shards)
        if status == 200 and (r.shards or 1) != expect:
            # shard-aware health: an otherwise-healthy replica serving
            # the wrong shard topology counts as a degraded probe — the
            # same eject-after discipline as a 503, with a reason the
            # ejection log can act on. Checked in BOTH directions: a
            # replica still sharded after the fleet scaled back to
            # unsharded is as mis-deployed as the reverse.
            r.last_reasons = r.last_reasons + [
                f"shard-topology:{r.shards or 1}!={expect}@{r.id}"
            ]
            status = 503

        if status == 200:
            r.consecutive_ok += 1
            r.consecutive_bad = 0
            if not r.routable and r.consecutive_ok >= self.readmit_after:
                log.info(
                    "fleet front: readmitting replica %s (%s:%d)",
                    r.id, r.host, r.port,
                )
                r.routable = True
                get_flightrec().record(
                    kind="readmission", replica=r.id, port=r.port,
                )
            if r.routable:
                r.state = "up"
            return
        r.consecutive_bad += 1
        r.consecutive_ok = 0
        kind = "degraded" if status == 503 else "down"
        if r.routable and r.consecutive_bad >= self.eject_after:
            # the replica-tagged reasons (healthz names its replica id +
            # port) make this line actionable as-is
            log.warning(
                "fleet front: ejecting replica %s (%s:%d) after %d bad "
                "probes: %s",
                r.id, r.host, r.port, r.consecutive_bad,
                r.last_reasons or [f"http-{status}" if status else "unreachable"],
            )
            # state first: a reader that sees the replica unroutable never
            # sees it "up"
            r.state = kind
            r.routable = False
            self._m_ejections.inc(replica=r.id)
            # flight event: `replica` carries the SAME id the dead
            # process stamps on its own events, so a harvested corpse's
            # last words and the front's ejection join on one key
            get_flightrec().record(
                kind="ejection", replica=r.id, port=r.port,
                probes=r.consecutive_bad,
                reasons=r.last_reasons
                or [f"http-{status}" if status else "unreachable"],
            )
        if not r.routable:
            r.state = kind

    def _update_skew(self) -> None:
        gens = [
            r.generation
            for r in self.replicas
            if r.state not in ("down", "gave_up") and r.generation
        ]
        self._g_skew.set(float(max(gens) - min(gens)) if len(gens) > 1 else 0.0)

    # -- placement ---------------------------------------------------------

    def _hash_key(self, path: str) -> str:
        segs = [s for s in path.split("/") if s]
        if 0 <= self.hash_segment < len(segs):
            return segs[self.hash_segment]
        return path

    def _in_canary_cohort(self, path: str) -> bool:
        """Stable cohort membership for the canary split: the SAME hash
        key the placement policy uses, so a user either rides the canary
        for the whole rollout or never sees it — a session comparing its
        own recommendations across requests must not flap between
        generations."""
        import zlib

        key = self._hash_key(path)
        return (zlib.crc32(key.encode("utf-8", "replace")) % 10000) < int(
            self._canary_fraction * 10000
        )

    def _pick(self, path: str, tried: set[str]) -> ReplicaInfo | None:
        candidates = [
            r for r in self.replicas if r.routable and r.id not in tried
        ]
        if not candidates:
            return None
        canary_id = self._canary_id
        if canary_id is not None:
            if self._in_canary_cohort(path):
                if not tried:
                    self._m_canary_requests.inc(cohort="canary")
                canary = next(
                    (r for r in candidates if r.id == canary_id), None
                )
                if canary is not None:
                    return canary
                # canary ejected or already tried: the cohort's requests
                # spill to the incumbent fleet (availability over split
                # purity — the controller sees the ejection and rolls
                # back)
            else:
                if not tried:
                    self._m_canary_requests.inc(cohort="fleet")
                rest = [r for r in candidates if r.id != canary_id]
                if rest:
                    candidates = rest
                # else the canary is the ONLY routable replica: serving
                # the incumbent cohort from it beats a 503
        if self.policy == "hash":
            usable = {r.id for r in candidates}
            for node in self._ring.lookup_seq(self._hash_key(path)):
                if node in usable:
                    return self._by_id[node]
            return None
        with self._rr_lock:
            i = self._rr
            self._rr += 1
        return candidates[i % len(candidates)]

    # -- control plane (fleet/control.py drives these) ----------------------

    def set_canary(self, replica_id: str, fraction: float) -> None:
        """Split a stable cohort of `fraction` of the placement keys to
        one replica — the canary leg of a staged rollout."""
        if replica_id not in self._by_id:
            raise ValueError(f"unknown replica {replica_id!r}")
        self._canary_fraction = min(1.0, max(0.0, float(fraction)))
        self._canary_id = replica_id
        self._g_canary_fraction.set(self._canary_fraction)

    def clear_canary(self) -> None:
        self._canary_id = None
        self._canary_fraction = 0.0
        self._g_canary_fraction.set(0.0)

    def canary(self) -> tuple[str, float] | None:
        cid = self._canary_id
        return (cid, self._canary_fraction) if cid is not None else None

    def add_replica(self, replica_id: str, host: str, port: int) -> ReplicaInfo:
        """Scale-up entry point: join one replica to the routing table
        and the hash ring (a ring add remaps ~1/N of the keyspace — the
        minimal-reshuffle property tests/test_fleet.py asserts). The new
        replica starts UNROUTABLE: its process is still binding, and the
        prober readmits it after readmit-after healthy probes like any
        recovered replica."""
        if replica_id in self._by_id:
            raise ValueError(f"replica {replica_id!r} already present")
        r = ReplicaInfo(replica_id, host, port)
        r.routable = False
        r.state = "down"
        self._by_id[replica_id] = r
        # request/prober threads iterate self.replicas lock-free: publish
        # a NEW list object, never mutate the one they may be walking
        self.replicas = self.replicas + [r]
        self._ring.add(replica_id)
        return r

    def remove_replica(self, replica_id: str) -> None:
        """Drop a (drained) replica from routing and the ring; only the
        removed replica's keys remap."""
        r = self._by_id.pop(replica_id, None)
        if r is None:
            return
        self.replicas = [x for x in self.replicas if x.id != replica_id]
        self._ring.remove(replica_id)
        if self._canary_id == replica_id:
            self.clear_canary()
        # pooled sockets to the removed replica: its process is being
        # stopped, so close our ends instead of waiting for them to
        # error out of the pool one checkout at a time
        for key in [k for k in self._pools if k[1] == replica_id]:
            for _, w in self._pools.pop(key, []):
                try:
                    w.close()
                except Exception:  # pragma: no cover - loop-owned socket
                    pass

    def begin_drain(self, replica_id: str) -> bool:
        """Stop routing NEW requests to a replica while its in-flight
        ones finish (scale-down's graceful half: the caller polls
        inflight() to zero before stopping the process)."""
        r = self._by_id.get(replica_id)
        if r is None:
            return False
        r.routable = False
        r.state = "draining"
        return True

    def inflight(self, replica_id: str) -> int:
        r = self._by_id.get(replica_id)
        if r is None:
            return 0
        with self._inflight_lock:
            return r.inflight

    def mark_gave_up(self, replica_id: str) -> None:
        """Reflect the supervisor's crash-loop give-up in the routing
        table: the replica is out on purpose, not probe-recoverable."""
        r = self._by_id.get(replica_id)
        if r is None:
            return
        r.routable = False
        r.state = "gave_up"

    # -- h1 fast-path proxying ---------------------------------------------
    #
    # The router's per-request budget decides whether fleet scaling is
    # measurable at all: on a host where replicas, front, and load share
    # cores, every millisecond the front burns per request comes straight
    # out of replica capacity. The generic path (base _handle_conn ->
    # _process -> _proxy_once) builds two str header dicts and re-renders
    # both the forwarded request and the response, plus 3-4
    # asyncio.wait_for wraps (~150us EACH on 3.10: each creates a Task +
    # timer). The fast path below replaces all of it for plain HTTP/1.1:
    # it scans the raw head bytes ONCE, forwards the original header
    # block minus hop-by-hop lines, relays the backend's response head
    # VERBATIM, and wraps each backend exchange in a single outer
    # timeout. h2 (prior-knowledge and h2c upgrade) still takes the
    # generic machinery.

    async def _handle_conn(self, ls, reader, writer) -> None:
        task = asyncio.current_task()
        if task is not None:
            ls.conns[task] = True  # idle until a request head arrives
            task.add_done_callback(lambda t: ls.conns.pop(t, None))
        loop = asyncio.get_running_loop()
        try:
            while True:
                # deadline via call_later + transport.abort, not wait_for:
                # wait_for wraps the await in a fresh Task (~150us on
                # 3.10), a per-request tax the router pays out of replica
                # CPU; a TimerHandle is ~10us and the abort surfaces as
                # the connection errors already handled below
                t = loop.call_later(READ_TIMEOUT, writer.transport.abort)
                try:
                    head = await reader.readuntil(b"\r\n\r\n")
                except (
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                    ConnectionError,
                ):
                    return
                except asyncio.LimitOverrunError:
                    await self._simple_response(writer, 400, b"headers too large")
                    return
                finally:
                    t.cancel()
                if len(head) > MAX_HEADER_BYTES:
                    await self._simple_response(writer, 400, b"headers too large")
                    return
                if task is not None:
                    ls.conns[task] = False  # request in flight
                if head == b"PRI * HTTP/2.0\r\n\r\n":
                    # h2 prior knowledge: same hand-off as the base server
                    from oryx_tpu_torch.serving.http2 import Http2Connection

                    rest = await asyncio.wait_for(
                        reader.readexactly(6), timeout=READ_TIMEOUT
                    )
                    if rest != b"SM\r\n\r\n":
                        return
                    await Http2Connection(self, reader, writer, owner=ls).run(
                        preface_read=True
                    )
                    return
                keep = await self._fast_request(reader, writer, head, ls)
                ls.requests += 1
                if task is not None:
                    ls.conns[task] = True  # parked between requests
                if not keep:
                    return
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _fast_request(self, reader, writer, head: bytes, ls) -> bool:
        """One raw-bytes proxied request; returns keep-alive."""
        line_end = head.find(b"\r\n")
        try:
            method_b, target_b, version_b = head[:line_end].split(b" ", 2)
            method = method_b.decode("ascii")
            target = target_b.decode("ascii")
        except (ValueError, UnicodeDecodeError):
            await self._simple_response(writer, 400, b"bad request line")
            return False
        # one scan over the raw header lines: hop-by-hop lines drop out
        # of the forwarded block, the few the router needs are pulled as
        # bytes, everything else forwards untouched
        clen = 0
        conn_opt = b""
        upgrade = b""
        h2c_settings = None
        accept = b""
        tp_raw = b""
        tracing = _TRACER.enabled
        fwd_lines: list[bytes] = []
        for ln in head[line_end + 2 : -4].split(b"\r\n"):
            i = ln.find(b":")
            if i <= 0:
                continue
            key = ln[:i].lower()
            if key == b"content-length":
                try:
                    clen = int(ln[i + 1 :])
                except ValueError:
                    await self._simple_response(writer, 400, b"bad content-length")
                    return False
            elif key == b"connection":
                conn_opt = ln[i + 1 :].strip().lower()
            elif key == b"upgrade":
                upgrade = ln[i + 1 :].strip().lower()
            elif key == b"transfer-encoding":
                if b"chunked" in ln[i + 1 :].lower():
                    await self._simple_response(
                        writer, 400, b"chunked bodies not supported"
                    )
                    return False
            elif key == b"http2-settings":
                h2c_settings = ln[i + 1 :].strip()
            elif key == b"accept":
                # pulled for /fleet/metrics content negotiation; still
                # forwarded so replicas negotiate the same dialect
                accept = ln[i + 1 :].strip()
                fwd_lines.append(ln)
            elif key == b"traceparent":
                # when the front traces, the client's context becomes the
                # front.route span's PARENT and the forwarded hop carries
                # the front's own span id instead (injected below) — the
                # replica's request span then nests under the front's in
                # the stitched tree. Untraced fronts forward it verbatim.
                tp_raw = ln[i + 1 :].strip()
                if not tracing:
                    fwd_lines.append(ln)
            elif key in _DROP_REQUEST_HEADERS_B:
                continue
            else:
                fwd_lines.append(ln)
        if clen > MAX_BODY_BYTES:
            await self._simple_response(writer, 400, b"body too large")
            return False
        body = b""
        if clen:
            try:
                body = await asyncio.wait_for(
                    reader.readexactly(clen), timeout=READ_TIMEOUT
                )
            except (
                asyncio.IncompleteReadError,
                asyncio.TimeoutError,
                ConnectionError,
            ):
                return False
        if (
            upgrade == b"h2c"
            and h2c_settings is not None
            and b"upgrade" in conn_opt
        ):
            # h2c upgrade is the rare path: build the str headers the h2
            # machinery wants and follow the base server's exact protocol
            return await self._h2c_upgrade(
                reader, writer, head, line_end, method, target, body,
                h2c_settings, ls,
            )
        keep_alive = conn_opt != b"close" and version_b != b"HTTP/1.0"
        path = target.split("?", 1)[0]
        if path in ("/fleet/metrics", "/fleet/traces"):
            # fleet-scope fan-out endpoints: async (they fetch every
            # routable replica over the pooled backend connections)
            status, payload, ctype, extra = await self._fleet_endpoint(
                method, path, target, accept.decode("latin-1", "replace")
            )
            await self._write_response(
                writer, status, payload, ctype, method, extra=extra
            )
            return keep_alive
        if path == "/metrics" or path.startswith("/fleet/"):
            status, payload, ctype, extra = self._local_endpoint(method, path)
            await self._write_response(
                writer, status, payload, ctype, method, extra=extra
            )
            return keep_alive

        span = None
        if tracing:
            # the front ORIGINATES a trace when the client sent none;
            # either way the forwarded hop carries the front's span as
            # the replica's parent, so /fleet/traces stitches one tree
            span = _TRACER.start(
                "front.route",
                parent=parse_traceparent(tp_raw.decode("latin-1", "replace")),
                method=method, target=target, policy=self.policy,
            )
            if span is not None:
                fwd_lines.append(
                    b"traceparent: "
                    + format_traceparent(span.trace_id, span.span_id).encode(
                        "ascii"
                    )
                )
        tried: set[str] = set()
        last_shed: tuple[bytes, bytes] | None = None
        fwd_block = b"\r\n".join(fwd_lines)
        try:
            for _ in range(len(self.replicas)):
                r = self._pick(path, tried)
                if r is None:
                    break
                t_try = time.monotonic() if span is not None else 0.0
                try:
                    status, rhead, payload, backend_alive = await self._fast_exchange(
                        r, method, target, fwd_block, body, span=span
                    )
                except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError):
                    if span is not None:
                        _TRACER.record_interval(
                            "front.proxy", t_try, parent=span,
                            replica=r.id, error="connect",
                        )
                    tried.add(r.id)
                    if method in ("GET", "HEAD"):
                        # idempotent: safe to replay on another replica; a
                        # non-idempotent request may have reached the backend
                        # and must not be double-applied
                        self._m_retries.inc(reason="connect")
                        if span is not None:
                            _TRACER.record_interval(
                                "front.retry", time.monotonic(), parent=span,
                                reason="connect", replica=r.id,
                            )
                        continue
                    # the client gets the FRONT's own 502 — no replica
                    # answered, so the series (and the front-availability
                    # SLO's bad fraction) must say none, not r.id
                    self._m_requests.inc(replica="none")
                    if span is not None:
                        span.attrs["status"] = 502
                    await self._write_response(
                        writer,
                        502,
                        b'{"status":502,"error":"replica unreachable"}',
                        "application/json",
                        method,
                    )
                    return keep_alive
                if span is not None:
                    _TRACER.record_interval(
                        "front.proxy", t_try, parent=span,
                        replica=r.id, status=status,
                    )
                if (
                    status == 503
                    and self.retry_shed
                    and b"retry-after" in rhead.lower()
                ):
                    # a shed refused the work before doing it — retrying on a
                    # different replica cannot double-process
                    tried.add(r.id)
                    last_shed = (rhead, payload)
                    self._m_retries.inc(reason="shed")
                    if span is not None:
                        _TRACER.record_interval(
                            "front.retry", time.monotonic(), parent=span,
                            reason="shed", replica=r.id,
                        )
                    continue
                self._m_requests.inc(replica=r.id)
                if span is not None:
                    span.attrs["status"] = status
                    span.attrs["replica"] = r.id
                writer.write(rhead + payload if method != "HEAD" else rhead)
                try:
                    await writer.drain()
                except ConnectionError:
                    return False
                return keep_alive and backend_alive
            if last_shed is not None:
                # every routable replica shed: surface the backpressure (with
                # its Retry-After) instead of inventing a different error
                self._m_requests.inc(replica="none")
                if span is not None:
                    span.attrs["status"] = 503
                rhead, payload = last_shed
                writer.write(rhead + payload if method != "HEAD" else rhead)
                try:
                    await writer.drain()
                except ConnectionError:
                    return False
                return keep_alive
            self._m_requests.inc(replica="none")
            if span is not None:
                span.attrs["status"] = 503
            await self._write_response(
                writer,
                503,
                b'{"status":503,"error":"no routable replica"}',
                "application/json",
                method,
                extra=(("Retry-After", "1"),),
            )
            return keep_alive
        finally:
            if span is not None:
                _TRACER.finish(span)
                _TRACER.log_if_slow(span, log)

    async def _fast_exchange(
        self,
        r: ReplicaInfo,
        method: str,
        target: str,
        fwd_block: bytes,
        body: bytes,
        span=None,
    ) -> tuple[int, bytes, bytes, bool]:
        """One forwarded exchange on a pooled connection, raw bytes both
        ways, under ONE whole-exchange deadline (call_later + abort — see
        _handle_conn). Returns (status, verbatim response head, payload,
        backend keep-alive). ``span`` (the request's front.route span)
        parents a front.connect interval when no pooled socket was
        reusable — pool misses then show up per request in the stitched
        trace instead of hiding inside proxy time."""
        loop = asyncio.get_running_loop()
        with self._inflight_lock:
            r.inflight += 1
        try:
            return await self._fast_exchange_counted(r, method, target, fwd_block, body, loop, span)
        finally:
            with self._inflight_lock:
                r.inflight -= 1

    async def _fast_exchange_counted(
        self, r, method, target, fwd_block, body, loop, span
    ) -> tuple[int, bytes, bytes, bool]:
        key = (id(loop), r.id)
        pool = self._pools.get(key)
        conn = None
        while pool:
            cand = pool.pop()
            if not cand[1].is_closing():
                conn = cand
                break
            cand[1].close()
        if conn is None:
            t_conn = time.monotonic() if span is not None else 0.0
            conn = await asyncio.open_connection(r.host, r.port)
            if span is not None:
                _TRACER.record_interval(
                    "front.connect", t_conn, parent=span, replica=r.id
                )
        reader, writer = conn
        reusable = False
        t = loop.call_later(self.backend_timeout, writer.transport.abort)
        try:
            req = b"".join(
                (
                    method.encode("ascii"),
                    b" ",
                    target.encode("ascii"),
                    b" HTTP/1.1\r\nhost: ",
                    f"{r.host}:{r.port}".encode("ascii"),
                    b"\r\n",
                    fwd_block,
                    b"\r\n" if fwd_block else b"",
                    b"content-length: ",
                    str(len(body)).encode("ascii"),
                    b"\r\n\r\n",
                    body,
                )
            )
            writer.write(req)
            await writer.drain()
            rhead = await reader.readuntil(b"\r\n\r\n")
            sp = rhead.find(b" ")
            status = int(rhead[sp + 1 : sp + 4])
            low = rhead.lower()
            i = low.find(b"\r\ncontent-length:")
            clen = 0
            if i >= 0:
                j = low.find(b"\r\n", i + 17)
                clen = int(low[i + 17 : j])
            payload = b""
            if clen and method != "HEAD" and status not in (204, 304):
                payload = await reader.readexactly(clen)
            reusable = b"\r\nconnection: close" not in low
            return status, rhead, payload, reusable
        finally:
            t.cancel()
            if reusable:
                self._checkin(r, conn)
            else:
                writer.close()

    async def _h2c_upgrade(
        self, reader, writer, head, line_end, method, target, body,
        h2c_settings, ls,
    ) -> bool:
        from oryx_tpu_torch.serving.http2 import Http2Connection, decode_h2c_settings

        if decode_h2c_settings(h2c_settings.decode("latin-1")) is None:
            writer.write(
                b"HTTP/1.1 400 Bad Request\r\n"
                b"Content-Length: 0\r\nConnection: close\r\n\r\n"
            )
            await writer.drain()
            return False
        headers: dict[str, str] = {}
        for ln in head[line_end + 2 : -4].split(b"\r\n"):
            i = ln.find(b":")
            if i > 0:
                headers[ln[:i].decode("latin-1").lower()] = (
                    ln[i + 1 :].strip().decode("latin-1")
                )
        writer.write(
            b"HTTP/1.1 101 Switching Protocols\r\n"
            b"Connection: Upgrade\r\nUpgrade: h2c\r\n\r\n"
        )
        await writer.drain()
        await Http2Connection(
            self, reader, writer,
            upgraded_request=(method, target, headers, body),
            owner=ls,
        ).run(preface_read=False)
        return False

    # -- proxying ----------------------------------------------------------

    async def _checkout(self, r: ReplicaInfo):
        key = (id(asyncio.get_running_loop()), r.id)
        pool = self._pools.get(key)
        while pool:
            reader, writer = pool.pop()
            if not writer.is_closing():
                return reader, writer
            writer.close()
        return await asyncio.wait_for(
            asyncio.open_connection(r.host, r.port),
            timeout=self.backend_timeout,
        )

    def _checkin(self, r: ReplicaInfo, conn) -> None:
        key = (id(asyncio.get_running_loop()), r.id)
        pool = self._pools.setdefault(key, [])
        if len(pool) < self.pool_size and not conn[1].is_closing():
            pool.append(conn)
        else:
            conn[1].close()

    async def _proxy_once(
        self,
        r: ReplicaInfo,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
    ) -> tuple[int, bytes, str, tuple[tuple[str, str], ...]]:
        """One forwarded exchange on a pooled connection. Raises OSError /
        asyncio errors on transport failure (the caller decides whether a
        retry is safe)."""
        with self._inflight_lock:
            r.inflight += 1
        try:
            return await self._proxy_once_counted(r, method, target, headers, body)
        finally:
            with self._inflight_lock:
                r.inflight -= 1

    async def _proxy_once_counted(
        self,
        r: ReplicaInfo,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
    ) -> tuple[int, bytes, str, tuple[tuple[str, str], ...]]:
        conn = await self._checkout(r)
        reader, writer = conn
        reusable = False
        try:
            parts = [
                f"{method} {target} HTTP/1.1\r\nhost: {r.host}:{r.port}\r\n"
            ]
            for k, v in headers.items():
                if k not in _DROP_REQUEST_HEADERS:
                    parts.append(f"{k}: {v}\r\n")
            parts.append(f"content-length: {len(body)}\r\n\r\n")
            writer.write("".join(parts).encode("latin-1") + body)
            await asyncio.wait_for(writer.drain(), timeout=self.backend_timeout)
            head = await asyncio.wait_for(
                reader.readuntil(b"\r\n\r\n"), timeout=self.backend_timeout
            )
            lines = head.split(b"\r\n")
            status = int(lines[0].split(b" ", 2)[1])
            resp_headers: dict[str, str] = {}
            for ln in lines[1:]:
                i = ln.find(b":")
                if i > 0:
                    resp_headers[ln[:i].decode("latin-1").lower()] = (
                        ln[i + 1:].strip().decode("latin-1")
                    )
            clen = int(resp_headers.get("content-length") or 0)
            payload = (
                await asyncio.wait_for(
                    reader.readexactly(clen), timeout=self.backend_timeout
                )
                if clen
                else b""
            )
            reusable = resp_headers.get("connection", "").lower() != "close"
            ctype = resp_headers.get("content-type", "application/octet-stream")
            extra = tuple(
                (k.title(), resp_headers[k])
                for k in _FORWARD_RESPONSE_HEADERS
                if k in resp_headers
            )
            return status, payload, ctype, extra
        finally:
            if reusable:
                self._checkin(r, conn)
            else:
                writer.close()

    async def _process(
        self,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        span=None,
    ) -> tuple[int, bytes, str, tuple[tuple[str, str], ...]]:
        path = target.split("?", 1)[0]
        if path in ("/fleet/metrics", "/fleet/traces"):
            return await self._fleet_endpoint(
                method, path, target, headers.get("accept", "")
            )
        if path == "/metrics" or path.startswith("/fleet/"):
            return self._local_endpoint(method, path)
        fspan = None
        if _TRACER.enabled:
            # same origination/injection contract as the h1 fast lane:
            # the replica's request span parents to the front's
            fspan = _TRACER.start(
                "front.route",
                parent=parse_traceparent(headers.get("traceparent")),
                method=method, target=target, policy=self.policy, proto="h2",
            )
            if fspan is not None:
                headers = dict(headers)
                headers["traceparent"] = format_traceparent(
                    fspan.trace_id, fspan.span_id
                )
        tried: set[str] = set()
        last_shed = None
        try:
            for _ in range(len(self.replicas)):
                r = self._pick(path, tried)
                if r is None:
                    break
                t_try = time.monotonic() if fspan is not None else 0.0
                try:
                    status, payload, ctype, extra = await self._proxy_once(
                        r, method, target, headers, body
                    )
                except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError):
                    if fspan is not None:
                        _TRACER.record_interval(
                            "front.proxy", t_try, parent=fspan,
                            replica=r.id, error="connect",
                        )
                    tried.add(r.id)
                    if method in ("GET", "HEAD"):
                        # idempotent: safe to replay on another replica; a
                        # non-idempotent request may have reached the backend
                        # and must not be double-applied
                        self._m_retries.inc(reason="connect")
                        if fspan is not None:
                            _TRACER.record_interval(
                                "front.retry", time.monotonic(),
                                parent=fspan, reason="connect", replica=r.id,
                            )
                        continue
                    # front-authored 502: no replica answered (see the
                    # h1 fast path — the SLO's bad fraction rides this)
                    self._m_requests.inc(replica="none")
                    if fspan is not None:
                        fspan.attrs["status"] = 502
                    return (
                        502,
                        b'{"status":502,"error":"replica unreachable"}',
                        "application/json",
                        (),
                    )
                if fspan is not None:
                    _TRACER.record_interval(
                        "front.proxy", t_try, parent=fspan,
                        replica=r.id, status=status,
                    )
                is_shed = status == 503 and any(
                    k.lower() == "retry-after" for k, _ in extra
                )
                if is_shed and self.retry_shed:
                    # a shed refused the work before doing it — retrying on a
                    # different replica cannot double-process
                    tried.add(r.id)
                    last_shed = (status, payload, ctype, extra)
                    self._m_retries.inc(reason="shed")
                    if fspan is not None:
                        _TRACER.record_interval(
                            "front.retry", time.monotonic(), parent=fspan,
                            reason="shed", replica=r.id,
                        )
                    continue
                self._m_requests.inc(replica=r.id)
                if fspan is not None:
                    fspan.attrs["status"] = status
                    fspan.attrs["replica"] = r.id
                return status, payload, ctype, extra
            if last_shed is not None:
                # every routable replica shed: surface the backpressure (with
                # its Retry-After) instead of inventing a different error
                self._m_requests.inc(replica="none")
                if fspan is not None:
                    fspan.attrs["status"] = 503
                return last_shed
            self._m_requests.inc(replica="none")
            if fspan is not None:
                fspan.attrs["status"] = 503
            return (
                503,
                b'{"status":503,"error":"no routable replica"}',
                "application/json",
                (("Retry-After", "1"),),
            )
        finally:
            if fspan is not None:
                _TRACER.finish(fspan)
                _TRACER.log_if_slow(fspan, log)

    # -- fleet-scope fan-out endpoints -------------------------------------

    async def _fleet_endpoint(
        self, method: str, path: str, target: str, accept: str
    ) -> tuple[int, bytes, str, tuple]:
        """The two federation endpoints: both fetch every ROUTABLE
        replica over the pooled backend connections (ejected replicas are
        skipped — their last-known series/spans are not re-exported as if
        live), merge, and re-export. Unreachable replicas are skipped and
        counted (oryx_fleet_federation_errors_total); one dead replica
        must not fail the whole fleet page."""
        if method not in ("GET", "HEAD"):
            return (
                405,
                b'{"status":405,"error":"method not allowed"}',
                "application/json",
                (),
            )
        query = parse_qs(target.partition("?")[2])
        if path == "/fleet/metrics":
            # OpenMetrics negotiation passes THROUGH: replicas render the
            # dialect the client asked the front for, so exemplars (legal
            # only under OpenMetrics) survive federation verbatim
            wants_om = "application/openmetrics-text" in accept
            pages = await self._fetch_routable(
                "/metrics",
                b"accept: application/openmetrics-text" if wants_om else b"",
            )
            text = federate(pages, openmetrics=wants_om)
            ctype = (
                "application/openmetrics-text; version=1.0.0; charset=utf-8"
                if wants_om else "text/plain; version=0.0.4"
            )
            return 200, text.encode("utf-8"), ctype, ()
        # /fleet/traces: fetch each replica's span forest, add the
        # front's own, stitch by trace id
        try:
            limit = int((query.get("limit") or ["0"])[0])
        except ValueError:
            return 400, b'{"status":400,"error":"bad limit"}', "application/json", ()
        suffix = f"?limit={limit}" if limit > 0 else ""
        pages = await self._fetch_routable("/debug/traces" + suffix, b"")
        procs: list[tuple[str, list[dict]]] = [
            ("front", span_forest(_TRACER.snapshot()))
        ]
        for rid, text in pages:
            try:
                doc = json.loads(text)
            except json.JSONDecodeError:
                self._m_fed_errors.inc(endpoint="/fleet/traces", replica=rid)
                continue
            forest = doc.get("traces")
            if isinstance(forest, list):
                procs.append((rid, forest))
        if (query.get("format") or [""])[0] == "chrome":
            body = json.dumps(stitched_chrome(procs), default=str)
        else:
            body = json.dumps(
                {
                    "enabled": _TRACER.enabled,
                    "processes": [label for label, _ in procs],
                    "traces": stitch_traces(procs),
                },
                default=str,
            )
        return 200, body.encode("utf-8"), "application/json", ()

    async def _fetch_routable(
        self, path: str, extra_header: bytes
    ) -> list[tuple[str, str]]:
        """GET ``path`` from every routable replica CONCURRENTLY (each on
        its own pooled connection, under its own backend-timeout — the
        page costs the slowest replica, never the sum, so a hung
        not-yet-ejected replica can't stall the whole fleet scrape past
        Prometheus's scrape_timeout); [(replica id, body text)], failures
        skipped + counted."""
        endpoint = path.partition("?")[0]

        async def fetch(r: ReplicaInfo) -> tuple[str, str] | None:
            try:
                status, _rhead, payload, _alive = await self._fast_exchange(
                    r, "GET", path, extra_header, b""
                )
            except (OSError, asyncio.IncompleteReadError, asyncio.TimeoutError):
                self._m_fed_errors.inc(endpoint=endpoint, replica=r.id)
                return None
            if status != 200:
                self._m_fed_errors.inc(endpoint=endpoint, replica=r.id)
                return None
            return r.id, payload.decode("utf-8", "replace")

        results = await asyncio.gather(
            *(fetch(r) for r in self.replicas if r.routable)
        )
        return [x for x in results if x is not None]

    # -- front-local endpoints --------------------------------------------

    def _local_endpoint(
        self, method: str, path: str
    ) -> tuple[int, bytes, str, tuple]:
        if path == "/metrics" and method in ("GET", "HEAD"):
            text = get_registry().render_prometheus()
            return 200, text.encode("utf-8"), "text/plain; version=0.0.4", ()
        if path == "/fleet/status" and method in ("GET", "HEAD"):
            from oryx_tpu_torch.common import slo
            from oryx_tpu_torch.fleet.observe import merge_latency_budgets

            body = json.dumps(
                {
                    "policy": self.policy,
                    "shards": self.expect_shards,
                    # active canary split (null outside a rollout): the
                    # controller's view of who serves the new generation
                    "canary": (
                        {
                            "replica": self._canary_id,
                            "fraction": self._canary_fraction,
                        }
                        if self._canary_id is not None
                        else None
                    ),
                    # SLO source reads that raised (slo -> last error):
                    # broken burn-rate math must be visible, not a
                    # silently flat gauge (oryx_slo_sample_errors_total)
                    "slo_errors": slo.sample_errors(),
                    # fleet-level phase/idle-gap waterfall merged from the
                    # per-replica healthz latency_budget sections
                    "latency_budget": merge_latency_budgets(
                        [
                            r.latency_budget
                            for r in self.replicas
                            if r.latency_budget is not None
                        ]
                    ),
                    "replicas": [r.snapshot() for r in self.replicas],
                }
            )
            return 200, body.encode("utf-8"), "application/json", ()
        if path == "/fleet/healthz" and method in ("GET", "HEAD"):
            n = sum(1 for r in self.replicas if r.routable)
            status = 200 if n else 503
            body = json.dumps(
                {"routable": n, "replicas": len(self.replicas)}
            )
            return status, body.encode("utf-8"), "application/json", ()
        return 404, b'{"status":404,"error":"no such fleet endpoint"}', (
            "application/json"
        ), ()
