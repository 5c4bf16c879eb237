"""Mini resource framework: routing, content negotiation, readiness gating
(the port's copy of oryx_tpu/serving/app.py).

Plays the role of Jersey + the serving base resources
(OryxApplication.java's annotation scan, AbstractOryxResource's model
readiness gate and sendInput, CSVMessageBodyWriter's text/csv rendering,
OryxExceptionMapper's error mapping — SURVEY.md §2.5, §2.11). Routes are
registered by app modules through register(app); path patterns support
{name} segments and {name:rest} tails.
"""

from __future__ import annotations

import json
import re
import threading
import time
import weakref
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable

from oryx_tpu_torch.api import ServingModelManager
from oryx_tpu_torch.bus.api import TopicProducer
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.metrics import GaugeSeriesGone, get_registry
from oryx_tpu_torch.common.perfattr import swap_ledger
from oryx_tpu_torch.common.tracing import configure_tracing, swap_current
from oryx_tpu_torch.serving.futureutil import try_set_exception, try_set_result


@dataclass
class RawResponse:
    """Bypass content negotiation — body served verbatim (e.g. /metrics
    Prometheus text, HTML consoles)."""

    status: int
    body: bytes
    content_type: str


@dataclass
class Deferred:
    """A handler result that completes later (device-batched endpoints).

    Handlers return Deferred(future-of-raw-result) instead of parking
    their worker thread on the micro-batcher; the async frontend awaits
    the future on the event loop, so in-flight request capacity is bounded
    by memory, not by worker-pool threads (the reference's analogue is
    Tomcat NIO async servlets). The threaded frontend and direct
    dispatch() callers keep blocking semantics.
    """

    future: "Future"


def chain_future(
    future: "Future", fn: Callable[[Any], Any], executor=None
) -> "Future":
    """Future of fn(future.result()), exceptions carried through. With an
    executor, fn runs there instead of inline in the completing thread —
    REQUIRED when the completing thread is a latency-critical loop (the
    batcher dispatcher) or when fn may block."""
    out: Future = Future()

    def _apply(f):
        # out may already be cancelled: the async frontend's
        # asyncio.wrap_future cancels it on client disconnect / shutdown
        # drain — try_set absorbs the lost race instead of raising
        # InvalidStateError inside a done-callback
        try:
            result = fn(f.result())
        except BaseException as e:  # noqa: BLE001 - carried downstream
            try_set_exception(out, e)
            return
        try_set_result(out, result)

    if executor is None:
        future.add_done_callback(_apply)
    else:

        def _bounce(f):
            try:
                executor.submit(_apply, f)
            except Exception:
                # pool shut down: fail the future rather than leave
                # blocked callers hanging — and never run fn inline here,
                # because the completing thread may be the batcher
                # dispatcher, which arbitrary fn code could deadlock
                try_set_exception(
                    out, RuntimeError("post-processing pool is shut down")
                )
        future.add_done_callback(_bounce)
    return out


def deferred_map(future: "Future", fn: Callable[[Any], Any]) -> Deferred:
    """Deferred whose result is fn(future.result())."""
    return Deferred(chain_future(future, fn))


_POST_POOL = None
_POST_POOL_LOCK = threading.Lock()
_POST_POOL_WORKERS = 8  # overridden from config by the serving managers


def configure_post_pool(workers: int) -> None:
    """Size the post-processing pool (oryx.serving.api.post-workers) —
    takes effect at first use; an already-created pool keeps its size."""
    global _POST_POOL_WORKERS
    _POST_POOL_WORKERS = max(1, int(workers))


def post_pool():
    """Shared pool for per-request post-processing chained off batcher
    futures (sized for trim/render work; a rescorer that blocks holds one
    of these threads, never the batcher dispatcher — and blocking top_n()
    callers post-process on their own thread, so nested rescorer queries
    cannot exhaust this pool into a deadlock). Shared across apps."""
    global _POST_POOL
    if _POST_POOL is None:
        with _POST_POOL_LOCK:
            if _POST_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _POST_POOL = ThreadPoolExecutor(
                    max_workers=_POST_POOL_WORKERS,
                    thread_name_prefix="oryx-topn-post",
                )
    return _POST_POOL


class OryxServingException(Exception):
    """HTTP-status-carrying error (reference OryxServingException).
    ``headers`` ride the response (e.g. Retry-After on a load shed)."""

    def __init__(
        self,
        status: int,
        message: str = "",
        headers: tuple[tuple[str, str], ...] = (),
    ):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers


class ShedLoad(OryxServingException):
    """Deliberate 503 under saturation: the serving tier refuses work it
    cannot queue honestly (batcher backlog past its bound) instead of
    letting latency grow without limit. Carries Retry-After so
    well-behaved clients back off. The shed DECISION site (not this
    constructor) increments `oryx_serving_shed_total`, so the chaos
    suite can tell a deliberate shed from a real 5xx without merely-
    constructed instances skewing the count."""

    def __init__(self, message: str = "overloaded", retry_after_sec: int = 1):
        super().__init__(
            503, message,
            headers=(("Retry-After", str(int(retry_after_sec))),),
        )


@dataclass
class Request:
    method: str
    path: str
    params: dict[str, str]
    query: dict[str, list[str]]
    body: bytes
    headers: dict[str, str]
    # the request's tracing span (common/tracing.py), set by the frontend
    # when tracing is enabled; dispatch installs it as the thread-current
    # span so batcher/bus instrumentation parents to it
    trace: Any = None
    # the request's phase ledger (common/perfattr.py PhaseLedger), created
    # by the frontend at parse time and flushed by it after the response
    # bytes are written; dispatch installs it as the thread-current ledger
    # so the batcher stamps queue/pad/device phases without signature
    # threading. None when dispatched outside an HTTP frontend.
    ledger: Any = None
    # extra RESPONSE headers accumulated during dispatch (Retry-After on
    # sheds, Warning on stale-model responses); frontends read this after
    # the response renders. A side channel rather than a wider render
    # tuple so the (status, body, content_type) contract stays stable.
    response_headers: list = field(default_factory=list)

    def q1(self, name: str, default: str | None = None) -> str | None:
        vals = self.query.get(name)
        return vals[0] if vals else default

    def q_list(self, name: str) -> list[str]:
        return self.query.get(name, [])

    def body_text(self) -> str:
        return self.body.decode("utf-8")


@dataclass
class _Route:
    method: str
    pattern: re.Pattern
    handler: Callable[["ServingApp", Request], Any]
    nonblocking: bool = False


def _compile(pattern: str) -> re.Pattern:
    parts = []
    for seg in pattern.strip("/").split("/"):
        if seg.startswith("{") and seg.endswith("}"):
            name = seg[1:-1]
            if name.endswith(":rest"):
                parts.append(f"(?P<{name[:-5]}>.+)")
            else:
                parts.append(f"(?P<{name}>[^/]+)")
        else:
            parts.append(re.escape(seg))
    return re.compile("^/" + "/".join(parts) + "$")


def _first_literal(pattern: str) -> str | None:
    """The pattern's literal first segment, or None when it's a parameter —
    the index key for O(1) route-group lookup on the hot path."""
    seg = pattern.strip("/").split("/", 1)[0]
    return None if seg.startswith("{") else seg


class ServingApp:
    """Holds the model manager, input producer, config, and route table."""

    def __init__(
        self,
        config: Config,
        model_manager: ServingModelManager,
        input_producer: TopicProducer | None = None,
    ):
        self.config = config
        self.model_manager = model_manager
        self.input_producer = input_producer
        self.min_fraction = config.get_float("oryx.serving.min-model-load-fraction", 0.8)
        # degraded-mode bound: a served model whose publish stamp is older
        # than this gets a Warning: 110 header on every model-backed
        # response and flips /healthz readiness (null = no bound). The
        # model still serves — stale answers beat no answers — but probes
        # and clients can SEE the degradation.
        raw_stale = config.get("oryx.serving.api.max-staleness-sec", None)
        self.max_staleness_sec = float(raw_stale) if raw_stale is not None else None
        # fleet identity: names this process in degraded reasons, the
        # fleet front's ejection log, and oryx_fleet_replica_* labels
        # (set per replica by fleet/supervisor.py; null outside a fleet)
        self.replica_id = config.get_string("oryx.fleet.replica.id", None)
        # the bound listening port, filled in by the serving layer once
        # the (possibly ephemeral) bind resolves; 0 until then
        self.listen_port = 0
        # update-topic consumer backlog callback (ConsumeDataIterator.lag),
        # wired by ServingLayer so /healthz can report update_lag
        self.update_lag_fn = None
        # mount point (reference: Tomcat context path, ServingLayer.java);
        # "" = root. Requests outside the prefix 404 before routing.
        raw_ctx = (config.get_string("oryx.serving.api.context-path", "/") or "/").strip("/")
        self.context_path = f"/{raw_ctx}" if raw_ctx else ""
        self.routes: list[_Route] = []
        # routes indexed by literal first path segment; None key holds
        # patterns whose first segment is a parameter (scanned after the
        # group). Dispatch touches ~2 candidate routes instead of all.
        self._route_index: dict[str | None, list[_Route]] = {}
        # fully-literal patterns resolved by ONE dict lookup on
        # (method, path) — no regex on the hot path. Consistent with the
        # precedence contract: an exact hit IS the winning literal route
        # (first registration wins via setdefault; a miss — unknown path
        # or method — falls through to the indexed scan for 404/405).
        self._exact_routes: dict[tuple[str, str], _Route] = {}
        self.fast_segments: set[str] = set()
        self._slow_segments: set[str] = set()
        self._wildcard_blocking = False
        # app modules append (title, fn(app) -> rows) callbacks here; the
        # generic /console renders each as its own table — the equivalent
        # of the reference's per-app Console subclasses (e.g. als/Console.java)
        self.console_sections: list[tuple[str, Callable[["ServingApp"], list[tuple[str, Any]]]]] = []
        # tracing follows THIS app's config (last constructed wins — one
        # config per process); /healthz reports uptime + frontend fan-out
        configure_tracing(config)
        # runtime perf accounting (live MFU/occupancy gauges, /debug/
        # profile window knobs) adopts the same config and pre-registers
        # its metric families
        from oryx_tpu_torch.common.perfstats import configure_perfstats

        configure_perfstats(config)
        # latency attribution (phase budgets, idle-gap classification,
        # compile-storm + burn-triggered capture knobs) adopts the same
        # config and pre-registers its families
        from oryx_tpu_torch.common.perfattr import configure_perfattr

        configure_perfattr(config)
        # the update-topic listener's artifact relay adopts the fleet's
        # distribution mode (shared per-host cache vs per-process decode)
        from oryx_tpu_torch.common.artifact import configure_artifact_relay

        configure_artifact_relay(config)
        # the flight recorder (on-disk lifecycle ring + snapshot bundler,
        # common/flightrec.py) and the config-declared SLO burn-rate
        # gauges (common/slo.py) adopt the same config
        from oryx_tpu_torch.common.flightrec import configure_flightrec
        from oryx_tpu_torch.common.slo import ensure_serving_slos

        configure_flightrec(config).record(
            kind="process-start",
            role="serving",
            port=config.get_int("oryx.serving.api.port", 0),
        )
        ensure_serving_slos(config)
        # live model-quality plane (common/qualitystats.py): shadow
        # rescore sampling of served responses, drift gauges, and the
        # quality SLO — adopt the same config and pre-register families
        from oryx_tpu_torch.common.qualitystats import configure_qualitystats

        configure_qualitystats(config)
        # staged model adoption (common/modelgate.py): canary/hold/off
        # per oryx.serving.model-gate.mode, configured before the update
        # listener starts replaying the topic
        from oryx_tpu_torch.common.modelgate import configure_model_gate

        configure_model_gate(config)

        # healthz up->degraded edge detection (note_health_state): the
        # transition automatically triggers a flight snapshot off-thread
        self._last_health_degraded = False
        self.started_at = time.monotonic()
        self.loop_count = 1  # the async frontend overwrites with its fan-out
        reg = get_registry()
        self._m_requests = reg.counter(
            "oryx_serving_requests_total",
            "Serving requests by method and status",
            labeled=True,
        )
        self._m_latency = reg.histogram(
            "oryx_serving_request_seconds", "Serving request latency by method"
        )
        # label by manager class and hold the app weakly: several ServingApps
        # can coexist in one process (tests, embedders) and the process-global
        # registry must neither pin them alive nor conflate their models
        ref = weakref.ref(self)
        reg.gauge(
            "oryx_serving_model_load_fraction", "Fraction of the model loaded"
        ).set_function(
            lambda: _load_fraction(ref), manager=type(model_manager).__name__
        )
        # model-freshness metrics (oryx_update_to_serve_seconds and
        # friends, common/freshness.py) register on first touch so the
        # serving /metrics page always exposes them
        from oryx_tpu_torch.common.freshness import model_freshness

        model_freshness()
        # adopt the config's retry policy / fault plan (the serving
        # process's bus producer+consumer run under them too) and
        # pre-register the robustness metric families — dashboards need
        # the zero baseline from process start, not a series that pops
        # into existence on the first retry/shed event
        from oryx_tpu_torch.common import quarantine, retry
        from oryx_tpu_torch.common.faults import configure_faults, get_injector
        from oryx_tpu_torch.layers import watchdog

        retry.configure_retry(config)
        configure_faults(config)
        retry.ensure_metrics()
        quarantine.ensure_metrics()
        get_injector().ensure_metrics()
        watchdog.ensure_metrics()
        reg.counter(
            "oryx_serving_shed_total",
            "Requests deliberately shed with 503 + Retry-After because a "
            "serving queue was saturated",
        )
        self._load_resources()

    def _load_resources(self) -> None:
        """Import configured resource modules and let them register routes —
        the OryxApplication package-scan equivalent."""
        import importlib

        for mod_name in self.config.get_list("oryx.serving.application-resources", []):
            mod = importlib.import_module(str(mod_name))
            register = getattr(mod, "register", None)
            if register is None:
                raise ValueError(f"resource module {mod_name} has no register(app)")
            register(self)

    def route(self, method: str, pattern: str, nonblocking: bool = False):
        """Register a handler. nonblocking=True declares the handler does
        no blocking work (state lookups + submit_nowait only) — the async
        frontend then runs it INLINE on the event loop instead of paying
        two thread hops through the worker pool per request (measured
        ~25% of the per-request server cost on the serving hot path)."""
        def deco(fn):
            r = _Route(method.upper(), _compile(pattern), fn, nonblocking)
            self.routes.append(r)
            if "{" not in pattern:
                stripped = pattern.strip("/")
                norm = f"/{stripped}" if stripped else "/"
                self._exact_routes.setdefault((r.method, norm), r)
            seg = _first_literal(pattern)
            self._route_index.setdefault(seg, []).append(r)
            # a first segment is "fast" only while EVERY route under it is
            # nonblocking: one blocking sibling poisons the whole segment
            # (the frontend decides before matching the exact route)
            if seg is None:
                # param-first routes are match candidates for EVERY path,
                # so a blocking one disables fast dispatch entirely
                if not nonblocking:
                    self._wildcard_blocking = True
            elif nonblocking and seg not in self._slow_segments:
                self.fast_segments.add(seg)
            else:
                self._slow_segments.add(seg)
                self.fast_segments.discard(seg)
            return fn

        return deco

    def is_fast(self, path: str) -> bool:
        """True when every route that could match `path` is marked
        nonblocking — the async frontend may dispatch inline. Applies the
        same context-path strip as _dispatch so the segment examined is
        the one routing will actually use."""
        if self._wildcard_blocking:
            return False
        if self.context_path:
            if path.startswith(self.context_path + "/"):
                path = path[len(self.context_path):]
            else:
                return False  # context root / outside-context: not hot paths
        first = path.lstrip("/").split("/", 1)[0]
        return first in self.fast_segments

    # -- helpers resources use (AbstractOryxResource equivalents) ----------

    def get_serving_model(self):
        """The loaded model, or 503 until fraction-loaded crosses the
        threshold (AbstractOryxResource.java:75-95). The 503 carries
        ``Retry-After``: like a shed, it refused the request before doing
        any work, so a fleet front retries it on another replica (a
        restarted replica answers its probes before its model loads). A
        model past the configured staleness bound still serves, but the
        response carries a ``Warning: 110`` header (RFC 7234 "response is
        stale") so clients and probes can see degraded mode."""
        model = self.model_manager.get_model()
        if model is None or model.fraction_loaded() < self.min_fraction:
            raise OryxServingException(
                503, "model not yet available", headers=(("Retry-After", "1"),)
            )
        staleness = self.model_staleness()
        if staleness is not None:
            req = getattr(_current_request, "req", None)
            if req is not None:
                req.response_headers.append((
                    "Warning",
                    f'110 - "stale model: {staleness:.0f}s past publish, '
                    f'bound {self.max_staleness_sec:.0f}s"',
                ))
        return model

    def model_staleness(self) -> float | None:
        """Seconds the served model is past its publish stamp IF that
        exceeds the configured bound, else None (no bound, no stamp yet,
        or fresh). Based on the update-topic publish stamps
        (common/freshness.py), so it measures the pipeline end to end —
        a dead batch layer shows up here even though serving is healthy."""
        if self.max_staleness_sec is None:
            return None
        from oryx_tpu_torch.common.freshness import model_freshness

        f = model_freshness()
        if f.published_ms is None:
            return None  # never stamped: unknown, not provably stale
        age = max(0.0, time.time() * 1000.0 - f.published_ms) / 1000.0
        return age if age > self.max_staleness_sec else None

    def degraded_reasons(self) -> list[str]:
        """Why this serving process is degraded right now (empty = fully
        healthy). The /healthz readiness surface: model past its
        staleness bound, the card down after a wedged top-k dispatch
        (requests get 503 until a probe recovers it), or a co-resident
        layer's wedge watchdog tripped.

        In a fleet, each reason carries this replica's identity
        (``model-stale@r1:8101``): a front aggregating N processes' probe
        bodies into one ejection log needs reasons that name the process,
        not anonymous strings N replicas all emit identically."""
        reasons: list[str] = []
        if self.model_staleness() is not None:
            reasons.append("model-stale")
        from oryx_tpu_torch.serving.batcher import TopKBatcher

        b = TopKBatcher._shared  # peek; never construct on a probe path
        if b is not None and b._device_down.is_set():
            reasons.append("device-down")
        from oryx_tpu_torch.layers.watchdog import wedged_layers

        reasons.extend(f"wedged:{name}" for name in wedged_layers())
        if self.replica_id:
            tag = f"@{self.replica_id}:{self.listen_port}"
            reasons = [r + tag for r in reasons]
        return reasons

    def note_health_state(self, degraded: bool, reasons: list[str]) -> None:
        """Edge detector behind the automatic flight snapshot: the FIRST
        probe that sees up→degraded bundles the black box (events, recent
        spans, dispatch ring, metrics, config fingerprint) on a one-shot
        daemon thread — by the time a human looks, the evidence of HOW it
        degraded is already on disk. Called from the (nonblocking)
        healthz handler; the cheap path is two attribute touches."""
        prev = self._last_health_degraded
        self._last_health_degraded = degraded
        if degraded and not prev:
            from oryx_tpu_torch.common.flightrec import get_flightrec

            # record + bundle both happen on the snapshot thread: this
            # handler runs INLINE on the event loop, and the flight dir's
            # disk may be exactly what is degrading
            get_flightrec().snapshot_async(
                "healthz-degraded",
                event={"kind": "health-degraded", "reasons": reasons},
            )

    def staleness_age(self) -> float | None:
        """Raw age in seconds of the served model's publish stamp (None
        until a stamped model loaded) — the number behind
        ``oryx_model_staleness_seconds``, reported on /healthz regardless
        of the degraded bound so a fleet front can watch staleness
        converge per replica instead of only seeing the bound trip."""
        from oryx_tpu_torch.common.freshness import model_freshness

        p = model_freshness().published_ms
        if p is None:
            return None
        return max(0.0, time.time() * 1000.0 - p) / 1000.0

    def send_input(self, line: str) -> None:
        """POST a raw input line to the input topic, keyed by its hash
        (AbstractOryxResource.sendInput). crc32, not hash(): the builtin is
        salted per process (PYTHONHASHSEED), which would make partition
        assignment — and thus cross-partition read interleaving — vary
        between processes; the reference's hashCode partitioner is stable."""
        if self.input_producer is None:
            raise OryxServingException(405, "serving layer is read-only")
        import zlib

        self.input_producer.send(str(zlib.crc32(line.encode("utf-8"))), line)

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, req: Request) -> tuple[int, bytes, str]:
        """Route and render; returns (status, body_bytes, content_type).
        Blocks on deferred handlers — the contract tests and the threaded
        frontend rely on."""
        resp = self.dispatch_nowait(req)
        if isinstance(resp, Deferred):
            resp = resp.future.result()
        return resp

    def dispatch_nowait(self, req: Request):
        """Route and render without blocking on deferred handlers: returns
        either a rendered (status, body, content_type) tuple or a Deferred
        of one (the async frontend awaits it off-thread)."""
        start = time.monotonic()
        # install the request's phase ledger as this thread's current one
        # for the synchronous handler call, so the batcher's submit path
        # attaches it to the pending request without signature threading
        prev_ledger = swap_ledger(req.ledger)
        try:
            if req.trace is not None:
                # install the request span as this thread's current span
                # for the synchronous handler call, so instrumentation
                # below it (batcher submit) parents without signature
                # threading
                prev = swap_current(req.trace)
                try:
                    resp = self._dispatch(req)
                finally:
                    swap_current(prev)
            else:
                resp = self._dispatch(req)
        finally:
            swap_ledger(prev_ledger)
        if isinstance(resp, Deferred):
            rendered: Future = Future()

            def _finish(f):
                try:
                    out = _render(f.result(), req)
                except BaseException as e:  # noqa: BLE001 - boundary
                    out = _render_exception(e, req)
                self._observe(req, start, out[0])
                try_set_result(rendered, out)

            resp.future.add_done_callback(_finish)
            return Deferred(rendered)
        self._observe(req, start, resp[0])
        return resp

    def _observe(self, req: Request, start: float, status: int) -> None:
        # bucket unknown methods: the label is client-controlled and must
        # not grow the process-global registry without bound
        method = req.method if req.method in _KNOWN_METHODS else "OTHER"
        # traced requests leave their trace id as the bucket's exemplar:
        # a latency bucket on /metrics then names a concrete request
        # joinable against /debug/traces (OpenMetrics exemplar syntax)
        trace_id = req.trace.trace_id if req.trace is not None else None
        self._m_latency.observe(
            time.monotonic() - start, trace_id=trace_id, method=method
        )
        self._m_requests.inc(method=method, status=str(status))

    def _dispatch(self, req: Request):
        # thread-current request for the duration of the handler call:
        # helpers without a req in their signature (get_serving_model's
        # stale-model Warning) attach response headers through it
        prev_req = getattr(_current_request, "req", None)
        _current_request.req = req
        try:
            return self._dispatch_routed(req)
        finally:
            _current_request.req = prev_req

    def _dispatch_routed(self, req: Request):
        if self.context_path:
            if req.path == self.context_path:
                req.path = "/"
            elif req.path.startswith(self.context_path + "/"):
                req.path = req.path[len(self.context_path):]
            else:
                return _render_error(
                    404, f"outside context path {self.context_path}", req
                )
        # Literal fast path: a parameterless route resolves with one dict
        # probe and zero regex work (the /recommend-family hot paths are
        # parameterized and take the indexed scan below; /ready, /metrics
        # and the console land here).
        exact = self._exact_routes.get((req.method, req.path))
        if exact is not None:
            req.params = {}
            try:
                result = exact.handler(self, req)
            except Exception as e:  # noqa: BLE001 - boundary: render error
                return _render_exception(e, req)
            if isinstance(result, Deferred):
                return result  # rendered at completion by dispatch_nowait
            return _render(result, req)
        # Precedence contract: literal-first-segment routes match before
        # parameter-first ones; within each group, registration order wins.
        # (This differs from a pure registration-order scan only when a
        # module registers /{param} before a literal sibling — literal
        # specificity winning is the intended behavior, pinned by
        # tests/test_aserver.py::test_route_precedence.)
        first = req.path.lstrip("/").split("/", 1)[0]
        candidates = self._route_index.get(first, ())
        wildcard = self._route_index.get(None, ())
        matched_path = False
        for r in (*candidates, *wildcard):
            m = r.pattern.match(req.path)
            if not m:
                continue
            matched_path = True
            if r.method != req.method:
                continue
            req.params = {k: _unquote(v) for k, v in m.groupdict().items()}
            try:
                result = r.handler(self, req)
            except Exception as e:  # noqa: BLE001 - boundary: render error
                return _render_exception(e, req)
            if isinstance(result, Deferred):
                return result  # rendered at completion by dispatch_nowait
            return _render(result, req)
        if matched_path:
            return _render_error(405, "method not allowed", req)
        return _render_error(404, f"no such endpoint: {req.path}", req)


_KNOWN_METHODS = frozenset({"GET", "HEAD", "POST", "PUT", "DELETE", "PATCH", "OPTIONS"})

# the request being dispatched on this thread (see ServingApp._dispatch)
_current_request = threading.local()


def _load_fraction(app_ref) -> float:
    app = app_ref()
    if app is None:
        raise GaugeSeriesGone("serving app gone")  # render() drops the series
    model = app.model_manager.get_model()
    return model.fraction_loaded() if model is not None else 0.0


def _unquote(s: str) -> str:
    from urllib.parse import unquote

    return unquote(s)


def _wants_json(req: Request) -> bool:
    accept = req.headers.get("accept", "")
    if "application/json" in accept:
        return True
    if "text/csv" in accept or "text/plain" in accept:
        return False
    return True  # default JSON


def _to_csv_rows(value: Any) -> list[list]:
    from oryx_tpu_torch.common.text import join_csv

    if value is None:
        return []
    if isinstance(value, dict):
        return [[k, v] for k, v in value.items()]
    if isinstance(value, (list, tuple)):
        rows = []
        for item in value:
            if isinstance(item, (list, tuple)):
                rows.append(list(item))
            elif isinstance(item, dict):
                rows.append(list(item.values()))
            else:
                rows.append([item])
        return rows
    return [[value]]


def _render(result: Any, req: Request) -> tuple[int, bytes, str]:
    """Serialize one handler result to wire bytes, stamping the ledger's
    serialize phase (both the sync path and deferred completion render
    through here, so the stamp site is single).

    The stamp anchors at the ledger's last phase end, not at render
    entry: on the deferred path the slice between the batcher's device
    fetch and this call — result distribution, the post-processing pool
    hop, top-n trim/ID translation — is host-side result handling, and
    charging it to serialize keeps the phase budget tiling the request
    (>=95% of wall-clock, the attribution contract) instead of leaving
    an invisible gap between device and serialize."""
    if req.ledger is None:
        return _render_body(result, req)
    t0 = time.monotonic()
    tail = req.ledger.last_end()
    start = tail if tail is not None and tail < t0 else t0
    out = _render_body(result, req)
    req.ledger.add("serialize", time.monotonic() - start, start=start)
    return out


def _render_body(result: Any, req: Request) -> tuple[int, bytes, str]:
    if isinstance(result, RawResponse):
        return result.status, result.body, result.content_type
    if result is None:
        return 204, b"", "text/plain"
    if isinstance(result, tuple) and len(result) == 2 and isinstance(result[0], int):
        status, payload = result
        if payload is None:
            return status, b"", "text/plain"
    else:
        status, payload = 200, result
    if _wants_json(req):
        return status, json.dumps(payload).encode("utf-8"), "application/json"
    from oryx_tpu_torch.common.text import join_csv

    rows = _to_csv_rows(payload)
    text = "\n".join(join_csv(r) for r in rows)
    return status, (text + ("\n" if text else "")).encode("utf-8"), "text/csv"


def _render_exception(e: BaseException, req: Request) -> tuple[int, bytes, str]:
    """The ONE error-rendering boundary, shared by sync dispatch and
    deferred completion so status/format behavior cannot drift."""
    if isinstance(e, OryxServingException):
        if e.headers:
            req.response_headers.extend(e.headers)
        return _render_error(e.status, e.message, req)
    return _render_error(500, f"{type(e).__name__}: {e}", req)


def _render_error(status: int, message: str, req: Request) -> tuple[int, bytes, str]:
    """Error body rendering (reference ErrorResource: JSON or plain)."""
    if _wants_json(req):
        body = json.dumps({"status": status, "error": message}).encode("utf-8")
        return status, body, "application/json"
    return status, f"{status} {message}\n".encode("utf-8"), "text/plain"
