"""Serving layer runtime: embedded HTTP server + model listener (the port's
copy of oryx_tpu/serving/server.py).

Mirrors the reference ServingLayer + ModelManagerListener (framework/
oryx-lambda-serving .../ServingLayer.java:58-339, ModelManagerListener.java:
59-235): on start it reflectively loads the user's ServingModelManager,
spawns an update-topic listener thread replaying from earliest (so the
in-memory model rebuilds), creates an input-topic producer unless read-only,
and serves the app's routes on a thread-pooled HTTP server with optional
basic auth and gzip request bodies.

The model manager named by config resolves its device itself: the ALS
manager runs on the CUDA card and raises without one. Tests pass a manager
built with ``device="cpu"``.
"""

from __future__ import annotations

import gzip
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlsplit

from oryx_tpu_torch.api import ServingModelManager
from oryx_tpu_torch.bus.api import ConsumeDataIterator, TopicProducer
from oryx_tpu_torch.bus.broker import get_broker
from oryx_tpu_torch.common.classutil import load_instance_of
from oryx_tpu_torch.common import gcstats
from oryx_tpu_torch.common.config import Config
from oryx_tpu_torch.common.perfattr import PhaseLedger, get_perfattr
from oryx_tpu_torch.common.tracing import (
    format_traceparent,
    get_tracer,
    parse_traceparent,
)
from oryx_tpu_torch.serving.app import Request, ServingApp
from oryx_tpu_torch.serving.auth import Authenticator, make_authenticator

log = logging.getLogger(__name__)


class ServingLayer:
    def __init__(self, config: Config, model_manager: ServingModelManager | None = None):
        self.config = config
        self.port = config.get_int("oryx.serving.api.port", 8080)
        self.read_only = config.get_bool("oryx.serving.api.read-only", False)
        self.group = f"OryxGroup-{config.get_string('oryx.id', None) or 'serving'}-serving"
        self.update_uri = config.get_string("oryx.update-topic.broker")
        self.update_topic = config.get_string("oryx.update-topic.message.topic")
        self.input_uri = config.get_string("oryx.input-topic.broker")
        self.input_topic = config.get_string("oryx.input-topic.message.topic")

        if model_manager is not None:
            self.model_manager = model_manager
        else:
            cls_name = config.get_string("oryx.serving.model-manager-class")
            if not cls_name:
                raise ValueError("no oryx.serving.model-manager-class configured")
            self.model_manager = load_instance_of(cls_name, ServingModelManager, config)

        self._update_consumer: ConsumeDataIterator | None = None
        self._listener: threading.Thread | None = None
        self._httpd: ThreadingHTTPServer | None = None
        self._http_thread: threading.Thread | None = None
        self._aio_server = None
        self.app: ServingApp | None = None

    def start(self) -> None:
        # Fail fast on missing topics: the reference serving layer never
        # creates topics (its no-init-topics flag only gates the test-only
        # ModelManagerListener path, ServingLayer.java:283) — a typo'd topic
        # name must error at startup, not silently serve an empty topic.
        # oryx.serving.init-topics = true opts in to auto-creation for
        # single-binary/dev deployments (a deliberate deviation, logged
        # loudly); no-init-topics = true additionally forbids it outright.
        no_init = self.config.get_bool("oryx.serving.no-init-topics", False)
        init_topics = (
            self.config.get_bool("oryx.serving.init-topics", False)
            and not no_init
        )

        def ensure(uri: str, topic: str, which: str) -> None:
            if get_broker(uri).topic_exists(topic):
                return
            if not init_topics:
                hint = (
                    "topic creation is forbidden by oryx.serving."
                    "no-init-topics = true; create it out of band"
                    if no_init
                    else "create it first (oryx_tpu_torch.bus.topic_admin."
                    "maybe_create) or set oryx.serving.init-topics = true "
                    "to let the serving layer create it"
                )
                raise RuntimeError(f"topic does not exist: {topic} ({hint})")
            log.warning(
                "AUTO-CREATING missing %s topic %s on %s "
                "(oryx.serving.init-topics = true; the reference serving "
                "layer would fail fast here)", which, topic, uri,
            )
            partitions = self.config.get_int(
                f"oryx.{which}-topic.message.partitions", 1
            )
            # maybe_create: replicas racing on the same broker must both
            # win; honor the configured message cap (MODEL publishes are
            # sized against it)
            from oryx_tpu_torch.bus.broker import topics

            topics.maybe_create(
                uri, topic, partitions,
                max_message_bytes=self.config.get_int(
                    f"oryx.{which}-topic.message.max-size", 1 << 24
                ),
            )

        ensure(self.update_uri, self.update_topic, "update")
        update_broker = get_broker(self.update_uri)
        try:
            n_parts = update_broker.num_partitions(self.update_topic)
        except Exception:
            n_parts = 1
        if n_parts > 1:
            # model updates assume the publish order of one partition (a
            # MODEL-REF, then its TRACE stamp and UP rows); across
            # partitions a stamp or row can overtake its model
            log.warning(
                "update topic %s has %d partitions; model updates assume "
                "single-partition ordering (the reference's convention)",
                self.update_topic, n_parts,
            )

        input_producer = None
        if not self.read_only:
            ensure(self.input_uri, self.input_topic, "input")
            input_producer = TopicProducer(get_broker(self.input_uri), self.input_topic)

        # The app MUST exist before the model listener replays a single
        # message: its constructor configures the config-level planes the
        # listener's dispatch path consults (the retry policy and fault
        # plan, tracing, the freshness metrics).
        self.app = ServingApp(self.config, self.model_manager, input_producer)

        # model listener: replay update topic from earliest forever
        # (ModelManagerListener.java:118-149)
        self._update_consumer = ConsumeDataIterator(
            update_broker, self.update_topic, group=f"{self.group}-updates", start="earliest"
        )

        def listen():
            try:
                self.model_manager.consume(self._update_consumer)
            except Exception:
                log.exception("serving model listener died")

        self._listener = threading.Thread(
            target=listen, name="oryx-serving-model-listener", daemon=True
        )
        self._listener.start()
        # /healthz reports this consumer's update-topic backlog so a
        # fleet front can see a replica falling behind model distribution.
        # Sampled on a dedicated thread, never on the probe: lag() does
        # synchronous broker I/O (Kafka ListOffsets round trips, filelog
        # stats), and /healthz dispatches inline on the serving event
        # loop — a slow bus must degrade the lag NUMBER, not stall every
        # in-flight /recommend behind a blocked probe (which would then
        # get the replica ejected by the very front asking after it).
        self._lag_sample: int | None = None
        self._lag_stop = threading.Event()

        # .lag() is broker I/O (a blocking call that must stay off the
        # probe path), legal here only because this closure runs on the
        # dedicated sampler thread below
        def sample_lag() -> None:
            while not self._lag_stop.is_set():
                try:
                    self._lag_sample = self._update_consumer.lag()
                except Exception:  # noqa: BLE001 - lag is best-effort
                    self._lag_sample = None
                self._lag_stop.wait(2.0)

        self._lag_thread = threading.Thread(
            target=sample_lag, name="oryx-serving-update-lag", daemon=True
        )
        self._lag_thread.start()
        self.app.update_lag_fn = lambda: self._lag_sample
        # saturation shedding knobs for the process-wide top-k batcher
        # (oryx.serving.api.shed.*): past max-queue, submits 503 with
        # Retry-After instead of queueing without bound
        from oryx_tpu_torch.serving.batcher import TopKBatcher

        TopKBatcher.shared().configure(self.config)
        # the interpreter's collections: counted by generation, and spans
        # (runtime.gc) while tracing is on
        gcstats.install()
        auth = make_authenticator(self.config)
        frontend = self.config.get_string("oryx.serving.api.server", "async")
        cert = self.config.get_string("oryx.serving.api.ssl-cert-file", None)
        key = self.config.get_string("oryx.serving.api.ssl-key-file", None)
        ctx = None
        if cert:
            # TLS termination in-process (the reference's Tomcat keystore
            # connector, ServingLayer.java:58-339 — PEM instead of JKS);
            # like the reference, TLS binds on secure-port when one is
            # configured
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(cert, key or None)
            if frontend == "async":
                try:
                    # advertise h2 via ALPN (the reference's Tomcat
                    # connector does the same, ServingLayer.java:229); a
                    # client that negotiates h2 sends the connection
                    # preface, which the async frontend detects. The
                    # threaded frontend can't speak h2, so advertising it
                    # there would break every h2-capable TLS client.
                    ctx.set_alpn_protocols(["h2", "http/1.1"])
                except NotImplementedError:  # pragma: no cover - old ssl
                    pass
            # bind the secure connector on secure-port only when one is
            # EXPLICITLY configured (default null): a packaged default
            # would silently clobber `port` for every TLS deployment.
            # DIVERGENCE from the reference (ServingLayer.java:215), which
            # binds secure-port (default 443) whenever a keystore is
            # configured — see docs/parity.md; warn so reference configs
            # relying on that default notice the changed bind port.
            secure = self.config.get("oryx.serving.api.secure-port", None)
            if secure:
                self.port = int(secure)
            else:
                log.warning(
                    "TLS enabled without oryx.serving.api.secure-port: "
                    "binding the secure connector on port %d (the reference "
                    "would bind secure-port's default 443 here)", self.port,
                )

        if frontend == "async":
            from oryx_tpu_torch.serving.aserver import AsyncHTTPServer

            # event-loop fan-out: 0 = auto (one loop per CPU core). All
            # loops share THIS app/model/batcher — the in-process
            # alternative to `processes`, which duplicates model state
            # (and the card's view of it) per replica.
            loops = self.config.get_int("oryx.serving.api.loops", 0)
            if loops <= 0:
                import os

                loops = os.cpu_count() or 1
            self._aio_server = AsyncHTTPServer(
                self.app,
                auth,
                self.port,
                ssl_context=ctx,
                workers=self.config.get_int("oryx.serving.api.workers", 128),
                loops=loops,
                reuse_port=self.config.get_int("oryx.serving.api.processes", 1) > 1,
            )
            self._aio_server.start()
            self.port = self._aio_server.port
        else:
            handler = _make_handler(self.app, auth)
            if self.config.get_int("oryx.serving.api.processes", 1) > 1:
                # replica mode shares the port across processes
                import socket

                class _ReusePortServer(ThreadingHTTPServer):
                    def server_bind(self):
                        self.socket.setsockopt(
                            socket.SOL_SOCKET, socket.SO_REUSEPORT, 1
                        )
                        super().server_bind()

                self._httpd = _ReusePortServer(("0.0.0.0", self.port), handler)
            else:
                self._httpd = ThreadingHTTPServer(("0.0.0.0", self.port), handler)
            if ctx is not None:
                # defer the handshake to the per-connection handler thread —
                # with the default handshake-on-accept, one client that opens
                # a socket and never speaks TLS would block the accept loop
                self._httpd.socket = ctx.wrap_socket(
                    self._httpd.socket, server_side=True, do_handshake_on_connect=False
                )
            self.port = self._httpd.server_address[1]
            self._http_thread = threading.Thread(
                target=self._httpd.serve_forever, name="oryx-serving-http", daemon=True
            )
            self._http_thread.start()
        # the bound port is now concrete (ephemeral binds resolved):
        # /healthz and degraded reasons can name it
        self.app.listen_port = self.port
        if self._aio_server is not None:
            log.info(
                "serving layer listening on :%d (async, %d event loops)",
                self.port, len(self._aio_server._loopstates),
            )
        else:
            log.info("serving layer listening on :%d (%s)", self.port, frontend)

    def await_termination(self) -> None:
        if self._aio_server:
            self._aio_server.join()
        if self._http_thread:
            self._http_thread.join()

    def close(self) -> None:
        if getattr(self, "_lag_stop", None) is not None:
            self._lag_stop.set()
        if self._aio_server:
            self._aio_server.close()
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._update_consumer:
            self._update_consumer.close()
        self.model_manager.close()
        if self._listener:
            self._listener.join(timeout=10)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.close()


def _make_handler(app: ServingApp, auth: Authenticator | None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        timeout = 30  # bounds slow/stalled clients (incl. deferred TLS handshakes)

        def log_message(self, fmt, *args):  # route to logging, not stderr
            log.debug("http: " + fmt, *args)

        def _handle(self, method: str) -> None:
            # phase ledger from the first byte we act on: parse covers the
            # body drain + URL split + gzip decode (the auth exchange is
            # stamped separately below)
            ledger = PhaseLedger()
            t_parse0 = time.monotonic()
            parse_s = 0.0
            # drain the body FIRST, even for requests that will 401 —
            # leaving unread bytes on a keep-alive socket desyncs the next
            # request on the connection (digest clients always see a 401
            # on their first exchange, so this path is routine, not rare)
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else b""
            parse_s += time.monotonic() - t_parse0
            if auth is not None:
                # DIGEST by default (reference InMemoryRealm parity); the
                # check returns a fresh challenge on any failure/staleness
                t_auth = time.monotonic()
                verdict = auth.check(
                    method, self.path, self.headers.get("Authorization")
                )
                ledger.add("auth", time.monotonic() - t_auth, start=t_auth)
                if verdict is not True:
                    payload = b'{"status":401,"error":"unauthorized"}'
                    self.send_response(401)
                    self.send_header("WWW-Authenticate", verdict)
                    self.send_header("Content-Length", str(len(payload)))
                    self.send_header("Content-Type", "application/json")
                    self.end_headers()
                    self.wfile.write(payload)
                    return
            t_parse1 = time.monotonic()
            split = urlsplit(self.path)
            if self.headers.get("Content-Encoding", "").lower() == "gzip" and body:
                import zlib

                try:
                    body = gzip.decompress(body)
                except (OSError, EOFError, zlib.error):
                    # truncated/corrupt gzip must 400, not kill the
                    # handler mid-connection (same contract as aserver)
                    payload = b"bad gzip body"
                    self.send_response(400)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    if method != "HEAD":
                        self.wfile.write(payload)
                    return
            req = Request(
                method=method,
                path=split.path,
                params={},
                query=parse_qs(split.query),
                body=body,
                headers={k.lower(): v for k, v in self.headers.items()},
            )
            parse_s += time.monotonic() - t_parse1
            ledger.add("parse", parse_s, start=t_parse0)
            req.ledger = ledger
            tr = get_tracer()
            span = None
            if tr.enabled:
                span = tr.start(
                    "http.request",
                    parent=parse_traceparent(req.headers.get("traceparent")),
                    method=method, target=self.path, frontend="threaded",
                )
                req.trace = span
                ledger.trace = span
                ledger.trace_id = span.trace_id
            status, payload, ctype = app.dispatch(req)
            if span is not None:
                tr.finish(span, status=status)
                tr.log_if_slow(span, log)
            t_write = time.monotonic()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            if span is not None:
                # traced responses name their trace: the id to look up in
                # /debug/traces and to match against /metrics exemplars
                self.send_header(
                    "traceparent",
                    format_traceparent(span.trace_id, span.span_id),
                )
            # headers accumulated during dispatch (Retry-After on sheds,
            # Warning on stale-model responses)
            for k, v in req.response_headers:
                self.send_header(k, v)
            # compress sizable responses for clients that accept it (the
            # reference gzips csv/json via its Tomcat connector)
            accept_enc = self.headers.get("Accept-Encoding", "")
            self.send_header("Vary", "Accept-Encoding")
            if "gzip" in accept_enc.lower() and len(payload) >= 1024:
                payload = gzip.compress(payload, compresslevel=5)
                self.send_header("Content-Encoding", "gzip")
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            if method != "HEAD":
                self.wfile.write(payload)
            # write covers headers + (gzip'd) payload hitting the socket;
            # the flush after it is the ledger's single exit point
            ledger.add("write", time.monotonic() - t_write, start=t_write)
            get_perfattr().observe_request(ledger)

        def do_GET(self):
            self._handle("GET")

        def do_HEAD(self):
            self._handle("HEAD")

        def do_POST(self):
            self._handle("POST")

        def do_DELETE(self):
            self._handle("DELETE")

    return Handler
