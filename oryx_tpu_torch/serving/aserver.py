"""Asyncio HTTP frontend for the serving layer (the port's copy of
oryx_tpu/serving/aserver.py).

The reference serving layer runs a 400-thread Tomcat with HTTP/1.1-NIO2 +
HTTP/2 connectors (framework/oryx-lambda-serving .../ServingLayer.java:
58-339). A thread-per-connection stdlib server is the Python analogue of
old blocking Tomcat; this module is the NIO analogue: an event loop owns
its connections (accept/read/write never hold a thread each), and only
the blocking part of a request — ``ServingApp.dispatch``, which may park
on the device micro-batcher — occupies a worker-pool thread. Connection
count therefore scales independently of thread count, and the worker pool
bounds in-flight dispatches the way Tomcat's executor bounds request
threads.

Multi-loop fan-out (``oryx.serving.api.loops``): the frontend runs N
acceptor/event-loop threads, EACH with its own ``SO_REUSEPORT`` listener
socket on the same port — the kernel balances connections across them —
but all sharing ONE ServingApp, ONE model manager, ONE worker pool, and
the ONE process-wide TopKBatcher. Unlike the full-replica mode
(``oryx.serving.api.processes``), which runs whole processes and
duplicates the factor matrices on the card per replica, concurrent
requests from every loop coalesce into the SAME device dispatches:
bigger batches, one model copy. Each loop's state
(connection registry, request counter) is touched only by its own
thread, so the loops share nothing mutable but the app itself.

Selected by ``oryx.serving.api.server = "async"`` (the default;
``"threaded"`` keeps the stdlib ThreadingHTTPServer path). Both frontends
share auth, gzip, and dispatch semantics; tests run the same suite against
each.
"""

from __future__ import annotations

import asyncio
import gzip
import logging
import socket
import ssl
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from urllib.parse import parse_qs, urlsplit

from oryx_tpu_torch.common.perfattr import PhaseLedger, get_perfattr
from oryx_tpu_torch.common.tracing import (
    format_traceparent,
    get_tracer,
    parse_traceparent,
)
from oryx_tpu_torch.serving.app import Deferred, Request, ServingApp
from oryx_tpu_torch.serving.auth import Authenticator

log = logging.getLogger(__name__)

# the tracer is a process singleton mutated in place by configure_tracing;
# binding it once keeps the disabled-tracing cost to one attribute read
# per request instead of a function call per stage
_TRACER = get_tracer()

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 256 * 1024 * 1024
READ_TIMEOUT = 30.0

_COMMON_STATUS = {
    200: b"200 OK",
    204: b"204 No Content",
    400: b"400 Bad Request",
    401: b"401 Unauthorized",
    404: b"404 Not Found",
    405: b"405 Method Not Allowed",
    500: b"500 Internal Server Error",
    503: b"503 Service Unavailable",
}


def _split_target(target: str) -> tuple[str, dict[str, list[str]]]:
    """Request target -> (path, query dict), skipping urlsplit + parse_qs
    allocation on the hot path. The common serving shapes
    (``?howMany=10``, ``?offsetSince=...``) carry no percent-escapes, no
    '+', and no blank values, so a straight split is exact; anything
    escaped/odd falls back to the stdlib parsers, byte-for-byte."""
    if target.startswith("/") and "#" not in target:
        q = target.find("?")
        if q < 0:
            return target, {}
        path, qs = target[:q], target[q + 1 :]
        if not qs:
            return path, {}
        if "%" not in qs and "+" not in qs:
            out: dict[str, list[str]] = {}
            for part in qs.split("&"):
                k, sep, v = part.partition("=")
                # parse_qs drops blank values and bare keys by default
                if sep and v:
                    bucket = out.get(k)
                    if bucket is None:
                        out[k] = [v]
                    else:
                        bucket.append(v)
            return path, out
        return path, parse_qs(qs)
    split = urlsplit(target)
    return split.path, parse_qs(split.query)


class _LoopState:
    """One event loop's private world: its thread, its SO_REUSEPORT
    listener, its live-connection registry, and its request counter.
    Everything here is touched only by the owning loop's thread (the
    counter is read, never written, by /metrics scrapes), so none of it
    needs a lock."""

    def __init__(self, index: int):
        self.index = index
        self.thread: threading.Thread | None = None
        self.loop: asyncio.AbstractEventLoop | None = None
        self.server: asyncio.AbstractServer | None = None
        # live per-connection tasks -> parked-between-requests flag
        self.conns: dict = {}
        # h1 requests + h2 streams served by this loop
        self.requests = 0
        self.started = threading.Event()
        self.error: BaseException | None = None


def _loop_requests_reader(ref):
    from oryx_tpu_torch.common.metrics import GaugeSeriesGone

    def read() -> float:
        ls = ref()
        if ls is None:
            raise GaugeSeriesGone("event loop gone")
        return float(ls.requests)

    return read


class AsyncHTTPServer:
    """Multi-event-loop HTTP/1.1(+h2) server wrapping a ServingApp.

    Runs each asyncio loop on a dedicated thread so it presents the same
    synchronous start()/close() surface as the threaded frontend.
    """

    def __init__(
        self,
        app: ServingApp,
        auth: Authenticator | None,
        port: int,
        ssl_context: ssl.SSLContext | None = None,
        workers: int = 128,
        loops: int = 1,
        reuse_port: bool = False,
    ):
        self.app = app
        self.auth = auth
        self.port = port
        self._ssl = ssl_context
        self.loops = max(1, loops)
        self._reuse_port = reuse_port
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="oryx-serving-worker"
        )
        self._loopstates: list[_LoopState] = []
        self._want_reuse = False
        # (reader fn, loop label) bindings registered on the global
        # metrics registry, so close() can drop exactly them
        self._metric_bindings: list[tuple[object, str]] = []

    # -- introspection (tests + threaded-era callers) ----------------------

    @property
    def _conns(self) -> dict:
        """Merged view of every loop's live-connection registry (read-only:
        each loop owns its own dict)."""
        merged: dict = {}
        for ls in self._loopstates:
            merged.update(ls.conns)
        return merged

    @property
    def _thread(self) -> threading.Thread | None:
        return self._loopstates[0].thread if self._loopstates else None

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        n = self.loops
        if n > 1 and not hasattr(socket, "SO_REUSEPORT"):
            log.warning(
                "oryx.serving.api.loops=%d but this platform has no "
                "SO_REUSEPORT; running a single event loop", n,
            )
            n = 1
        self._want_reuse = self._reuse_port or n > 1

        # loop 0 binds first and resolves an ephemeral port; the remaining
        # loops then join that CONCRETE port with SO_REUSEPORT
        first = _LoopState(0)
        self._loopstates = [first]
        self._start_loop(first)
        first.started.wait(timeout=30)
        if first.error is not None:
            raise first.error
        if first.server is None:
            raise RuntimeError("async serving frontend failed to start")

        rest = [_LoopState(i) for i in range(1, n)]
        self._loopstates.extend(rest)
        for ls in rest:
            self._start_loop(ls)
        for ls in rest:
            ls.started.wait(timeout=30)
            if ls.error is not None or ls.server is None:
                err = ls.error or RuntimeError(
                    f"serving event loop {ls.index} failed to start"
                )
                self.close()  # don't leave the earlier loops listening
                raise err
        self.app.loop_count = len(self._loopstates)  # surfaced by /healthz
        self._register_metrics()

    def _start_loop(self, ls: _LoopState) -> None:
        ls.thread = threading.Thread(
            target=self._run_loop, args=(ls,),
            name=f"oryx-serving-aio-{ls.index}", daemon=True,
        )
        ls.thread.start()

    def _register_metrics(self) -> None:
        """Per-loop request counters on the process-global registry:
        `oryx_http_loop_requests{loop="i"}`. Callback-bound (the loop
        thread owns the int; scrapes read it live) and weakly referenced
        so a closed server's series disappear instead of pinning it."""
        from oryx_tpu_torch.common.metrics import get_registry

        c = get_registry().counter(
            "oryx_http_loop_requests",
            "HTTP requests served, by frontend event loop",
            labeled=True,  # zero series after close() renders no bogus `name 0`
        )
        for ls in self._loopstates:
            reader = _loop_requests_reader(weakref.ref(ls))
            c.set_function(reader, loop=str(ls.index))
            self._metric_bindings.append((reader, str(ls.index)))

    def close(self) -> None:
        # drain all loops CONCURRENTLY: each close is bounded by its own
        # grace window, and serializing N of them would multiply shutdown
        # latency by the loop count
        pending = []
        for ls in self._loopstates:
            if ls.loop is not None and ls.loop.is_running():
                pending.append(
                    (ls, asyncio.run_coroutine_threadsafe(
                        self._shutdown(ls), ls.loop
                    ))
                )
        for ls, fut in pending:
            try:
                fut.result(timeout=10)
            except Exception:  # pragma: no cover - defensive
                pass
            ls.loop.call_soon_threadsafe(ls.loop.stop)
        for ls in self._loopstates:
            if ls.thread is not None:
                ls.thread.join(timeout=10)
        self._pool.shutdown(wait=False)
        if self._metric_bindings:
            # drop OUR per-loop series now rather than waiting for GC: a
            # closed server's stale series would mislabel loop counts (and
            # ghost counter resets) on every later /metrics scrape. The
            # exact-fn unbind leaves a newer server's same-label bindings
            # untouched.
            from oryx_tpu_torch.common.metrics import get_registry

            c = get_registry().counter("oryx_http_loop_requests")
            for reader, label in self._metric_bindings:
                c.unbind_function(reader, loop=label)
            self._metric_bindings = []

    def join(self) -> None:
        """Block until every loop thread exits (serving-layer
        await_termination)."""
        for ls in self._loopstates:
            if ls.thread is not None:
                ls.thread.join()

    async def _shutdown(self, ls: _LoopState) -> None:
        if ls.server is not None:
            ls.server.close()
        # Drain BEFORE wait_closed(): python 3.12's Server.wait_closed
        # waits for all connection handlers, so waiting first silently
        # burned close()'s full timeout and abandoned tasks to die noisily
        # with the loop ("Task was destroyed but it is pending").
        # Idle keep-alive connections (parked in readuntil) cancel
        # immediately; BUSY requests get a short grace to finish writing
        # their response, then cancel too. The sweep loops because a
        # connection accepted just before close() registers only on its
        # task's first step.
        loop = asyncio.get_running_loop()
        grace_until = loop.time() + 5.0
        while True:
            # yield first: a handler task created for a just-accepted
            # connection registers only on its first step — checking
            # before yielding would miss it entirely
            await asyncio.sleep(0)
            if not ls.conns:
                break
            past_grace = loop.time() >= grace_until
            for task, idle in list(ls.conns.items()):
                if past_grace or idle:
                    task.cancel()
            await asyncio.wait(list(ls.conns), timeout=0.25)
        if ls.server is not None:
            await ls.server.wait_closed()

    def _run_loop(self, ls: _LoopState) -> None:
        loop = asyncio.new_event_loop()
        asyncio.set_event_loop(loop)
        ls.loop = loop
        try:
            ls.server = loop.run_until_complete(
                asyncio.start_server(
                    lambda r, w: self._handle_conn(ls, r, w),
                    "0.0.0.0",
                    self.port,
                    ssl=self._ssl,
                    backlog=1024,
                    # one listener per loop (and/or per replica process)
                    # on the same port; the kernel load-balances
                    # connections across them
                    reuse_port=self._want_reuse or None,
                )
            )
            if ls.index == 0:
                self.port = ls.server.sockets[0].getsockname()[1]
        except BaseException as e:  # surface bind errors to start()
            ls.error = e
            ls.started.set()
            loop.close()
            return
        ls.started.set()
        try:
            loop.run_forever()
        finally:
            loop.run_until_complete(loop.shutdown_asyncgens())
            loop.close()

    # -- per-connection protocol ------------------------------------------

    async def _handle_conn(
        self,
        ls: _LoopState,
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
    ) -> None:
        task = asyncio.current_task()
        if task is not None:
            ls.conns[task] = True  # idle until a request head arrives
            task.add_done_callback(lambda t: ls.conns.pop(t, None))
        try:
            while True:
                try:
                    head = await asyncio.wait_for(
                        reader.readuntil(b"\r\n\r\n"), timeout=READ_TIMEOUT
                    )
                except (
                    asyncio.IncompleteReadError,
                    asyncio.TimeoutError,
                    ConnectionError,
                ):
                    return
                except asyncio.LimitOverrunError:
                    await self._simple_response(writer, 400, b"headers too large")
                    return
                if len(head) > MAX_HEADER_BYTES:
                    await self._simple_response(writer, 400, b"headers too large")
                    return
                # head received: the parse stage (and, when tracing is on,
                # the request span) starts here — the phase ledger needs
                # the stamp regardless of tracing
                t_parse = time.monotonic()
                if task is not None:
                    ls.conns[task] = False  # request in flight

                if head == b"PRI * HTTP/2.0\r\n\r\n":
                    # HTTP/2 with prior knowledge (also the path ALPN-
                    # negotiated h2-over-TLS arrives on): consume the
                    # rest of the 24-byte preface and hand over; the h2
                    # connection stays bound to THIS loop's state
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

                lines = head.split(b"\r\n")
                try:
                    method_b, target_b, version_b = lines[0].split(b" ", 2)
                    method = method_b.decode("ascii")
                    target = target_b.decode("ascii")
                except (ValueError, UnicodeDecodeError):
                    await self._simple_response(writer, 400, b"bad request line")
                    return
                headers: dict[str, str] = {}
                for ln in lines[1:]:
                    if not ln:
                        continue
                    i = ln.find(b":")
                    if i <= 0:
                        continue
                    headers[ln[:i].decode("latin-1").lower()] = (
                        ln[i + 1 :].strip().decode("latin-1")
                    )

                if "chunked" in headers.get("transfer-encoding", "").lower():
                    await self._simple_response(
                        writer, 400, b"chunked bodies not supported"
                    )
                    return
                try:
                    length = int(headers.get("content-length") or 0)
                except ValueError:
                    await self._simple_response(writer, 400, b"bad content-length")
                    return
                if length > MAX_BODY_BYTES:
                    await self._simple_response(writer, 400, b"body too large")
                    return
                body = b""
                if length:
                    try:
                        body = await asyncio.wait_for(
                            reader.readexactly(length), timeout=READ_TIMEOUT
                        )
                    except (
                        asyncio.IncompleteReadError,
                        asyncio.TimeoutError,
                        ConnectionError,
                    ):
                        return

                connection_opts = {
                    t.strip().lower()
                    for t in headers.get("connection", "").split(",")
                }
                if (
                    "upgrade" in connection_opts
                    and headers.get("upgrade", "").lower() == "h2c"
                    and "http2-settings" in headers
                ):
                    # h2c upgrade (RFC 7540 §3.2): validate the client's
                    # HTTP2-Settings BEFORE the 101 — a malformed payload
                    # is a malformed REQUEST (§3.2.1) and must get a 400
                    # over h1, not a protocol error after switching
                    from oryx_tpu_torch.serving.http2 import (
                        Http2Connection,
                        decode_h2c_settings,
                    )

                    if decode_h2c_settings(headers["http2-settings"]) is None:
                        writer.write(
                            b"HTTP/1.1 400 Bad Request\r\n"
                            b"Content-Length: 0\r\nConnection: close\r\n\r\n"
                        )
                        await writer.drain()
                        return
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
                    return

                keep_alive = (
                    headers.get("connection", "").lower() != "close"
                    and version_b != b"HTTP/1.0"
                )
                await self._handle_request(
                    writer, method, target, headers, body, parse_start=t_parse
                )
                ls.requests += 1
                if task is not None:
                    ls.conns[task] = True  # parked between requests
                if not keep_alive:
                    return
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def _process(
        self,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        span=None,
        ledger=None,
    ) -> tuple[int, bytes, str, tuple[tuple[str, str], ...]]:
        """Auth + gzip-decode + route dispatch, shared by every loop's
        HTTP/1.1 handler and the HTTP/2 streams (serving/http2.py):
        returns (status, payload, content-type, extra response headers).

        ``span`` is the request span when the h1 path already opened one;
        h2 streams call with span=None and (when tracing is on) get a
        request span owned — opened AND finished — here. ``ledger``
        follows the same ownership rule: the h1 path passes the one it
        created at parse time; h2 streams get one created AND flushed
        here (their frame writes aren't observable per request)."""
        tr = _TRACER
        own_span = False
        if span is None and tr.enabled:
            span = tr.start(
                "http.request",
                parent=parse_traceparent(headers.get("traceparent")),
                method=method, target=target, proto="h2",
            )
            own_span = True
        own_ledger = ledger is None
        if ledger is None:
            ledger = PhaseLedger(trace=span)
        elif span is not None and ledger.trace is None:
            ledger.trace = span
            ledger.trace_id = span.trace_id
        try:
            if self.auth is not None:
                t_auth = time.monotonic()
                verdict = self.auth.check(method, target, headers.get("authorization"))
                ledger.add("auth", time.monotonic() - t_auth, start=t_auth)
                if span is not None:
                    tr.record_interval("http.auth", t_auth, parent=span)
                if verdict is not True:
                    if span is not None:
                        span.attrs["status"] = 401
                    return (
                        401,
                        b'{"status":401,"error":"unauthorized"}',
                        "application/json",
                        (("WWW-Authenticate", verdict),),
                    )

            path, query = _split_target(target)
            if headers.get("content-encoding", "").lower() == "gzip" and body:
                import zlib

                try:
                    body = gzip.decompress(body)
                except (OSError, EOFError, zlib.error):
                    # OSError: bad magic; EOFError: truncated stream;
                    # zlib.error: corrupt deflate — all must 400, not
                    # escape and silently drop the connection
                    if span is not None:
                        span.attrs["status"] = 400
                    return 400, b"bad gzip body", "text/plain", ()
            req = Request(
                method=method,
                path=path,
                params={},
                query=query,
                body=body,
                headers=headers,
                trace=span,
                ledger=ledger,
            )
            loop = asyncio.get_running_loop()
            dspan = (
                tr.start("http.dispatch", parent=span, path=path)
                if span is not None
                else None
            )
            try:
                if self.app.is_fast(path):
                    # every route under this segment is declared nonblocking
                    # (state lookups + submit_nowait only): dispatch inline on
                    # the event loop, skipping two thread hops per request
                    resp = self.app.dispatch_nowait(req)
                else:
                    resp = await loop.run_in_executor(
                        self._pool, self.app.dispatch_nowait, req
                    )
                if isinstance(resp, Deferred):
                    # deferred endpoints (device-batched top-k) complete on the
                    # event loop: the worker thread is already free, so in-flight
                    # requests are bounded by memory, not by pool size
                    resp = await asyncio.wrap_future(resp.future)
                status, payload, ctype = resp
            except Exception:  # pragma: no cover - dispatch renders its own 500s
                log.exception("dispatch failed")
                status, payload, ctype = 500, b"internal error", "text/plain"
            if dspan is not None:
                tr.finish(dspan, status=status)
                span.attrs["status"] = status
            # headers accumulated during dispatch (Retry-After on sheds,
            # Warning on stale-model responses) — read AFTER any Deferred
            # completed, so chained handlers' headers are included too
            hdrs = list(req.response_headers)
            if span is not None:
                # traced responses name their trace: the id to look up in
                # /debug/traces and to match against /metrics exemplars
                hdrs.append((
                    "traceparent",
                    format_traceparent(span.trace_id, span.span_id),
                ))
            return status, payload, ctype, tuple(hdrs)
        finally:
            if own_ledger:
                get_perfattr().observe_request(ledger)
            if own_span:
                tr.finish(span)
                tr.log_if_slow(span, log)

    async def _handle_request(
        self,
        writer: asyncio.StreamWriter,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
        parse_start: float = 0.0,
    ) -> None:
        tr = _TRACER
        span = None
        if tr.enabled:
            # the request span opens at head-received time so header parse
            # + body read are inside it; "http.parse" covers that stage
            start = parse_start or None
            span = tr.start(
                "http.request",
                parent=parse_traceparent(headers.get("traceparent")),
                start=start, method=method, target=target,
            )
            if parse_start:
                tr.record_interval("http.parse", parse_start, parent=span)
        ledger = PhaseLedger(trace=span)
        if parse_start:
            # head received -> request line/headers/body fully parsed
            ledger.add(
                "parse", time.monotonic() - parse_start, start=parse_start
            )
        status, payload, ctype, extra = await self._process(
            method, target, headers, body, span=span, ledger=ledger
        )
        gzip_ok = "gzip" in headers.get("accept-encoding", "").lower()
        t_resp = time.monotonic()
        await self._write_response(
            writer, status, payload, ctype, method, gzip_ok=gzip_ok, extra=extra
        )
        ledger.add("write", time.monotonic() - t_resp, start=t_resp)
        get_perfattr().observe_request(ledger)
        if span is not None:
            tr.record_interval("http.respond", t_resp, parent=span)
            tr.finish(span, status=status)
            tr.log_if_slow(span, log)

    # (status, ctype) -> precomputed header prefix; statuses and content
    # types are a tiny closed set, so this never grows unbounded.
    # _clen_cache extends the same pattern to the length-dependent tail:
    # rendered JSON responses cluster on a few dozen byte lengths, so the
    # common response writes two cached byte strings and the payload.
    _prefix_cache: dict = {}
    _clen_cache: dict = {}

    async def _write_response(
        self,
        writer: asyncio.StreamWriter,
        status: int,
        payload: bytes,
        ctype: str,
        method: str,
        gzip_ok: bool = False,
        extra: tuple[tuple[str, str], ...] = (),
    ) -> None:
        prefix = self._prefix_cache.get((status, ctype))
        if prefix is None:
            status_line = _COMMON_STATUS.get(status) or f"{status} Status".encode()
            prefix = (
                b"HTTP/1.1 " + status_line + b"\r\nContent-Type: "
                + ctype.encode("latin-1") + b"\r\nVary: Accept-Encoding"
            )
            if len(self._prefix_cache) < 512:
                self._prefix_cache[(status, ctype)] = prefix
        parts = [prefix]
        if gzip_ok and len(payload) >= 1024:
            payload = gzip.compress(payload, compresslevel=5)
            parts.append(b"\r\nContent-Encoding: gzip")
        for k, v in extra:
            parts.append(f"\r\n{k}: {v}".encode("latin-1"))
        n = len(payload)
        tail = self._clen_cache.get(n)
        if tail is None:
            tail = f"\r\nContent-Length: {n}\r\n\r\n".encode("ascii")
            if n < 8192 and len(self._clen_cache) < 8192:
                self._clen_cache[n] = tail
        parts.append(tail)
        if method != "HEAD":
            parts.append(payload)
        writer.write(b"".join(parts))
        try:
            await writer.drain()
        except ConnectionError:
            pass

    async def _simple_response(
        self, writer: asyncio.StreamWriter, status: int, msg: bytes
    ) -> None:
        await self._write_response(writer, status, msg, "text/plain", "GET")
