"""HTTP/2 (RFC 7540) for the asyncio serving frontend, from scratch.

Reference parity: the reference's Tomcat connector upgrades to h2
(framework/oryx-lambda-serving/.../ServingLayer.java:229
``addUpgradeProtocol(new Http2Protocol())``); this module is the asyncio
analogue. Three entry paths, matching Tomcat's:

- **prior knowledge** (``curl --http2-prior-knowledge``): the cleartext
  connection opens with the 24-byte client preface; aserver detects it
  and hands the socket here.
- **h2c upgrade**: an HTTP/1.1 request carrying ``Upgrade: h2c`` +
  ``HTTP2-Settings`` gets ``101 Switching Protocols`` and its response
  on stream 1.
- **ALPN over TLS**: server.py advertises ``("h2", "http/1.1")``; a
  client that negotiates h2 then sends the same preface, so the
  detection path is shared.

Streams multiplex onto the SAME deferred-dispatch path as HTTP/1.1
(AsyncHTTPServer._process): each stream's dispatch runs as its own task,
so one slow device-batched request never blocks other streams on the
connection. Flow control (connection + per-stream send windows,
WINDOW_UPDATE replenishment for request bodies), SETTINGS negotiation,
PING, RST_STREAM cancellation and GOAWAY are implemented; PRIORITY is
parsed and ignored (as most servers do); server push is never used.
"""

from __future__ import annotations

import asyncio
import gzip
import logging
import struct

from oryx_tpu_torch.serving.aserver import MAX_BODY_BYTES
from oryx_tpu_torch.serving.hpack import Decoder as HpackDecoder
from oryx_tpu_torch.serving.hpack import HpackError, encode as hpack_encode

log = logging.getLogger(__name__)

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# frame types (RFC 7540 §6)
DATA = 0x0
HEADERS = 0x1
PRIORITY = 0x2
RST_STREAM = 0x3
SETTINGS = 0x4
PUSH_PROMISE = 0x5
PING = 0x6
GOAWAY = 0x7
WINDOW_UPDATE = 0x8
CONTINUATION = 0x9

# flags
FLAG_END_STREAM = 0x1
FLAG_ACK = 0x1
FLAG_END_HEADERS = 0x4
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

# error codes (§7)
NO_ERROR = 0x0
PROTOCOL_ERROR = 0x1
FLOW_CONTROL_ERROR = 0x3
FRAME_SIZE_ERROR = 0x6
REFUSED_STREAM = 0x7
CANCEL = 0x8
COMPRESSION_ERROR = 0x9

# settings ids (§6.5.2)
S_HEADER_TABLE_SIZE = 0x1
S_ENABLE_PUSH = 0x2
S_MAX_CONCURRENT_STREAMS = 0x3
S_INITIAL_WINDOW_SIZE = 0x4
S_MAX_FRAME_SIZE = 0x5
S_MAX_HEADER_LIST_SIZE = 0x6

MAX_FRAME_SIZE = 16384  # we never raise it; peers must not send larger
DEFAULT_WINDOW = 65535
MAX_HEADER_BLOCK = 64 * 1024
MAX_STREAMS = 256
# read deadlines: ACTIVE_READ_TIMEOUT between frames while streams are
# open (covers slow uploads), IDLE_READ_TIMEOUT otherwise and for the
# CONTINUATION frames of an unfinished header block
ACTIVE_READ_TIMEOUT = 300.0
IDLE_READ_TIMEOUT = 75.0


def decode_h2c_settings(value: str) -> bytes | None:
    """base64url HTTP2-Settings payload -> raw SETTINGS bytes, or None
    when malformed (bad base64url, or a length that is not a multiple of
    6). RFC 7540 §3.2.1: a malformed HTTP2-Settings header means a
    malformed REQUEST — the h1 server must reject it (400) BEFORE sending
    101 Switching Protocols, so this helper runs in the upgrade gate.

    Strict on the alphabet: urlsafe_b64decode silently DISCARDS invalid
    characters, so garbage whose surviving length happened to be a
    multiple of 6 decoded to nonsense and was accepted. validate=True
    rejects characters outside the translated alphabet, and the explicit
    pre-check also rejects standard-alphabet '+'/'/' input (valid base64,
    but NOT the base64url encoding §3.2.1 requires)."""
    import base64
    import binascii
    import re

    if re.fullmatch(r"[A-Za-z0-9_-]*={0,2}", value) is None:
        return None
    unpadded = value.rstrip("=")
    try:
        raw = base64.b64decode(
            unpadded + "=" * (-len(unpadded) % 4),
            altchars=b"-_",
            validate=True,
        )
    except (ValueError, binascii.Error):
        return None
    return raw if len(raw) % 6 == 0 else None


class ConnectionError2(Exception):
    def __init__(self, code: int, msg: str = ""):
        super().__init__(msg)
        self.code = code


class _Stream:
    __slots__ = (
        "sid", "headers", "body", "remote_closed", "send_window", "task",
    )

    def __init__(self, sid: int, send_window: int):
        self.sid = sid
        self.headers: list[tuple[bytes, bytes]] = []
        self.body = bytearray()
        self.remote_closed = False
        self.send_window = send_window
        self.task: asyncio.Task | None = None


class Http2Connection:
    """One h2 connection: owns the frame loop, the connection-scoped
    HPACK decoder, flow-control windows, and the per-stream dispatch
    tasks."""

    def __init__(
        self,
        server,  # AsyncHTTPServer (duck-typed: _process)
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        upgraded_request: tuple[str, str, dict, bytes] | None = None,
        owner=None,  # the _LoopState owning this connection's event loop
    ):
        self.server = server
        # every stream task this connection spawns runs on the owning
        # loop; its conns registry and request counter are that loop's —
        # never another loop's — so loop-affine state stays loop-affine
        self.owner = owner
        self.reader = reader
        self.writer = writer
        self.upgraded_request = upgraded_request
        self.decoder = HpackDecoder()
        self.streams: dict[int, _Stream] = {}
        self.conn_send_window = DEFAULT_WINDOW
        self.peer_initial_window = DEFAULT_WINDOW
        self.peer_max_frame = MAX_FRAME_SIZE
        self.last_stream_id = 0
        self.goaway_sent = False
        self.peer_goaway = False
        self._write_lock = asyncio.Lock()
        self._window_cv = asyncio.Condition()

    # -- frame primitives --------------------------------------------------

    async def _send_frame(
        self, ftype: int, flags: int, sid: int, payload: bytes = b""
    ) -> None:
        async with self._write_lock:
            self.writer.write(
                struct.pack(">I", len(payload))[1:]
                + bytes([ftype, flags])
                + struct.pack(">I", sid & 0x7FFFFFFF)
                + payload
            )
            try:
                await self.writer.drain()
            except ConnectionError:
                pass

    async def _read_frame(self) -> tuple[int, int, int, bytes]:
        head = await self.reader.readexactly(9)
        length = int.from_bytes(head[:3], "big")
        ftype, flags = head[3], head[4]
        sid = int.from_bytes(head[5:9], "big") & 0x7FFFFFFF
        if length > MAX_FRAME_SIZE:
            raise ConnectionError2(FRAME_SIZE_ERROR, "frame too large")
        payload = await self.reader.readexactly(length) if length else b""
        return ftype, flags, sid, payload

    # -- lifecycle ---------------------------------------------------------

    async def run(self, preface_read: bool = False) -> None:
        """Serve the connection until the peer goes away. preface_read:
        the caller already consumed the 24-byte client preface."""
        try:
            if not preface_read:
                got = await asyncio.wait_for(
                    self.reader.readexactly(len(PREFACE)), timeout=30
                )
                if got != PREFACE:
                    return
            await self._send_frame(
                SETTINGS,
                0,
                0,
                struct.pack(">HI", S_MAX_CONCURRENT_STREAMS, MAX_STREAMS)
                + struct.pack(">HI", S_MAX_HEADER_LIST_SIZE, MAX_HEADER_BLOCK),
            )
            if self.upgraded_request is not None:
                # h2c upgrade: the original HTTP/1.1 request becomes
                # stream 1, half-closed (remote) — respond once the h2
                # layer is up (RFC 7540 §3.2). The HTTP2-Settings header
                # is the client's initial SETTINGS (§3.2.1): apply it
                # BEFORE opening stream 1 so e.g. a smaller
                # INITIAL_WINDOW_SIZE governs the stream-1 response
                # (strict clients treat an overrun as FLOW_CONTROL_ERROR)
                h2s = self.upgraded_request[2].get("http2-settings", "")
                if h2s:
                    raw = decode_h2c_settings(h2s)
                    if raw is None:
                        # defense in depth: aserver validates before the
                        # 101, but a malformed payload reaching here is a
                        # malformed REQUEST (RFC 7540 §3.2.1) —
                        # PROTOCOL_ERROR, not the FRAME_SIZE_ERROR that
                        # _on_settings would raise for a non-multiple-of-6
                        raise ConnectionError2(
                            PROTOCOL_ERROR, "bad HTTP2-Settings header"
                        )
                    await self._on_settings(0, raw, ack=False)
                st = _Stream(1, self.peer_initial_window)
                st.remote_closed = True
                self.streams[1] = st
                self.last_stream_id = 1
                method, target, headers, body = self.upgraded_request
                st.task = asyncio.ensure_future(
                    self._dispatch(st, method, target, headers, body)
                )
            await self._frame_loop()
        except (
            asyncio.IncompleteReadError,
            asyncio.TimeoutError,
            ConnectionError,
        ):
            pass
        except ConnectionError2 as e:
            await self._goaway(e.code)
        except HpackError:
            await self._goaway(COMPRESSION_ERROR)
        except Exception:  # pragma: no cover - defensive
            log.exception("h2 connection failed")
            await self._goaway(PROTOCOL_ERROR)
        finally:
            for st in list(self.streams.values()):
                if st.task is not None and not st.task.done():
                    st.task.cancel()

    async def _goaway(self, code: int) -> None:
        if self.goaway_sent:
            return
        self.goaway_sent = True
        try:
            await self._send_frame(
                GOAWAY, 0, 0,
                struct.pack(">II", self.last_stream_id, code),
            )
        except Exception:  # pragma: no cover
            pass

    def _mark_busy(self, busy: bool) -> None:
        # graceful-shutdown bookkeeping shared with the H1 path: idle
        # connections cancel immediately on drain, busy ones get grace.
        # The registry is the OWNING loop's — a multi-loop frontend drains
        # each loop's connections from that loop's own shutdown sweep.
        if self.owner is None:
            return
        task = asyncio.current_task()
        conns = self.owner.conns
        if task in conns:
            conns[task] = not busy

    # -- receive path ------------------------------------------------------

    async def _frame_loop(self) -> None:
        while True:
            self._mark_busy(bool(self.streams))
            ftype, flags, sid, payload = await asyncio.wait_for(
                self._read_frame(),
                timeout=(
                    ACTIVE_READ_TIMEOUT if self.streams else IDLE_READ_TIMEOUT
                ),
            )
            self._mark_busy(True)
            if ftype == HEADERS:
                await self._on_headers(flags, sid, payload)
            elif ftype == DATA:
                await self._on_data(flags, sid, payload)
            elif ftype == SETTINGS:
                await self._on_settings(flags, payload)
            elif ftype == PING:
                if not flags & FLAG_ACK:
                    await self._send_frame(PING, FLAG_ACK, 0, payload)
            elif ftype == WINDOW_UPDATE:
                await self._on_window_update(sid, payload)
            elif ftype == RST_STREAM:
                st = self.streams.pop(sid, None)
                if st is not None and st.task is not None:
                    st.task.cancel()
            elif ftype == GOAWAY:
                # a client GOAWAY forbids NEW streams; everything it
                # already opened — including streams mid-upload (task not
                # yet started) — must still complete (RFC 7540 §6.8)
                self.peer_goaway = True
                if not self.streams:
                    return
            elif ftype == PUSH_PROMISE:
                raise ConnectionError2(
                    PROTOCOL_ERROR, "client sent PUSH_PROMISE"
                )
            elif ftype in (PRIORITY, CONTINUATION):
                # PRIORITY: ignored. Bare CONTINUATION (outside the
                # HEADERS read in _on_headers) is a protocol error.
                if ftype == CONTINUATION:
                    raise ConnectionError2(
                        PROTOCOL_ERROR, "unexpected CONTINUATION"
                    )
            # unknown frame types are ignored (RFC 7540 §4.1)

    async def _on_settings(
        self, flags: int, payload: bytes, ack: bool = True
    ) -> None:
        """Apply a client SETTINGS payload. ack=False for the h2c
        HTTP2-Settings upgrade header (RFC 7540 §3.2.1: treated as the
        client's initial SETTINGS but never ACKed as a frame)."""
        if flags & FLAG_ACK:
            return
        if len(payload) % 6:
            raise ConnectionError2(FRAME_SIZE_ERROR, "bad SETTINGS length")
        for off in range(0, len(payload), 6):
            ident, value = struct.unpack_from(">HI", payload, off)
            if ident == S_INITIAL_WINDOW_SIZE:
                if value > 0x7FFFFFFF:
                    raise ConnectionError2(FLOW_CONTROL_ERROR, "window > 2^31-1")
                delta = value - self.peer_initial_window
                self.peer_initial_window = value
                async with self._window_cv:
                    for st in self.streams.values():
                        st.send_window += delta
                    self._window_cv.notify_all()
            elif ident == S_MAX_FRAME_SIZE:
                if not 16384 <= value <= 16777215:
                    raise ConnectionError2(PROTOCOL_ERROR, "bad MAX_FRAME_SIZE")
                self.peer_max_frame = min(value, MAX_FRAME_SIZE)
            elif ident == S_HEADER_TABLE_SIZE:
                # our stateless encoder never indexes, so any size is fine
                pass
        if ack:
            await self._send_frame(SETTINGS, FLAG_ACK, 0)

    async def _on_window_update(self, sid: int, payload: bytes) -> None:
        if len(payload) != 4:
            raise ConnectionError2(FRAME_SIZE_ERROR, "bad WINDOW_UPDATE")
        inc = int.from_bytes(payload, "big") & 0x7FFFFFFF
        if inc == 0:
            raise ConnectionError2(PROTOCOL_ERROR, "zero WINDOW_UPDATE")
        async with self._window_cv:
            if sid == 0:
                self.conn_send_window += inc
            else:
                st = self.streams.get(sid)
                if st is not None:
                    st.send_window += inc
            self._window_cv.notify_all()

    async def _on_headers(self, flags: int, sid: int, payload: bytes) -> None:
        if sid == 0 or sid % 2 == 0 or sid <= self.last_stream_id:
            raise ConnectionError2(PROTOCOL_ERROR, "bad HEADERS stream id")
        if flags & FLAG_PADDED:
            pad = payload[0]
            payload = payload[1:]
            if pad > len(payload):
                raise ConnectionError2(PROTOCOL_ERROR, "bad padding")
            payload = payload[: len(payload) - pad]
        if flags & FLAG_PRIORITY:
            payload = payload[5:]  # exclusive/dep (4) + weight (1), ignored
        fragment = bytearray(payload)
        end_headers = flags & FLAG_END_HEADERS
        while not end_headers:
            # bounded like the frame loop's reads: a client that sends
            # HEADERS without END_HEADERS then stalls must not pin the
            # connection (and its graceful-shutdown busy slot) forever
            ftype, cflags, csid, cpayload = await asyncio.wait_for(
                self._read_frame(), timeout=IDLE_READ_TIMEOUT
            )
            if ftype != CONTINUATION or csid != sid:
                raise ConnectionError2(
                    PROTOCOL_ERROR, "HEADERS not followed by CONTINUATION"
                )
            fragment += cpayload
            if len(fragment) > MAX_HEADER_BLOCK:
                raise ConnectionError2(PROTOCOL_ERROR, "header block too large")
            end_headers = cflags & FLAG_END_HEADERS
        self.last_stream_id = sid
        # the decoder is connection-scoped and MUST see every block in
        # wire order — including blocks for streams we refuse (RFC 7541
        # §2.2: skipping one desynchronizes the dynamic table and
        # corrupts every later block on the connection)
        decoded = self.decoder.decode(bytes(fragment))
        if len(self.streams) >= MAX_STREAMS or self.peer_goaway:
            await self._send_frame(
                RST_STREAM, 0, sid, struct.pack(">I", REFUSED_STREAM)
            )
            return
        st = _Stream(sid, self.peer_initial_window)
        st.headers = decoded
        self.streams[sid] = st
        if flags & FLAG_END_STREAM:
            st.remote_closed = True
            self._start_dispatch(st)

    async def _on_data(self, flags: int, sid: int, payload: bytes) -> None:
        st = self.streams.get(sid)
        if st is None or st.remote_closed:
            # stream already reset/closed: still account the connection
            # window so the peer doesn't stall
            if payload:
                await self._send_frame(
                    WINDOW_UPDATE, 0, 0,
                    struct.pack(">I", len(payload)),
                )
            return
        raw_len = len(payload)
        if flags & FLAG_PADDED:
            pad = payload[0]
            payload = payload[1:]
            if pad > len(payload):
                raise ConnectionError2(PROTOCOL_ERROR, "bad padding")
            payload = payload[: len(payload) - pad]
        st.body += payload
        if len(st.body) > MAX_BODY_BYTES:
            self.streams.pop(sid, None)
            await self._send_frame(
                RST_STREAM, 0, sid, struct.pack(">I", REFUSED_STREAM)
            )
            return
        if raw_len:
            # replenish both windows immediately: bodies are consumed into
            # memory, so there is no backpressure to express
            await self._send_frame(
                WINDOW_UPDATE, 0, 0, struct.pack(">I", raw_len)
            )
            if not flags & FLAG_END_STREAM:
                await self._send_frame(
                    WINDOW_UPDATE, 0, sid, struct.pack(">I", raw_len)
                )
        if flags & FLAG_END_STREAM:
            st.remote_closed = True
            self._start_dispatch(st)

    # -- dispatch + response ----------------------------------------------

    def _start_dispatch(self, st: _Stream) -> None:
        pseudo = {}
        headers: dict[str, str] = {}
        cookies: list[str] = []
        for name_b, value_b in st.headers:
            name = name_b.decode("latin-1")
            value = value_b.decode("latin-1")
            if name.startswith(":"):
                pseudo[name] = value
            elif name == "cookie":
                cookies.append(value)
            else:
                headers[name] = value
        if cookies:
            headers["cookie"] = "; ".join(cookies)
        if "host" not in headers and ":authority" in pseudo:
            headers["host"] = pseudo[":authority"]
        method = pseudo.get(":method", "GET")
        target = pseudo.get(":path", "/")
        st.task = asyncio.ensure_future(
            self._dispatch(st, method, target, headers, bytes(st.body))
        )

    async def _dispatch(
        self,
        st: _Stream,
        method: str,
        target: str,
        headers: dict[str, str],
        body: bytes,
    ) -> None:
        try:
            status, payload, ctype, extra = await self.server._process(
                method, target, headers, body
            )
            gzip_ok = "gzip" in headers.get("accept-encoding", "").lower()
            await self._respond(
                st, status, payload, ctype, method, gzip_ok, extra
            )
            if self.owner is not None:
                self.owner.requests += 1  # h2 streams count as requests
        except asyncio.CancelledError:
            raise
        except Exception:  # pragma: no cover - defensive
            log.exception("h2 stream dispatch failed")
            try:
                await self._send_frame(
                    RST_STREAM, 0, st.sid, struct.pack(">I", CANCEL)
                )
            except Exception:
                pass
        finally:
            self.streams.pop(st.sid, None)

    async def _respond(
        self,
        st: _Stream,
        status: int,
        payload: bytes,
        ctype: str,
        method: str,
        gzip_ok: bool,
        extra: tuple[tuple[str, str], ...] = (),
    ) -> None:
        hdrs: list[tuple[bytes, bytes]] = [
            (b":status", str(status).encode()),
            (b"content-type", ctype.encode("latin-1")),
            (b"vary", b"accept-encoding"),
        ]
        if gzip_ok and len(payload) >= 1024:
            payload = gzip.compress(payload, compresslevel=5)
            hdrs.append((b"content-encoding", b"gzip"))
        hdrs.append((b"content-length", str(len(payload)).encode()))
        for k, v in extra:
            hdrs.append((k.lower().encode("latin-1"), v.encode("latin-1")))
        block = hpack_encode(hdrs)
        if method == "HEAD" or not payload:
            await self._send_frame(
                HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM, st.sid, block
            )
            return
        await self._send_frame(HEADERS, FLAG_END_HEADERS, st.sid, block)
        view = memoryview(payload)
        sent = 0
        while sent < len(payload):
            # flow control: both windows must be positive to send
            async with self._window_cv:
                await self._window_cv.wait_for(
                    lambda: (
                        min(self.conn_send_window, st.send_window) > 0
                        or st.sid not in self.streams
                    )
                )
                if st.sid not in self.streams:
                    return  # reset while waiting
                quota = min(
                    self.conn_send_window,
                    st.send_window,
                    self.peer_max_frame,
                    len(payload) - sent,
                )
                self.conn_send_window -= quota
                st.send_window -= quota
            chunk = view[sent:sent + quota]
            sent += quota
            await self._send_frame(
                DATA,
                FLAG_END_STREAM if sent == len(payload) else 0,
                st.sid,
                bytes(chunk),
            )
