"""Kafka wire-protocol codec: primitive types + record-batch v2 (the port's
copy of oryx_tpu/bus/kafkawire.py; the bytes are the same, so either
package's client reads the other's batches).

Self-contained (zero dependencies) encoding/decoding for the subset of the
Kafka protocol the framework's bus needs, pinned to pre-"flexible-version"
API versions so all types are the classic fixed-width/length-prefixed forms.
Used by the kafka:// Broker backend (oryx_tpu_torch/bus/kafka.py) and by the
in-process protocol test server (tests/torch_kafka_testbroker.py) — the analogue
of the reference booting a real LocalKafkaBroker inside the JVM for its
integration tests (framework/kafka-util src/test .../LocalKafkaBroker.java).

Record batches are magic-v2 (the only format modern brokers accept for
produce): varint/zigzag record fields, CRC32C over attributes..end.
Compression is not emitted; inbound batches are decoded for every
codec real producers use — gzip and snappy (raw or xerial-framed) in
pure python, lz4-frame and zstd through the host's canonical C
libraries (bus/compress.py ctypes bindings).
"""

from __future__ import annotations

import struct
import zlib


class WireDecodeError(ValueError):
    """A record batch that claims to be complete (its length prefix is
    fully present) decodes to garbage — truncated mid-frame, bit-flipped,
    or otherwise internally inconsistent. Distinct from the tolerated
    *trailing partial* batch a broker may legitimately return at the end
    of a fetch: that one is silently re-fetched, this one must fail the
    consume loudly with context, because retrying the same bytes can
    never succeed and guessing at record boundaries would desync every
    later offset in the stream."""


# ---------------------------------------------------------------------------
# CRC32C (Castagnoli) — Kafka record-batch checksum. Table-driven, reflected
# polynomial 0x82F63B78. Check value: crc32c(b"123456789") == 0xE3069283.
# ---------------------------------------------------------------------------

def _make_crc32c_tables() -> list[list[int]]:
    """Slicing-by-8 tables: t[0] is the classic byte table; t[k][b] is the
    CRC of byte b followed by k zero bytes. 8 bytes per loop step keeps a
    16 MB MODEL publish in the tens-of-ms range instead of seconds."""
    t0 = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        t0.append(c)
    tables = [t0]
    for k in range(1, 8):
        prev = tables[k - 1]
        tables.append([t0[prev[n] & 0xFF] ^ (prev[n] >> 8) for n in range(256)])
    return tables


_T = _make_crc32c_tables()

def _crc32c_py(data: bytes, crc: int = 0) -> int:
        t0, t1, t2, t3, t4, t5, t6, t7 = _T
        crc ^= 0xFFFFFFFF
        mv = memoryview(data)
        n = len(mv)
        i = 0
        end8 = n - (n % 8)
        while i < end8:
            b0, b1, b2, b3, b4, b5, b6, b7 = mv[i : i + 8]
            crc ^= b0 | (b1 << 8) | (b2 << 16) | (b3 << 24)
            crc = (
                t7[crc & 0xFF]
                ^ t6[(crc >> 8) & 0xFF]
                ^ t5[(crc >> 16) & 0xFF]
                ^ t4[(crc >> 24) & 0xFF]
                ^ t3[b4]
                ^ t2[b5]
                ^ t1[b6]
                ^ t0[b7]
            )
            i += 8
        while i < n:
            crc = t0[(crc ^ mv[i]) & 0xFF] ^ (crc >> 8)
            i += 1
        return crc ^ 0xFFFFFFFF


def _resolve_crc32c():
    """Fastest available implementation: google_crc32c (C extension) >
    the project's native library (SSE4.2 hardware CRC32, measured 673x
    the Python fallback on a 16MB MODEL publish) > pure python.

    Called lazily on the first crc32c() use, NOT at import: the native
    tier may auto-BUILD liboryxbus.so (a g++ subprocess), and importing
    this module must never block on a compiler."""
    try:
        import google_crc32c as _gcrc  # type: ignore

        def crc32c_ext(data: bytes, crc: int = 0) -> int:
            return _gcrc.extend(crc, bytes(data))

        return crc32c_ext
    except ImportError:
        pass
    try:
        import ctypes

        from oryx_tpu_torch.bus.native import _find_lib

        path = _find_lib()
        if path:
            lib = ctypes.CDLL(path)
            fn = getattr(lib, "oryxbus_crc32c", None)  # stale .so: absent
            if fn is not None:
                fn.restype = ctypes.c_uint32
                fn.argtypes = [
                    ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint32,
                ]
                if fn(b"123456789", 9, 0) == 0xE3069283:  # self-check

                    def crc32c_native(data: bytes, crc: int = 0) -> int:
                        return fn(bytes(data), len(data), crc)

                    return crc32c_native
    except Exception:  # noqa: BLE001 - any native problem -> python path
        pass
    return _crc32c_py


_crc32c_impl = None


def crc32c(data: bytes, crc: int = 0) -> int:
    """Lazy dispatch: the first call resolves and caches the fastest
    implementation (callers commonly hold `from ... import crc32c`
    bindings, so the cache lives in a module var, not by rebinding
    this name)."""
    global _crc32c_impl
    if _crc32c_impl is None:
        _crc32c_impl = _resolve_crc32c()
    return _crc32c_impl(data, crc)


# ---------------------------------------------------------------------------
# primitive writers / readers
# ---------------------------------------------------------------------------

class Writer:
    def __init__(self):
        self._parts: list[bytes] = []

    def raw(self, b: bytes) -> "Writer":
        self._parts.append(b)
        return self

    def i8(self, v: int) -> "Writer":
        return self.raw(struct.pack(">b", v))

    def i16(self, v: int) -> "Writer":
        return self.raw(struct.pack(">h", v))

    def i32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">i", v))

    def i64(self, v: int) -> "Writer":
        return self.raw(struct.pack(">q", v))

    def u32(self, v: int) -> "Writer":
        return self.raw(struct.pack(">I", v))

    def string(self, s: str | None) -> "Writer":
        if s is None:
            return self.i16(-1)
        b = s.encode("utf-8")
        return self.i16(len(b)).raw(b)

    def bytes_(self, b: bytes | None) -> "Writer":
        if b is None:
            return self.i32(-1)
        return self.i32(len(b)).raw(b)

    def array(self, items, write_one) -> "Writer":
        if items is None:
            return self.i32(-1)
        self.i32(len(items))
        for it in items:
            write_one(self, it)
        return self

    def varint(self, v: int) -> "Writer":
        """Zigzag varint (signed)."""
        z = (v << 1) ^ (v >> 63) if v < 0 else v << 1
        while True:
            b = z & 0x7F
            z >>= 7
            if z:
                self.raw(bytes([b | 0x80]))
            else:
                self.raw(bytes([b]))
                return self

    def done(self) -> bytes:
        return b"".join(self._parts)


class Reader:
    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos

    def remaining(self) -> int:
        return len(self.data) - self.pos

    def raw(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) < n:
            raise EOFError(f"need {n} bytes, have {len(b)}")
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self.raw(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.raw(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.raw(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.raw(8))[0]

    def u32(self) -> int:
        return struct.unpack(">I", self.raw(4))[0]

    def string(self) -> str | None:
        n = self.i16()
        if n < 0:
            return None
        return self.raw(n).decode("utf-8")

    def bytes_(self) -> bytes | None:
        n = self.i32()
        if n < 0:
            return None
        return self.raw(n)

    def array(self, read_one) -> list | None:
        n = self.i32()
        if n < 0:
            return None
        return [read_one(self) for _ in range(n)]

    def varint(self) -> int:
        shift = 0
        z = 0
        while True:
            b = self.raw(1)[0]
            z |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                # corrupt data can present an endless continuation-bit
                # run; a real zigzag-64 never needs more than 10 bytes
                raise WireDecodeError("varint exceeds 64 bits")
        return (z >> 1) ^ -(z & 1)  # un-zigzag


# ---------------------------------------------------------------------------
# snappy (RFC-less: google/snappy format description + the xerial stream
# framing the Java Kafka client wraps it in) — pure-python DECODER so
# compressed batches from foreign JVM/librdkafka producers are readable
# without a native dependency. Compression on our own produce path stays
# off (uncompressed batches; the broker accepts either).
# ---------------------------------------------------------------------------

_XERIAL_MAGIC = b"\x82SNAPPY\x00"


def _snappy_block_decompress(data: bytes) -> bytes:
    """One raw snappy block: uvarint uncompressed length, then
    literal/copy tagged elements."""
    ulen = 0
    shift = 0
    pos = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated snappy preamble")
        b = data[pos]
        pos += 1
        ulen |= (b & 0x7F) << shift
        shift += 7
        if not b & 0x80:
            break
    out = bytearray()
    while pos < len(data):
        tag = data[pos]
        pos += 1
        ttype = tag & 3
        if ttype == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                ln = int.from_bytes(data[pos:pos + nb], "little")
                pos += nb
            ln += 1
            out += data[pos:pos + ln]
            pos += ln
            continue
        if ttype == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[pos]
            pos += 1
        elif ttype == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 2], "little")
            pos += 2
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
        if off == 0 or off > len(out):
            raise ValueError("bad snappy copy offset")
        if off >= ln:  # non-overlapping: one slice
            out += out[len(out) - off:len(out) - off + ln]
        else:  # overlapping run: byte-wise (RLE-style copies)
            for _ in range(ln):
                out.append(out[-off])
    if len(out) != ulen:
        raise ValueError(f"snappy length mismatch: {len(out)} != {ulen}")
    return bytes(out)


def snappy_decompress(data: bytes) -> bytes:
    """Raw snappy block, or the xerial-framed stream
    (magic + 2 version ints, then [i32 length][block] chunks) that the
    Java Kafka client's SnappyOutputStream writes."""
    if data[: len(_XERIAL_MAGIC)] == _XERIAL_MAGIC:
        pos = len(_XERIAL_MAGIC) + 8  # version + compat ints
        out = bytearray()
        while pos + 4 <= len(data):
            (n,) = struct.unpack_from(">i", data, pos)
            pos += 4
            out += _snappy_block_decompress(data[pos:pos + n])
            pos += n
        return bytes(out)
    return _snappy_block_decompress(data)


# ---------------------------------------------------------------------------
# record batch v2
# ---------------------------------------------------------------------------

def encode_record_batch(
    records: list[tuple[bytes | None, bytes | None]],
    base_timestamp_ms: int,
) -> bytes:
    """[(key, value), ...] -> one magic-v2 record batch (uncompressed)."""
    body = Writer()
    for i, (key, value) in enumerate(records):
        rec = Writer()
        rec.i8(0)  # record attributes
        rec.varint(0)  # timestamp delta
        rec.varint(i)  # offset delta
        if key is None:
            rec.varint(-1)
        else:
            rec.varint(len(key)).raw(key)
        if value is None:
            rec.varint(-1)
        else:
            rec.varint(len(value)).raw(value)
        rec.varint(0)  # headers count
        rb = rec.done()
        body.varint(len(rb)).raw(rb)
    records_bytes = body.done()

    # fields covered by the CRC: attributes .. records
    crced = (
        Writer()
        .i16(0)  # attributes: no compression, create-time timestamps
        .i32(len(records) - 1)  # lastOffsetDelta
        .i64(base_timestamp_ms)
        .i64(base_timestamp_ms)  # maxTimestamp
        .i64(-1)  # producerId
        .i16(-1)  # producerEpoch
        .i32(-1)  # baseSequence
        .i32(len(records))
        .raw(records_bytes)
        .done()
    )
    crc = crc32c(crced)
    after_length = (
        Writer().i32(-1).i8(2).u32(crc).raw(crced).done()  # leaderEpoch, magic, crc
    )
    return Writer().i64(0).i32(len(after_length)).raw(after_length).done()


def decode_record_batches(
    data: bytes,
) -> list[tuple[int, bytes | None, bytes | None]]:
    """Concatenated record batches -> [(absolute offset, key, value), ...].

    Tolerates a trailing partial batch (brokers may return one at the end
    of a fetch response). Handles magic v2; gzip/snappy (pure python)
    and lz4/zstd (system-library ctypes bindings, bus/compress.py)
    compressed v2 batches are decompressed.
    """
    out: list[tuple[int, bytes | None, bytes | None]] = []
    r = Reader(data)
    while r.remaining() >= 12:
        base_offset = r.i64()
        batch_len = r.i32()
        if batch_len < 0 or r.remaining() < batch_len:
            break  # partial trailing batch (re-fetched from the same offset)
        batch = Reader(r.raw(batch_len))
        try:
            out.extend(_decode_one_batch(batch, base_offset))
        except WireDecodeError:
            raise
        # OSError/zlib.error cover corrupt COMPRESSED payloads
        # (gzip.BadGzipFile is an OSError; mid-stream gzip corruption is
        # zlib.error): no real I/O happens in the decode, so OSError here
        # can only mean bad bytes — and it must not escape as a
        # "transient" error the consume retry would pointlessly replay
        except (
            EOFError, ValueError, struct.error, MemoryError, OSError,
            zlib.error,
        ) as e:
            # the length prefix promised a complete batch but the bytes
            # inside don't parse: a mid-frame cut or corruption. Fail THIS
            # consume with the offset context — never guess at boundaries
            # and keep scanning, which would desync every later offset.
            raise WireDecodeError(
                f"corrupt record batch at base offset {base_offset} "
                f"(len {batch_len}): {type(e).__name__}: {e}"
            ) from e
    return out


def _decode_one_batch(
    batch: Reader, base_offset: int
) -> list[tuple[int, bytes | None, bytes | None]]:
    """Decode one complete-length record batch body (v2)."""
    batch.i32()  # partitionLeaderEpoch
    magic = batch.i8()
    if magic != 2:
        raise ValueError(f"unsupported record batch magic {magic}")
    batch.u32()  # crc (not re-verified on read)
    attributes = batch.i16()
    batch.i32()  # lastOffsetDelta
    batch.i64()  # baseTimestamp
    batch.i64()  # maxTimestamp
    batch.i64()  # producerId
    batch.i16()  # producerEpoch
    batch.i32()  # baseSequence
    n_records = batch.i32()
    payload = batch.raw(batch.remaining())
    codec = attributes & 0x07
    if codec == 1:  # gzip
        import gzip as _gzip

        payload = _gzip.decompress(payload)
    elif codec == 2:  # snappy (raw or xerial-framed)
        payload = snappy_decompress(payload)
    elif codec == 3:  # lz4 frame
        from oryx_tpu_torch.bus.compress import lz4f_decompress

        payload = lz4f_decompress(payload)
    elif codec == 4:  # zstd
        from oryx_tpu_torch.bus.compress import zstd_decompress

        payload = zstd_decompress(payload)
    elif codec != 0:
        raise ValueError(f"unsupported compression codec {codec}")
    out: list[tuple[int, bytes | None, bytes | None]] = []
    pr = Reader(payload)
    for _ in range(n_records):
        length = pr.varint()
        if length < 0 or length > pr.remaining():
            raise ValueError(
                f"record length {length} exceeds remaining payload "
                f"{pr.remaining()}"
            )
        rec = Reader(pr.raw(length))
        rec.i8()  # attributes
        rec.varint()  # timestampDelta
        offset_delta = rec.varint()
        klen = rec.varint()
        key = rec.raw(klen) if klen >= 0 else None
        vlen = rec.varint()
        value = rec.raw(vlen) if vlen >= 0 else None
        n_headers = rec.varint()
        for _ in range(n_headers):
            hklen = rec.varint()
            rec.raw(max(0, hklen))
            hvlen = rec.varint()
            if hvlen > 0:
                rec.raw(hvlen)
        out.append((base_offset + offset_delta, key, value))
    return out


# ---------------------------------------------------------------------------
# api keys / error codes
# ---------------------------------------------------------------------------

API_PRODUCE = 0
API_FETCH = 1
API_LIST_OFFSETS = 2
API_METADATA = 3
API_OFFSET_COMMIT = 8
API_OFFSET_FETCH = 9
API_FIND_COORDINATOR = 10
API_API_VERSIONS = 18
API_CREATE_TOPICS = 19
API_DELETE_TOPICS = 20

ERR_NONE = 0
ERR_UNKNOWN_TOPIC_OR_PARTITION = 3
ERR_NOT_LEADER = 6
ERR_TOPIC_ALREADY_EXISTS = 36

ERROR_NAMES = {
    0: "NONE",
    1: "OFFSET_OUT_OF_RANGE",
    3: "UNKNOWN_TOPIC_OR_PARTITION",
    5: "LEADER_NOT_AVAILABLE",
    6: "NOT_LEADER_FOR_PARTITION",
    7: "REQUEST_TIMED_OUT",
    36: "TOPIC_ALREADY_EXISTS",
}


def encode_request(
    api_key: int, api_version: int, correlation_id: int, client_id: str, body: bytes
) -> bytes:
    """Length-prefixed request with header v1."""
    hdr = (
        Writer()
        .i16(api_key)
        .i16(api_version)
        .i32(correlation_id)
        .string(client_id)
        .raw(body)
        .done()
    )
    return Writer().i32(len(hdr)).raw(hdr).done()
