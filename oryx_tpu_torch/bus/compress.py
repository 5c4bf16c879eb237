"""System-codec bindings for Kafka record-batch compression (the port's
copy of oryx_tpu/bus/compress.py).

Kafka codecs 3 (lz4, frame format) and 4 (zstd) have no stdlib codec in
this Python, but the host ships the canonical C libraries (libzstd,
liblz4 — curl links both), so thin ctypes bindings decode foreign
producers' batches against the REAL reference implementations instead of
a reimplementation. Compress counterparts exist for the tests' foreign-
producer corpus. Everything degrades to a clear error when a library is
absent — the caller (kafkawire.decode_record_batches) surfaces which
codec is unsupported on this host.
"""

from __future__ import annotations

import ctypes
import ctypes.util


class CodecUnavailable(RuntimeError):
    pass


# -- zstd -------------------------------------------------------------------

_zstd = None


def _load_zstd():
    global _zstd
    if _zstd is None:
        name = ctypes.util.find_library("zstd")
        if not name:
            raise CodecUnavailable("libzstd not present on this host")
        lib = ctypes.CDLL(name)
        lib.ZSTD_isError.restype = ctypes.c_uint
        lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
        lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
        lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
        lib.ZSTD_decompress.restype = ctypes.c_size_t
        lib.ZSTD_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
        ]
        lib.ZSTD_compressBound.restype = ctypes.c_size_t
        lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
        lib.ZSTD_compress.restype = ctypes.c_size_t
        lib.ZSTD_compress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_int,
        ]
        _zstd = lib
    return _zstd


_ZSTD_CONTENTSIZE_UNKNOWN = 2**64 - 1
_ZSTD_CONTENTSIZE_ERROR = 2**64 - 2


def zstd_decompress(data: bytes) -> bytes:
    lib = _load_zstd()
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _ZSTD_CONTENTSIZE_ERROR:
        raise ValueError("not a zstd frame")
    if size == _ZSTD_CONTENTSIZE_UNKNOWN:
        # streaming frame without a declared size: grow until it fits
        # (kafka batches are bounded by max-message-bytes, so cap sanely)
        cap = max(4 * len(data), 1 << 20)
        while cap <= 1 << 31:
            dst = ctypes.create_string_buffer(cap)
            n = lib.ZSTD_decompress(dst, cap, data, len(data))
            if not lib.ZSTD_isError(n):
                return dst.raw[:n]
            cap *= 2
        raise ValueError("zstd frame too large")
    if size > 1 << 31:
        # a hostile/corrupt frame can declare any content size; cap the
        # allocation like the unknown-size path instead of attempting a
        # multi-exabyte buffer (kafka batches are max-message-bytes bounded)
        raise ValueError(f"zstd frame declares unreasonable size {size}")
    dst = ctypes.create_string_buffer(int(size) if size else 1)
    n = lib.ZSTD_decompress(dst, int(size), data, len(data))
    if lib.ZSTD_isError(n):
        raise ValueError("zstd decompression failed")
    return dst.raw[:n]


def zstd_compress(data: bytes, level: int = 3) -> bytes:
    lib = _load_zstd()
    cap = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress(dst, cap, data, len(data), level)
    if lib.ZSTD_isError(n):
        raise ValueError("zstd compression failed")
    return dst.raw[:n]


# -- lz4 (frame format, what Kafka writes) ----------------------------------

_lz4 = None
_LZ4F_VERSION = 100


def _load_lz4():
    global _lz4
    if _lz4 is None:
        name = ctypes.util.find_library("lz4")
        if not name:
            raise CodecUnavailable("liblz4 not present on this host")
        lib = ctypes.CDLL(name)
        lib.LZ4F_isError.restype = ctypes.c_uint
        lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
        lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
        lib.LZ4F_createDecompressionContext.argtypes = [
            ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint,
        ]
        lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
        lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
        lib.LZ4F_decompress.restype = ctypes.c_size_t
        # src arrives as byref(buffer, offset): keep the pointer params
        # untyped so both arrays and CArgObjects pass
        lib.LZ4F_decompress.argtypes = None
        lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
        lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
        lib.LZ4F_compressFrame.restype = ctypes.c_size_t
        lib.LZ4F_compressFrame.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_void_p,
        ]
        _lz4 = lib
    return _lz4


def lz4f_decompress(data: bytes) -> bytes:
    lib = _load_lz4()
    ctx = ctypes.c_void_p()
    err = lib.LZ4F_createDecompressionContext(ctypes.byref(ctx), _LZ4F_VERSION)
    if lib.LZ4F_isError(err):
        raise ValueError("lz4 context creation failed")
    try:
        out = bytearray()
        # one ctypes view over the input, advanced by offset — re-slicing
        # data[src_pos:] per iteration would copy the remaining input
        # every block (O(n^2) on the multi-block frames Kafka writes)
        src_buf = (ctypes.c_char * len(data)).from_buffer_copy(data)
        src_pos = 0
        chunk = ctypes.create_string_buffer(1 << 18)
        while src_pos < len(data):
            src_size = ctypes.c_size_t(len(data) - src_pos)
            dst_size = ctypes.c_size_t(len(chunk))
            ret = lib.LZ4F_decompress(
                ctx, chunk, ctypes.byref(dst_size),
                ctypes.byref(src_buf, src_pos), ctypes.byref(src_size), None,
            )
            if lib.LZ4F_isError(ret):
                raise ValueError("lz4 frame decompression failed")
            out += chunk.raw[: dst_size.value]
            if src_size.value == 0 and dst_size.value == 0:
                # with big blocks (blockSizeID 5-7: 256KB..4MB) liblz4
                # legitimately flushes buffered OUTPUT while consuming no
                # input — only zero progress on BOTH sides is stuck
                raise ValueError("lz4 decompression made no progress")
            src_pos += src_size.value
            if ret == 0 and src_pos >= len(data):
                break
        return bytes(out)
    finally:
        lib.LZ4F_freeDecompressionContext(ctx)


def lz4f_compress(data: bytes) -> bytes:
    lib = _load_lz4()
    cap = lib.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(cap)
    n = lib.LZ4F_compressFrame(dst, cap, data, len(data), None)
    if lib.LZ4F_isError(n):
        raise ValueError("lz4 frame compression failed")
    return dst.raw[:n]
