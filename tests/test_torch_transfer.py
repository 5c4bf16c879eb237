"""The port's serving-matrix transfers (oryx_tpu_torch/ops/transfer.py)
against the JAX package's oryx_tpu/ops/transfer.py, on the CPU."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import transfer as J
from oryx_tpu_torch.ops import transfer as P


def _matrix(seed, n=300, f=17):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, f)).astype(np.float32) * rng.uniform(
        0.01, 20.0, size=(n, 1)
    ).astype(np.float32)
    a[5] = 0.0  # an all-zero row keeps scale 1 and stays zero
    a[9, :] = 0.5 / 127.0 * np.arange(f)  # exact .5 steps: round half even
    return a


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_rows_int8_bit_exact(seed):
    a = _matrix(seed)
    q, s = P.quantize_rows_int8(a)
    q_j, s_j = J.quantize_rows_int8(a)
    assert q.dtype == np.int8 and s.dtype == np.float32
    assert np.array_equal(q, q_j)
    assert np.array_equal(s, s_j)


def test_quantized_device_put_matches_jax():
    a = _matrix(3)
    qm = P.quantized_device_put(a, device="cpu")
    qm_j = J.quantized_device_put(a)
    assert qm.shape == tuple(qm_j.shape)
    assert qm.dtype == torch.int8 and qm.device.type == "cpu"
    assert np.array_equal(qm.q.numpy(), np.asarray(qm_j.q))
    assert np.array_equal(qm.scale.numpy(), np.asarray(qm_j.scale))
    assert qm.nbytes == qm_j.nbytes


def test_unit_scaled_matches_jax_and_shares_rows():
    a = _matrix(4)
    qm = P.quantized_device_put(a, device="cpu")
    unit = qm.unit_scaled()
    unit_j = J.quantized_device_put(a).unit_scaled()
    assert unit.q is qm.q  # the cosine view shares the int8 rows
    np.testing.assert_allclose(
        unit.scale.numpy(), np.asarray(unit_j.scale), atol=1e-6
    )
    assert unit.scale[5].item() == 0.0  # zero rows stay zero


def test_staged_device_put_chunks_into_one_tensor():
    a = _matrix(5, n=1000, f=8)
    t = P.staged_device_put(a, dtype=torch.bfloat16, device="cpu",
                            chunk_bytes=4 * 8 * 7)  # 7 rows per chunk
    assert t.dtype == torch.bfloat16 and t.shape == (1000, 8)
    ref = np.asarray(jnp.asarray(a, dtype=jnp.bfloat16), dtype=np.float32)
    assert np.array_equal(t.float().numpy(), ref)


def test_quantized_scatter_requantizes_dirty_rows_only():
    # mirrors tests/test_score_modes.py: untouched int8 rows and scales are
    # bit-identical to the previous view's, and both packages agree
    rng = np.random.default_rng(7)
    y = rng.standard_normal((256, 8)).astype(np.float32)
    qm = P.quantized_device_put(y, device="cpu")
    dirty = np.array([3, 77, 200], dtype=np.int32)
    new_rows = 5.0 * rng.standard_normal((3, 8)).astype(np.float32)
    qm2 = P.scatter_rows(qm, dirty, new_rows)
    assert isinstance(qm2, P.QuantizedMatrix)
    assert qm2.q is not qm.q  # the old view stays whole for in-flight work
    q_old, q_new = qm.q.numpy(), qm2.q.numpy()
    s_old, s_new = qm.scale.numpy(), qm2.scale.numpy()
    clean = np.setdiff1d(np.arange(256), dirty)
    assert np.array_equal(q_old[clean], q_new[clean])
    assert np.array_equal(s_old[clean], s_new[clean])
    deq = q_new[dirty].astype(np.float32) * s_new[dirty][:, None]
    np.testing.assert_allclose(deq, new_rows, atol=np.abs(new_rows).max() / 100)
    qm2_j = J.scatter_rows(J.quantized_device_put(y), dirty, new_rows)
    assert np.array_equal(q_new, np.asarray(qm2_j.q))
    assert np.array_equal(s_new, np.asarray(qm2_j.scale))


def test_scatter_rows_bf16_matches_jax_and_keeps_old_buffer():
    rng = np.random.default_rng(8)
    y = rng.standard_normal((100, 6)).astype(np.float32)
    buf = P.staged_device_put(y, dtype=torch.bfloat16, device="cpu")
    before = buf.clone()
    idx = np.array([0, 50, 99])
    rows = rng.standard_normal((3, 6)).astype(np.float32)
    out = P.scatter_rows(buf, idx, rows)
    assert torch.equal(buf, before)
    out_j = J.scatter_rows(jnp.asarray(y, dtype=jnp.bfloat16), idx, rows)
    assert np.array_equal(out.float().numpy(),
                          np.asarray(out_j, dtype=np.float32))
    assert P.scatter_rows(buf, np.array([], dtype=np.int64), rows[:0]) is buf


@pytest.mark.parametrize("quantized", [False, True])
def test_scatter_rows_grows_to_appended_rows(quantized):
    # a delta that appends rows writes them into a grown copy; the rows
    # before stay as they were, and a view never shrinks
    rng = np.random.default_rng(10)
    y = rng.standard_normal((40, 5)).astype(np.float32)
    if quantized:
        buf = P.quantized_device_put(y, device="cpu")
    else:
        buf = P.staged_device_put(y, dtype=torch.bfloat16, device="cpu")
    rows = rng.standard_normal((3, 5)).astype(np.float32)
    idx = np.array([7, 40, 41])
    out = P.scatter_rows(buf, idx, rows, n_rows=42)
    assert out.shape == (42, 5) and buf.shape == (40, 5)
    whole = np.concatenate([y, np.zeros((2, 5), np.float32)])
    whole[idx] = rows
    if quantized:
        q, s = P.quantize_rows_int8(whole)
        assert np.array_equal(out.q.numpy(), q)
        assert np.array_equal(out.scale.numpy(), s)
    else:
        ref = np.asarray(jnp.asarray(whole, dtype=jnp.bfloat16), np.float32)
        assert np.array_equal(out.float().numpy(), ref)
    with pytest.raises(ValueError):
        P.scatter_rows(buf, idx[:1], rows[:1], n_rows=39)


def test_scatter_bytes_count_exact_rows():
    # eager PyTorch needs no padding ladder: the bytes are the d rows and
    # their int64 indices (the JAX package pads d up a bucket ladder)
    for d in (0, 1, 63, 64, 65, 5000):
        assert P.scatter_transfer_bytes(d, 2, 50) == d * (50 * 2 + 8)
        assert P.quantized_scatter_bytes(d, 50) == d * (50 + 8) + d * 12


@pytest.mark.parametrize("headroom", [0.0, 0.125, 0.5])
def test_row_capacity_ladder_matches_jax(headroom):
    sizes = list(range(0, 300)) + [1000, 4095, 4096, 4097, 1_000_000,
                                   5_000_000, 20_000_000]
    prev = 0
    for n in sizes:
        cap = P.row_capacity(n, headroom)
        assert cap == J.row_capacity(n, headroom)
        assert cap >= n and cap >= prev
        prev = cap


def _assert_pitched(view, want):
    """``view`` is a pitched item view of the values ``want`` (a torch
    tensor [n, F]): dense rows at a 16-byte multiple stride, zero padding."""
    n, f = want.shape
    assert tuple(view.shape) == (n, f)
    assert P.is_pitched(view)
    pitch = view.stride(0)
    assert pitch == P.row_pitch(f, view.dtype)
    assert (pitch * view.element_size()) % 16 == 0
    whole = view.as_strided((n, pitch), (pitch, 1))
    assert torch.equal(whole[:, f:], torch.zeros_like(whole[:, f:]))
    assert torch.equal(view, want)


@pytest.mark.parametrize("f,pitch_bf16,pitch_i8", [
    (50, 56, 64), (250, 256, 256), (17, 24, 32), (16, 16, 16), (8, 8, 16),
])
def test_row_pitch_rounds_rows_to_16_bytes(f, pitch_bf16, pitch_i8):
    assert P.row_pitch(f, torch.bfloat16) == pitch_bf16
    assert P.row_pitch(f, torch.int8) == pitch_i8
    assert P.row_pitch(f, torch.float32) * 4 % 16 == 0


@pytest.mark.parametrize("f", [50, 17, 16])
def test_pitched_views_through_build_delta_and_growth(f):
    # a full build, a delta scatter, growth by appended rows, and the
    # quantized and cosine views: each is pitched, zero-padded, and holds
    # the values the dense path would
    rng = np.random.default_rng(f)
    y = _matrix(f, n=90, f=f)
    bf = P.staged_device_put(y, dtype=torch.bfloat16, device="cpu")
    _assert_pitched(bf, torch.from_numpy(y).to(torch.bfloat16))
    qm = P.quantized_device_put(y, device="cpu")
    q, s = P.quantize_rows_int8(y)
    _assert_pitched(qm.q, torch.from_numpy(q))
    assert torch.equal(qm.scale, torch.from_numpy(s))
    assert qm.unit_scaled().q is qm.q

    idx = np.array([3, 40, 90, 91])  # two rows moved, two appended
    rows = rng.standard_normal((4, f)).astype(np.float32)
    whole = np.concatenate([y, np.zeros((2, f), np.float32)])
    whole[idx] = rows
    for n_rows, want_rows in ((None, y.copy()), (92, whole)):
        sel = idx if n_rows else idx[:2]
        if n_rows is None:
            want_rows[idx[:2]] = rows[:2]
        out = P.scatter_rows(bf, sel, rows[:len(sel)], n_rows)
        _assert_pitched(out, torch.from_numpy(want_rows).to(torch.bfloat16))
        out_q = P.scatter_rows(qm, sel, rows[:len(sel)], n_rows)
        _assert_pitched(out_q.q, torch.from_numpy(P.quantize_rows_int8(want_rows)[0]))
    # the dense source of a pitched copy is left as it was
    dense = torch.from_numpy(y).to(torch.bfloat16)
    assert not P.is_pitched(dense) or f * 2 % 16 == 0
    _assert_pitched(P.to_pitched(dense), dense)
    assert P.to_pitched(bf) is bf
