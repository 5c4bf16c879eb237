"""Sequence-parallel attention of the PyTorch port
(oryx_tpu_torch/ops/attention.py) on CPU meshes: tests/test_attention.py's
contracts against the port, then the port against the JAX package's
attention on the same numpy-seeded inputs. Every comparison holds the
values within 2e-5 (atol and rtol, f32); the two-process gloo ring and
Ulysses step is in tests/test_torch_distributed.py."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import attention as J
from oryx_tpu.parallel.mesh import MeshSpec as JaxMeshSpec
from oryx_tpu.parallel.mesh import make_mesh as jax_make_mesh
from oryx_tpu_torch.ops.attention import attention, ring_attention, ulysses_attention
from oryx_tpu_torch.parallel.mesh import DATA_AXIS, MeshArray, MeshSpec, make_mesh

TOL = dict(atol=2e-5, rtol=2e-5)


def _mesh(n, model=1):
    return make_mesh(MeshSpec(data=n, model=model), ["cpu"] * (n * model))


def _jax_mesh(n):
    return jax_make_mesh(JaxMeshSpec(data=n, model=1), jax.devices("cpu")[:n])


def _qkv(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


# ---- tests/test_attention.py's contracts on the port ---------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ring_matches_exact_2d(causal, n_shards):
    q, k, v = _qkv(0, (64, 16))
    ref = attention(q, k, v, causal=causal)
    out = ring_attention(q, k, v, _mesh(n_shards), causal=causal)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_matches_exact_batched_heads(causal):
    q, k, v = _qkv(1, (2, 3, 32, 8))
    ref = attention(q, k, v, causal=causal)
    out = ring_attention(q, k, v, _mesh(4), causal=causal)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), **TOL)


def test_ring_output_keeps_sequence_sharding():
    q, _, _ = _qkv(2, (32, 8))
    out = ring_attention(q, q, q, _mesh(4))
    # the output stays split over the data axis (no implicit gather)
    assert isinstance(out, MeshArray) and out.axis == DATA_AXIS
    assert len(out.shards) == 4 and out.dim == 0
    assert all(b.shape == (8, 8) for b in out.shards.values())
    assert out.full().shape == (32, 8)


def test_rejects_indivisible_sequence():
    q = np.zeros((30, 8), dtype=np.float32)
    with pytest.raises(ValueError):
        ring_attention(q, q, q, _mesh(4))


def test_causal_first_token_attends_only_itself():
    q, k, v = _qkv(3, (16, 4))
    out = ring_attention(q, k, v, _mesh(2), causal=True)
    np.testing.assert_allclose(np.asarray(out)[0], v[0], atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_ulysses_matches_exact(causal, n_shards):
    q, k, v = _qkv(7, (2, 8, 32, 4))
    out = ulysses_attention(q, k, v, _mesh(n_shards), causal=causal)
    ref = attention(q, k, v, causal=causal)
    np.testing.assert_allclose(np.asarray(out), ref.numpy(), **TOL)


def test_ulysses_matches_ring():
    """The two sequence-parallel schedules agree with each other on the
    same inputs."""
    q, k, v = _qkv(8, (1, 8, 64, 8))
    mesh = _mesh(4)
    out_u = ulysses_attention(q, k, v, mesh, causal=True)
    out_r = ring_attention(q, k, v, mesh, causal=True)
    np.testing.assert_allclose(np.asarray(out_u), np.asarray(out_r), **TOL)


def test_ulysses_rejects_indivisible_heads():
    q = np.random.default_rng(9).normal(size=(3, 16, 4)).astype(np.float32)
    with pytest.raises(ValueError, match="head count"):
        ulysses_attention(q, q, q, _mesh(2), causal=False)


def test_ulysses_keeps_sequence_sharding():
    q = np.random.default_rng(10).normal(size=(4, 16, 4)).astype(np.float32)
    out = ulysses_attention(q, q, q, _mesh(4), causal=False)
    assert out.axis == DATA_AXIS and out.dim == 1  # sequence stays split
    assert all(b.shape == (4, 4, 4) for b in out.shards.values())


# ---- the port's own edges --------------------------------------------------

def test_ulysses_rejects_mismatched_heads_and_sequence():
    q = np.zeros((4, 16, 4), np.float32)
    with pytest.raises(ValueError, match="k head count"):
        ulysses_attention(q, np.zeros((2, 16, 4), np.float32), q, _mesh(2))
    with pytest.raises(ValueError, match="sequence length"):
        ulysses_attention(np.zeros((4, 15, 4), np.float32),
                          np.zeros((4, 15, 4), np.float32),
                          np.zeros((4, 15, 4), np.float32), _mesh(2))
    with pytest.raises(ValueError, match=r"\[\.\.\., H, S, D\]"):
        ulysses_attention(q[0], q[0], q[0], _mesh(2))


def test_mesh_array_inputs_and_a_model_axis():
    """Sequence shards already on the mesh feed the next call as they
    are, and a (2, 2) mesh's model replicas compute the same blocks."""
    q, k, v = _qkv(11, (2, 4, 16, 8))
    mesh = _mesh(2, model=2)
    first = ring_attention(q, k, v, mesh, causal=True)
    again = ring_attention(first, first, first, mesh)
    ref = attention(attention(q, k, v, causal=True), *(
        [attention(q, k, v, causal=True)] * 2))
    np.testing.assert_allclose(np.asarray(again), ref.numpy(), **TOL)
    assert torch.equal(first.block(1, 0), first.block(1, 1))
    uly = ulysses_attention(q, k, v, mesh, causal=True)
    np.testing.assert_allclose(np.asarray(uly), np.asarray(first), **TOL)


def test_bf16_inputs_keep_their_dtype():
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16) for a in _qkv(12, (32, 8)))
    out = ring_attention(q, k, v, _mesh(4), causal=True)
    assert out.full().dtype == torch.bfloat16
    ref = attention(q.float(), k.float(), v.float(), causal=True)
    np.testing.assert_allclose(out.full().float().numpy(), ref.numpy(),
                               atol=2e-2)


# ---- the port against the JAX package -------------------------------------

@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(24, 8), (20, 12), (2, 3, 16, 8)])
def test_attention_matches_jax(causal, shape):
    """The exact path, cross-attention shapes included (the causal mask is
    tril(k = sk - sq))."""
    q, k, v = _qkv(20, shape)
    if len(shape) == 2 and shape[0] == 20:
        k, v = (np.concatenate([a, a[:8]]) for a in (k, v))  # sk = 28
    ref = np.asarray(J.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                 causal=causal))
    np.testing.assert_allclose(attention(q, k, v, causal=causal).numpy(), ref, **TOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_ring_and_ulysses_match_jax(causal, n_shards):
    """Both schedules of both packages on one mesh size and the same
    inputs: the port's ring against the JAX ring, the port's Ulysses
    against the JAX Ulysses."""
    q, k, v = _qkv(21, (2, 4, 32, 8))
    jm = _jax_mesh(n_shards)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ring_j = np.asarray(J.ring_attention(jq, jk, jv, jm, causal=causal))
    uly_j = np.asarray(J.ulysses_attention(jq, jk, jv, jm, causal=causal))
    mesh = _mesh(n_shards)
    np.testing.assert_allclose(
        np.asarray(ring_attention(q, k, v, mesh, causal=causal)), ring_j, **TOL)
    np.testing.assert_allclose(
        np.asarray(ulysses_attention(q, k, v, mesh, causal=causal)), uly_j, **TOL)
