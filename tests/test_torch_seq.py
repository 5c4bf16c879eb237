"""The next-item GRU of the PyTorch port (oryx_tpu_torch/ops/seq.py) on the
CPU against the JAX package's (oryx_tpu/ops/seq.py), same numpy-seeded
inputs (d = 16, L = 8, V <= 200), each tolerance stated; then the seq
quality harness (ml/quality.py) against tests/test_quality_gate.py's
floors. The port runs on ``device="cpu"``. Cold inits come from a torch
generator in the port and from ``jax.random`` in the JAX package, so the
trainers are compared from one shared warm start.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oryx_tpu.ops import seq as J
from oryx_tpu_torch.ops import seq as P

CPU = "cpu"
D, L, V = 16, 8, 120


def _weights(v=V, d=D, seed=0):
    """numpy E [v,d] and GRU params at the trainers' init scale, non-zero b."""
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(d)
    e = (rng.standard_normal((v, d)) * s).astype(np.float32)
    params = {
        "Wx": (rng.standard_normal((d, 3 * d)) * s).astype(np.float32),
        "Wh": (rng.standard_normal((d, 3 * d)) * s).astype(np.float32),
        "b": (rng.standard_normal(3 * d) * 0.1).astype(np.float32),
    }
    return e, params


def _examples(n=96, v=V, window=L, seed=1):
    """Left-padded contexts of random lengths 1..window, mask, targets."""
    rng = np.random.default_rng(seed)
    ctx = rng.integers(0, v, (n, window)).astype(np.int32)
    lens = rng.integers(1, window + 1, n)
    mask = (np.arange(window)[None, :] >= window - lens[:, None]).astype(np.float32)
    ctx = np.where(mask > 0, ctx, 0).astype(np.int32)
    tgt = rng.integers(0, v, n).astype(np.int32)
    return ctx, mask, tgt


def _jax_weights(e, params):
    return {"E": jnp.asarray(e), **{k: jnp.asarray(params[k]) for k in J.GRU_PARAM_NAMES}}


def _port_weights(e, params):
    return P.gru_from_numpy(e, params, CPU)


# ---- forward ---------------------------------------------------------------

def test_gru_cell_matches_jax():
    """One cell step, gate order (z, r, n) with the bias on the x side:
    atol 1e-5."""
    _, params = _weights()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((7, D)).astype(np.float32)
    h = np.tanh(rng.standard_normal((7, D))).astype(np.float32)
    want = np.asarray(J._gru_cell({k: jnp.asarray(v) for k, v in params.items()},
                                  jnp.asarray(x), jnp.asarray(h)))
    got = P._gru_cell(P.gru_from_numpy(None, params, CPU),
                      torch.from_numpy(x), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_gru_cell_is_not_torch_gru_cell_order():
    """The layout is the JAX package's, not torch.nn.GRUCell's (r, z, n):
    swapping the z and r blocks changes the answer, so a weight carried
    over without permutation is read as the JAX package reads it."""
    _, params = _weights()
    swapped = dict(params)
    for name in ("Wx", "Wh"):
        w = params[name]
        swapped[name] = np.concatenate([w[:, D:2 * D], w[:, :D], w[:, 2 * D:]], axis=1)
    x = torch.ones((2, D))
    h = torch.full((2, D), 0.5)
    a = P._gru_cell(P.gru_from_numpy(None, params, CPU), x, h)
    b = P._gru_cell(P.gru_from_numpy(None, swapped, CPU), x, h)
    assert not torch.allclose(a, b, atol=1e-3)


def test_encode_sessions_matches_jax():
    """The masked scan over a left-padded window: atol 1e-5; a fully
    masked row stays at h = 0 in both."""
    e, params = _weights()
    ctx, mask, _ = _examples(n=40)
    mask[0] = 0.0
    vecs = e[ctx] * mask[..., None]
    want = J.encode_sessions(params, vecs, mask)
    got = P.encode_sessions(params, vecs, mask, device=CPU)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert not got[0].any()


# ---- the loss and its gradients -----------------------------------------

def test_nll_value_and_gradients_match_jax():
    """_nll's value and its gradients for E, Wx, Wh and b: port autograd
    against jax.value_and_grad, atol 1e-5. E is both gathered and the
    output table, so its gradient has both contributions."""
    e, params = _weights()
    ctx, mask, tgt = _examples()
    loss_j, grads_j = jax.value_and_grad(J._nll)(
        _jax_weights(e, params), jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(tgt))
    w = {k: v.requires_grad_(True) for k, v in _port_weights(e, params).items()}
    loss_p = P._nll(w, torch.from_numpy(ctx).long(), torch.from_numpy(mask),
                    torch.from_numpy(tgt))
    grads_p = torch.autograd.grad(loss_p, list(w.values()))
    assert abs(float(loss_p.detach()) - float(loss_j)) <= 1e-5
    for name, g in zip(w, grads_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads_j[name]),
                                   atol=1e-5, rtol=0, err_msg=name)


@pytest.mark.parametrize("accum0", [0.0, 1.0])
def test_adagrad_step_matches_jax(accum0):
    """One step with the accumulator at 0 (cold: near lr·sign(g)) and at
    1.0 (warm): weights and accumulators within 1e-4, loss within 1e-5."""
    e, params = _weights()
    ctx, mask, tgt = _examples()
    wj = _jax_weights(e, params)
    aj = {k: jnp.full_like(v, accum0) for k, v in wj.items()}
    nw_j, na_j, loss_j = J._adagrad_step(
        wj, aj, jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(tgt), jnp.float32(0.5))
    wp = _port_weights(e, params)
    ap = {k: torch.full_like(v, accum0) for k, v in wp.items()}
    nw_p, na_p, loss_p = P._adagrad_step(
        wp, ap, torch.from_numpy(ctx).long(), torch.from_numpy(mask),
        torch.from_numpy(tgt), 0.5)
    assert abs(float(loss_p) - float(loss_j)) <= 1e-5
    for name in wj:
        np.testing.assert_allclose(nw_p[name].numpy(), np.asarray(nw_j[name]),
                                   atol=1e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(na_p[name].numpy(), np.asarray(na_j[name]),
                                   atol=1e-4, rtol=0, err_msg=name)
    if accum0 == 0.0:
        # the cold step is near lr·sign(g): no weight moves further than lr,
        # and one whose |g| > 1e-3 moves within 0.5% of it
        moved = np.abs(nw_p["Wh"].numpy() - params["Wh"])
        big = na_p["Wh"].numpy() > 1e-6
        assert moved.max() <= 0.5 + 1e-5 and big.any()
        assert (moved[big] >= 0.4975).all()


def test_sampled_scores_match_jax():
    e, params = _weights()
    ctx, mask, tgt = _examples(n=30)
    want = np.asarray(J._sampled_scores(
        _jax_weights(e, params), jnp.asarray(ctx), jnp.asarray(mask), jnp.asarray(tgt)))
    got = P._sampled_scores(_port_weights(e, params), torch.from_numpy(ctx).long(),
                            torch.from_numpy(mask), torch.from_numpy(tgt)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ---- the trainer ------------------------------------------------------------

def _chain_examples(v=40, n_sessions=60, window=L):
    """Sessions stepping planted chains, windowed by the app's ingest."""
    from oryx_tpu_torch.apps.seq.common import windowed_examples

    vocab = {f"i{j}": j for j in range(v)}
    sessions = {f"s{s}": [f"i{(s * 3 + t) % v}" for t in range(7)]
                for s in range(n_sessions)}
    return windowed_examples(sessions, vocab, window=window), list(vocab)


def test_train_gru_warm_full_batch_matches_jax():
    """Warm-started from the same resume_e/resume_params with batch >= n,
    3 epochs at tol = 0: every epoch is one full-batch step, so the shuffle
    order between the packages cannot matter. Weights within 1e-4."""
    (ctx, mask, tgt), ids = _chain_examples()
    v = len(ids)
    e, params = _weights(v=v, seed=5)
    kw = dict(n_items=v, dim=D, item_ids=ids, epochs=3, lr=0.5,
              batch=len(tgt) + 7, resume_e=e, resume_params=params, tol=0.0)
    jm, jran = J.train_gru(ctx, mask, tgt, seed_key=jax.random.PRNGKey(0), **kw)
    pm, pran = P.train_gru(ctx, mask, tgt, seed_key=torch.Generator().manual_seed(0),
                           device=CPU, **kw)
    assert jran == pran == 3
    assert pm.item_ids == jm.item_ids
    np.testing.assert_allclose(pm.e, jm.e, atol=1e-4, rtol=0)
    for name in J.GRU_PARAM_NAMES:
        np.testing.assert_allclose(pm.params[name], jm.params[name], atol=1e-4,
                                   rtol=0, err_msg=name)
    assert not np.allclose(pm.e, e, atol=1e-3), "training did not move E"
    np.testing.assert_array_equal(e, _weights(v=v, seed=5)[0])  # not written


def test_train_gru_early_stop_epoch_count_matches_jax():
    """tol > 0 with n <= probe (the probe is every row) from one converged
    warm start, full batches: both packages stop after the same epoch
    count, and before the budget (tests/test_seq_app.py's warm-start
    early stop)."""
    (ctx, mask, tgt), ids = _chain_examples(v=12, n_sessions=40, window=4)
    v = len(ids)
    e, params = _weights(v=v, seed=6)
    base = dict(n_items=v, dim=8, item_ids=ids, lr=0.5, batch=len(tgt))
    e, params = e[:, :8], {"Wx": params["Wx"][:8, :24], "Wh": params["Wh"][:8, :24],
                           "b": params["b"][:24]}
    cold, _ = J.train_gru(ctx, mask, tgt, epochs=30, resume_e=e,
                          resume_params=params, seed_key=jax.random.PRNGKey(0),
                          **{**base, "batch": 16})
    kw = dict(epochs=10, resume_e=cold.e, resume_params=cold.params, tol=0.05,
              min_epochs=2, check_every=2, **base)
    assert len(tgt) <= 512
    _, jran = J.train_gru(ctx, mask, tgt, seed_key=jax.random.PRNGKey(1), **kw)
    _, pran = P.train_gru(ctx, mask, tgt, seed_key=torch.Generator().manual_seed(1),
                          device=CPU, **kw)
    assert pran == jran < 10


def test_train_gru_minibatches_wrap_and_cold_start_is_seeded():
    """A batch that does not divide n pads the last minibatch by wrapping
    round; the same generator seed gives the same cold build, and another
    seed another one; the warm accumulator floor needs both resume
    pieces."""
    (ctx, mask, tgt), ids = _chain_examples()
    kw = dict(n_items=len(ids), dim=D, item_ids=ids, epochs=2, batch=37, device=CPU)
    a, ran = P.train_gru(ctx, mask, tgt, seed_key=torch.Generator().manual_seed(3), **kw)
    b, _ = P.train_gru(ctx, mask, tgt, seed_key=torch.Generator().manual_seed(3), **kw)
    c, _ = P.train_gru(ctx, mask, tgt, seed_key=torch.Generator().manual_seed(4), **kw)
    assert ran == 2 and len(tgt) % 37
    np.testing.assert_array_equal(a.e, b.e)
    assert not np.allclose(a.e, c.e)
    assert all(np.isfinite(v).all() for v in (a.e, *a.params.values()))
    with pytest.raises(ValueError):
        P.train_gru(ctx[:0], mask[:0], tgt[:0], **kw)


def test_init_gru_params_shapes_and_scale():
    p = P.init_gru_params(torch.Generator().manual_seed(0), 32)
    assert p["Wx"].shape == p["Wh"].shape == (32, 96) and p["b"].shape == (96,)
    assert all(v.dtype == np.float32 for v in p.values())
    assert not p["b"].any()
    assert abs(float(p["Wx"].std()) - 1 / np.sqrt(32)) < 0.02


def test_next_item_hit_rate_matches_jax():
    """The same weights give the same hit-rate (the top-k is the host's
    argpartition in both packages), at two k and across chunks."""
    e, params = _weights(v=V, seed=7)
    ctx, mask, tgt = _examples(n=150, seed=8)
    # plant the answer for a third of the rows: the target is the row whose
    # embedding best matches the encoded context
    h = J.encode_sessions(params, e[ctx] * mask[..., None], mask)
    tgt[::3] = np.argmax(h @ e.T, axis=1)[::3]
    for k in (1, 10):
        want = J.next_item_hit_rate(e, params, ctx, mask, tgt, k=k, chunk=64)
        got = P.next_item_hit_rate(e, params, ctx, mask, tgt, k=k, chunk=64, device=CPU)
        assert got == want, k
    assert P.next_item_hit_rate(e, params, ctx, mask, tgt, k=1, device=CPU) >= 1 / 3
    assert np.isnan(P.next_item_hit_rate(e, params, ctx[:0], mask[:0], tgt[:0],
                                         device=CPU))


def test_gru_from_numpy_round_trips():
    """JAX GruModel arrays -> port tensors -> numpy, bit for bit; the
    recurrent weights alone too."""
    (ctx, mask, tgt), ids = _chain_examples()
    jm, _ = J.train_gru(ctx, mask, tgt, n_items=len(ids), dim=D, item_ids=ids,
                        epochs=1, seed_key=jax.random.PRNGKey(2))
    w = P.gru_from_numpy(jm.e, jm.params, CPU)
    assert set(w) == {"E", *P.GRU_PARAM_NAMES}
    assert all(t.dtype == torch.float32 and t.device.type == "cpu" for t in w.values())
    e, params = P.gru_to_numpy(w)
    np.testing.assert_array_equal(e, jm.e)
    for name in P.GRU_PARAM_NAMES:
        np.testing.assert_array_equal(params[name], jm.params[name])
    e2, p2 = P.gru_to_numpy(P.gru_from_numpy(None, jm.params, CPU))
    assert e2 is None and set(p2) == set(P.GRU_PARAM_NAMES)
    # the JAX weights encode the same states through the port
    vecs = jm.e[ctx[:20]] * mask[:20, :, None]
    np.testing.assert_allclose(
        P.encode_sessions(params, vecs, mask[:20], device=CPU),
        J.encode_sessions(jm.params, vecs, mask[:20]), atol=1e-5, rtol=0)


# ---- the quality harness ------------------------------------------------------

def test_synthesize_sessions_is_the_jax_stream():
    from oryx_tpu.ml.quality import synthesize_sessions as jax_synth
    from oryx_tpu_torch.ml.quality import synthesize_sessions

    a = synthesize_sessions(50, 20, 6, seed=3)
    b = jax_synth(50, 20, 6, seed=3)
    assert len(a) == len(b) and all((x == y).all() for x, y in zip(a, b))


def test_seq_quality_harness_smoke():
    """The port's harness at tests/test_quality_gate.py's toy shape: the
    same > 0.5 floor (chance is 0.05)."""
    from oryx_tpu_torch.ml.quality import build_and_evaluate_seq

    rep = build_and_evaluate_seq(
        n_items=200, n_sessions=300, session_len=8, dim=16, epochs=6, device=CPU
    )
    assert rep.hit_rate > 0.5, (rep.hit_rate, rep.chance)
    assert rep.examples > 0 and rep.build_s > 0 and rep.epochs_run == 6
    assert rep.model.e.shape == (200, 16)


nightly = pytest.mark.skipif(
    not os.environ.get("ORYX_NIGHTLY"),
    reason="seq quality gate at its full shape: minutes of CPU; set ORYX_NIGHTLY=1",
)


@nightly
def test_seq_next_item_hit_rate_floor():
    """The calibrated gate (tests/test_quality_gate.py SEQ_HIT_RATE_FLOOR)
    at the harness's defaults."""
    from oryx_tpu_torch.ml.quality import build_and_evaluate_seq

    rep = build_and_evaluate_seq(device=CPU)
    assert rep.hit_rate >= 0.65, (rep.hit_rate, rep.chance)
