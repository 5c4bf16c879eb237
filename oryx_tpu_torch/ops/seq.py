"""Next-item sequence model on tensors: a compact GRU over item embeddings
(the port's counterpart of oryx_tpu/ops/seq.py).

One recurrent cell, embedding-tied output: the logits for "which item comes
next" are ``h @ E.T`` over the SAME item-embedding matrix the inputs gather
from, so the serving layer scores the whole catalog with the top-k shape
the ALS path already dispatches through the micro-batcher
(serving/batcher.py): the hidden state is the "user vector", E the "item
matrix".

The weights keep the JAX package's layout: ``Wx [d,3d]``, ``Wh [d,3d]``,
``b [3d]``, gate blocks in (z, r, n) order, the bias on the x side only and
``r`` multiplying the h-side n block. ``torch.nn.GRUCell`` orders its gates
(r, z, n) and carries a second bias, so it is not used: weights cross
between the packages without permutation.

Training is minibatched softmax cross-entropy with an Adagrad step,
differentiated by ``torch.autograd`` (the JAX package's
``jax.value_and_grad``), every f32 product in full f32 on the card
(``full_f32``: TF32 off), with the prediction-convergence early stop of the
JAX trainer. None of it has a hand kernel: the JAX package runs it as XLA
ops, with no Pallas kernel to port.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.device import resolve_device
from oryx_tpu_torch.ops.vector import full_f32

# Non-embedding GRU parameter names, in artifact/tensor order. The
# embedding matrix "E" rides separately: it is also the serving catalog
# (streamed row-by-row as UP messages, like ALS factor rows).
GRU_PARAM_NAMES = ("Wx", "Wh", "b")


class GruModel(NamedTuple):
    """A trained next-item model: item embeddings + recurrent weights."""

    e: np.ndarray          # [V, d] item embeddings (also the output table)
    params: dict           # Wx [d,3d], Wh [d,3d], b [3d]
    item_ids: list         # [V] row-aligned item id strings


def init_gru_params(gen: torch.Generator, dim: int) -> dict:
    """Recurrent weights at 1/sqrt(d) scale, drawn from ``gen``; gate order
    is (z, r, n). numpy f32 arrays, as the JAX package returns them."""
    s = 1.0 / math.sqrt(dim)
    draw = lambda: (  # noqa: E731
        torch.randn((dim, 3 * dim), generator=gen, device=gen.device) * s
    ).cpu().numpy().astype(np.float32)
    wx = draw()
    wh = draw()
    return {"Wx": wx, "Wh": wh, "b": np.zeros(3 * dim, dtype=np.float32)}


def gru_from_numpy(e, params: dict, device=None) -> dict:
    """The JAX package's GruModel arrays (or any numpy weights) as the
    port's f32 tensors on ``device``: {"E": [V,d], "Wx", "Wh", "b"}, each a
    copy. ``e`` may be None for the recurrent weights alone."""
    dev = resolve_device(device)
    # copies, never views of the caller's arrays: the trainer updates its
    # weights in place
    copy = lambda a: torch.tensor(np.asarray(a, dtype=np.float32), device=dev)  # noqa: E731
    out = {} if e is None else {"E": copy(e)}
    for k in GRU_PARAM_NAMES:
        out[k] = copy(params[k])
    return out


def gru_to_numpy(weights: dict) -> tuple[np.ndarray | None, dict]:
    """Inverse of gru_from_numpy: (e or None, {Wx, Wh, b}) as numpy f32."""
    host = lambda t: t.detach().cpu().numpy().astype(np.float32)  # noqa: E731
    e = host(weights["E"]) if "E" in weights else None
    return e, {k: host(weights[k]) for k in GRU_PARAM_NAMES}


def _gru_cell(params: dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """One GRU step: x [B,d] inputs, h [B,d] state -> new state."""
    d = h.shape[-1]
    gx = x @ params["Wx"] + params["b"]
    gh = h @ params["Wh"]
    z = torch.sigmoid(gx[:, :d] + gh[:, :d])
    r = torch.sigmoid(gx[:, d : 2 * d] + gh[:, d : 2 * d])
    n = torch.tanh(gx[:, 2 * d :] + r * gh[:, 2 * d :])
    return (1.0 - z) * n + z * h


def _encode_embedded(params: dict, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Run the cell over time: xs [B,L,d] embedded inputs, mask [B,L]
    (1 = real event, 0 = left padding); returns the final h [B,d]. Masked
    steps carry the state through unchanged."""
    h = torch.zeros((xs.shape[0], xs.shape[2]), dtype=xs.dtype, device=xs.device)
    keep = mask > 0
    for t in range(xs.shape[1]):
        h2 = _gru_cell(params, xs[:, t], h)
        h = torch.where(keep[:, t, None], h2, h)
    return h


def encode_vectors(params: dict, xs: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Session encoder over pre-gathered embedding vectors (the serving
    path's form: the request carries item ids, the caller gathers their
    rows from the factor store). Tensors in, tensor out, full f32."""
    with torch.no_grad(), full_f32():
        return _encode_embedded(params, xs, mask)


def _encode_idx(params: dict, e: torch.Tensor, idx: torch.Tensor, mask) -> torch.Tensor:
    return _encode_embedded(params, e[idx], mask)


def _nll(weights: dict, idx, mask, targets) -> torch.Tensor:
    """Mean next-item negative log-likelihood of a minibatch under the
    embedding-tied softmax (logits = h @ E.T); E is both gathered and the
    output table."""
    e = weights["E"]
    h = _encode_idx(weights, e, idx, mask)
    return F.cross_entropy(h @ e.T, targets.long())


def _adagrad_step(weights: dict, accum: dict, idx, mask, targets, lr: float):
    """One minibatch step, IN PLACE on ``weights`` and ``accum`` (dicts of
    f32 tensors); returns (weights, accum, loss). ``a = accum + g*g``;
    ``w -= lr * g / sqrt(a + 1e-8)``. train_gru seeds the accumulator at 0
    for cold starts and at 1.0 for warm resumes (a zero restart takes
    lr-sized sign steps that re-shock a converged model)."""
    names = list(weights)
    leaves = [weights[k].detach().requires_grad_(True) for k in names]
    with full_f32():
        loss = _nll(dict(zip(names, leaves)), idx, mask, targets)
        grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for k, g in zip(names, grads):
            a = accum[k]
            a.addcmul_(g, g)
            weights[k].sub_(lr * g / torch.sqrt(a + 1e-8))
    return weights, accum, loss.detach()


def _sampled_scores(weights: dict, idx, mask, targets) -> torch.Tensor:
    """Predicted scores of the true next items on a fixed probe sample: the
    convergence signal (prediction space, not parameter space)."""
    with torch.no_grad(), full_f32():
        h = _encode_idx(weights, weights["E"], idx, mask)
        return torch.sum(h * weights["E"][targets.long()], dim=-1)


def train_gru(
    contexts: np.ndarray,
    mask: np.ndarray,
    targets: np.ndarray,
    n_items: int,
    dim: int,
    item_ids,
    epochs: int = 30,
    lr: float = 0.5,
    batch: int = 1024,
    seed_key: torch.Generator | None = None,
    resume_e: np.ndarray | None = None,
    resume_params: dict | None = None,
    tol: float = 0.0,
    min_epochs: int = 2,
    check_every: int = 2,
    probe: int = 512,
    device=None,
) -> tuple[GruModel, int]:
    """Train the next-item GRU on ``device`` (the card unless the caller
    names the CPU); returns (model, epochs actually run).

    contexts [N,L] int32 item rows (left-padded), mask [N,L], targets [N]
    item rows. resume_e/resume_params warm-start from the previous
    generation (ids already aligned by the caller via ops/als.py
    align_factors); tol > 0 enables the prediction-convergence early stop
    checked every ``check_every`` epochs after ``min_epochs``.

    The cold init and the shuffle seed come from ``seed_key`` (a
    ``torch.Generator``, else the RandomManager's next one), drawn on the
    generator's device, so a cold build differs from the JAX package's by
    design. The examples go to the device once; each epoch uploads its
    permutation once and every minibatch is indexed on the device from it,
    the last one padded by wrapping round, as the JAX trainer pads it.
    """
    n = int(contexts.shape[0])
    if n == 0 or n_items == 0:
        raise ValueError("no training examples")
    dev = resolve_device(device)
    g = seed_key if seed_key is not None else RandomManager.get_generator()
    shuffle_seed = int(torch.randint(0, 1 << 30, (1,), generator=g,
                                     device=g.device).item())
    if resume_e is not None and np.shape(resume_e) == (n_items, dim):
        e0 = np.asarray(resume_e, dtype=np.float32)
    else:
        e0 = (torch.randn((n_items, dim), generator=g, device=g.device)
              * (1.0 / math.sqrt(dim))).cpu().numpy().astype(np.float32)
    params = (
        {k: np.asarray(v, dtype=np.float32) for k, v in resume_params.items()}
        if resume_params is not None
        and all(k in resume_params for k in GRU_PARAM_NAMES)
        and np.shape(resume_params.get("Wh")) == (dim, 3 * dim)
        else init_gru_params(g, dim)
    )
    weights = gru_from_numpy(e0, params, dev)
    # Warm resumes seed the Adagrad accumulator at 1.0 instead of 0: a
    # zero accumulator makes every first step lr-sized REGARDLESS of the
    # gradient (sign steps), which re-shocks a converged model for several
    # epochs before the prediction-convergence stop can fire; with the
    # floor, steps near convergence are ~lr·g.
    accum_0 = 1.0 if resume_e is not None and resume_params is not None else 0.0
    accum = {k: torch.full_like(v, accum_0) for k, v in weights.items()}

    batch = max(1, min(batch, n))
    ctx_d = torch.as_tensor(np.asarray(contexts, dtype=np.int64)).to(dev)
    mask_d = torch.as_tensor(np.asarray(mask, dtype=np.float32)).to(dev)
    tgt_d = torch.as_tensor(np.asarray(targets, dtype=np.int64)).to(dev)
    # fixed probe sample for the convergence signal (deterministic)
    rng = np.random.default_rng(shuffle_seed)
    probe_rows = torch.as_tensor(
        rng.choice(n, size=min(probe, n), replace=False)).to(dev)
    p_idx, p_mask, p_tgt = ctx_d[probe_rows], mask_d[probe_rows], tgt_d[probe_rows]

    prev_scores = None
    ran = 0
    for epoch in range(max(1, int(epochs))):
        order = torch.as_tensor(rng.permutation(n)).to(dev)
        for lo in range(0, n, batch):
            rows = order[lo : lo + batch]
            if rows.shape[0] < batch:  # wrap round to the full batch
                rows = torch.cat([rows, order[: batch - rows.shape[0]]])
            _adagrad_step(weights, accum, ctx_d[rows], mask_d[rows],
                          tgt_d[rows], lr)
        ran = epoch + 1
        if tol > 0 and ran >= min_epochs and ran % max(1, check_every) == 0:
            scores = _sampled_scores(weights, p_idx, p_mask, p_tgt).cpu().numpy()
            if prev_scores is not None:
                denom = float(np.linalg.norm(prev_scores)) or 1.0
                rel = float(np.linalg.norm(scores - prev_scores)) / denom
                if rel < tol:
                    break
            prev_scores = scores
    e, out_params = gru_to_numpy(weights)
    return GruModel(e=e, params=out_params, item_ids=list(item_ids)), ran


def next_item_hit_rate(
    e: np.ndarray,
    params: dict,
    contexts: np.ndarray,
    mask: np.ndarray,
    targets: np.ndarray,
    k: int = 10,
    chunk: int = 2048,
    device=None,
) -> float:
    """Mean hit-rate@k over next-item examples: the fraction whose true
    next item lands in the model's top-k (the ONE definition the batch
    eval and the quality gate share). The encode and ``h @ E.T`` run in f32
    on ``device``; the top-k is the host's argpartition, as in the JAX
    package. NaN when there is nothing to evaluate."""
    n = int(contexts.shape[0])
    if n == 0:
        return float("nan")
    w = gru_from_numpy(e, params, device)
    e_d = w["E"]
    k = min(k, int(e_d.shape[0]))
    hits = 0
    for lo in range(0, n, chunk):
        idx = torch.as_tensor(np.asarray(contexts[lo : lo + chunk], np.int64)).to(e_d.device)
        m = torch.as_tensor(np.asarray(mask[lo : lo + chunk], np.float32)).to(e_d.device)
        h = encode_vectors(w, e_d[idx], m)
        with torch.no_grad(), full_f32():
            logits = (h @ e_d.T).cpu().numpy()
        top = np.argpartition(-logits, k - 1, axis=1)[:, :k]
        hits += int((top == targets[lo : lo + chunk, None]).any(axis=1).sum())
    return hits / n


def encode_sessions(params: dict, item_vectors, mask, device=None) -> np.ndarray:
    """Host-friendly wrapper: encode pre-gathered [B,L,d] item vectors
    (zeros on padded steps) into [B,d] hidden states on ``device``."""
    p = gru_from_numpy(None, params, device)
    dev = p["Wx"].device
    xs = torch.as_tensor(np.asarray(item_vectors, dtype=np.float32)).to(dev)
    m = torch.as_tensor(np.asarray(mask, dtype=np.float32)).to(dev)
    return encode_vectors(p, xs, m).cpu().numpy()
