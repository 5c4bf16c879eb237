"""Inputs made from ``--seed``: factor tables, known items and MovieLens-
shaped interactions, drawn on the device in a few large calls.

Every draw comes from a ``torch.Generator`` seeded by ``subseed(seed,
tag, block)``, so a block can be made again on its own: the reference
regenerates the factor rows it needs instead of reading the program's
copy. The interaction generator follows the distribution of the
program's ``ml/synth.py`` (Zipf item popularity, log-normal user
activity, planted genres), drawn on the device and cut to distinct
(user, item) pairs, as MovieLens holds one rating a pair.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

FACTOR_BLOCK = 1 << 20  # rows a factor block holds


def subseed(seed: int, tag: str, block: int = 0) -> int:
    """A 63-bit generator seed for one (seed, tag, block)."""
    h = hashlib.blake2b(f"{int(seed)}:{tag}:{int(block)}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(seed: int, tag: str, device, block: int = 0) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag, block))
    return g


def factor_block(seed: int, tag: str, block: int, n_rows: int, features: int,
                 device) -> torch.Tensor:
    """Rows [block * FACTOR_BLOCK, ...) of an N(0, 1) f32 factor table of
    ``n_rows`` rows."""
    lo = block * FACTOR_BLOCK
    rows = min(FACTOR_BLOCK, n_rows - lo)
    return torch.randn((rows, features), generator=generator(seed, tag, device, block),
                       device=device, dtype=torch.float32)


def factor_blocks(n_rows: int) -> range:
    return range(-(-n_rows // FACTOR_BLOCK))


def factor_table(seed: int, tag: str, n_rows: int, features: int, device) -> np.ndarray:
    """The whole table on the host: each block drawn on ``device`` and
    copied into one preallocated f32 array."""
    out = np.empty((n_rows, features), dtype=np.float32)
    host = torch.from_numpy(out)
    pinned = None
    for b in factor_blocks(n_rows):
        lo = b * FACTOR_BLOCK
        blk = factor_block(seed, tag, b, n_rows, features, device)
        if blk.device.type == "cpu":
            host[lo:lo + blk.shape[0]] = blk
            continue
        if pinned is None:  # a device-to-host copy runs fastest into pinned memory
            pinned = torch.empty(blk.shape, dtype=blk.dtype, pin_memory=True)
        stage = pinned[:blk.shape[0]]
        stage.copy_(blk)
        host[lo:lo + blk.shape[0]] = stage
    return out


def factor_rows(seed: int, tag: str, n_rows: int, features: int, rows,
                device) -> torch.Tensor:
    """The table's rows ``rows`` (any order), block by block on ``device``."""
    rows = torch.as_tensor(np.asarray(rows, dtype=np.int64), device=device)
    out = torch.empty((rows.numel(), features), dtype=torch.float32, device=device)
    which = rows // FACTOR_BLOCK
    for b in torch.unique(which).tolist():
        sel = torch.nonzero(which == b)[:, 0]
        blk = factor_block(seed, tag, b, n_rows, features, device)
        out[sel] = blk[rows[sel] - b * FACTOR_BLOCK]
    return out


def known_items(seed: int, n_users: int, n_items: int, per_user: int,
                device) -> np.ndarray:
    """[n_users, per_user] int64 item indices each user already knows (a
    repeat within a user's row is one item)."""
    g = generator(seed, "known", device)
    return torch.randint(0, n_items, (n_users, per_user), generator=g,
                         device=device).cpu().numpy()


def _draw(cum: torch.Tensor, n: int, g: torch.Generator) -> torch.Tensor:
    """n indices drawn by the cumulative weights ``cum`` (f64, last = 1)."""
    u = torch.rand(n, generator=g, device=cum.device, dtype=torch.float64)
    return torch.clamp(torch.searchsorted(cum, u * cum[-1]), max=cum.numel() - 1)


def interactions(seed: int, n_users: int, n_items: int, nnz: int, gen: dict,
                 device) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(users int32, items int32, values f32): ``nnz`` distinct (user,
    item) pairs in the order they were first drawn. ``gen`` holds the
    distribution: zipf_exponent, user_lognormal_sigma, genres, in_genre_p,
    ratings, oversample (draws per kept pair, enough that every seed
    yields ``nnz`` distinct pairs)."""
    g = generator(seed, "interactions", device)
    f64 = torch.float64
    item_w = 1.0 / torch.arange(1, n_items + 1, device=device, dtype=f64) ** gen["zipf_exponent"]
    user_w = torch.exp(torch.randn(n_users, generator=g, device=device, dtype=f64)
                       * gen["user_lognormal_sigma"])
    n_genres = int(gen["genres"])
    item_genre = torch.randint(0, n_genres, (n_items,), generator=g, device=device)
    user_genre = torch.randint(0, n_genres, (n_users,), generator=g, device=device)
    m = int(nnz * gen["oversample"])
    users = _draw(torch.cumsum(user_w, 0), m, g)
    items = _draw(torch.cumsum(item_w, 0), m, g)
    # the in-genre share is redrawn from the user's own genre, popularity-
    # weighted within it
    in_genre = torch.rand(m, generator=g, device=device) < gen["in_genre_p"]
    ug = user_genre[users]
    for k in range(n_genres):
        rows = torch.nonzero(in_genre & (ug == k))[:, 0]
        pool = torch.nonzero(item_genre == k)[:, 0]
        if rows.numel() == 0 or pool.numel() == 0:
            continue
        items[rows] = pool[_draw(torch.cumsum(item_w[pool], 0), rows.numel(), g)]
    ratings = torch.tensor(gen["ratings"], device=device, dtype=torch.float32)
    values = ratings[torch.randint(0, ratings.numel(), (m,), generator=g, device=device)]
    # first draw of each pair, then the first nnz of those in draw order
    key = users * n_items + items
    _, order = torch.sort(key, stable=True)
    ks = key[order]
    first = torch.ones_like(ks, dtype=torch.bool)
    first[1:] = ks[1:] != ks[:-1]
    kept = torch.sort(order[first]).values
    if kept.numel() < nnz:
        raise RuntimeError(
            f"{kept.numel()} distinct pairs from {m} draws, fewer than {nnz}: "
            "raise the generator's oversample")
    kept = kept[:nnz]
    return (users[kept].to(torch.int32).cpu().numpy(),
            items[kept].to(torch.int32).cpu().numpy(),
            values[kept].cpu().numpy())


def initial_y(seed: int, n_items: int, features: int, device) -> np.ndarray:
    """The builds' starting item factors: the program's own random init
    (N(0, 0.1) around 1 / sqrt(features)), drawn from the seed."""
    g = generator(seed, "y0", device)
    y = torch.randn((n_items, features), generator=g, device=device) * 0.1 + features ** -0.5
    return y.cpu().numpy()
