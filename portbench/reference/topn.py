"""Plain reference of ``/recommend``: the user's scores against every item
by one matrix product a block of items, known items excluded, the best
``how_many`` kept. It regenerates the factors from the seed
(``portbench/gen.py``) and reads nothing the program made.

``reference_scores`` works in float64. With ``control=True`` it also
ranks in bfloat16 (factors rounded to bfloat16, products returned in
bfloat16), the precision below the float32 scores the configuration
states: that ranking stands in the program's place as the control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from portbench import gen


@dataclass
class TopN:
    ids: np.ndarray     # [n, m] int64 item indices, best first
    scores: np.ndarray  # [n, m] the scores it ranked by, as returned
    true: np.ndarray    # [n, m] float64 scores of those items


def _merge(best_v, best_i, v, i, m):
    v = torch.cat([best_v, v], dim=1)
    i = torch.cat([best_i, i], dim=1)
    top = torch.topk(v, m, dim=1)
    return top.values, torch.gather(i, 1, top.indices)


def reference_scores(seed: int, cfg: dict, users: np.ndarray, served: np.ndarray,
                     how_many: int, device, control: bool = False):
    """For the users ``users`` ([n] indices): the float64 top ``how_many``
    (``TopN``), the float64 scores of ``served`` ([n, how_many] item
    indices, -1 for none), and with ``control`` the bfloat16 ranking's
    ``TopN``."""
    n_items, n_users, f = cfg["items"], cfg["users"], cfg["features"]
    n = len(users)
    x = gen.factor_rows(seed, "X", n_users, f, users, device)
    x64 = x.double().T.contiguous()
    xbf = x.bfloat16().T.contiguous()
    known = gen.known_items(seed, n_users, n_items, cfg["known_items_per_user"],
                            device)[np.asarray(users)]
    known_t = torch.as_tensor(known, device=device)
    served_t = torch.as_tensor(np.asarray(served, dtype=np.int64), device=device)
    served_true = torch.full(served_t.shape, float("nan"), dtype=torch.float64,
                             device=device)
    neg = torch.full((n, how_many), -float("inf"), dtype=torch.float64, device=device)
    idx0 = torch.full((n, how_many), -1, dtype=torch.int64, device=device)
    ref_v, ref_i = neg, idx0
    ctl_v, ctl_i, ctl_t = neg.float(), idx0, neg.clone()
    for b in gen.factor_blocks(n_items):
        lo = b * gen.FACTOR_BLOCK
        y = gen.factor_block(seed, "Y", b, n_items, f, device)
        hi = lo + y.shape[0]
        s = (y.double() @ x64).T  # [n, rows] float64
        # the scores of what was served, read before known items are masked
        inb = (served_t >= lo) & (served_t < hi)
        if inb.any():
            r, c = torch.nonzero(inb, as_tuple=True)
            served_true[r, c] = s[r, served_t[r, c] - lo]
        kin = (known_t >= lo) & (known_t < hi)
        r, c = torch.nonzero(kin, as_tuple=True)
        s[r, known_t[r, c] - lo] = -float("inf")
        top = torch.topk(s, how_many, dim=1)
        ref_v, ref_i = _merge(ref_v, ref_i, top.values, top.indices + lo, how_many)
        if control:
            sb = (y.bfloat16() @ xbf).T.float()
            sb[r, known_t[r, c] - lo] = -float("inf")
            topb = torch.topk(sb, how_many, dim=1)
            tv = torch.gather(s, 1, topb.indices)
            v = torch.cat([ctl_v, topb.values], dim=1)
            i = torch.cat([ctl_i, topb.indices + lo], dim=1)
            t = torch.cat([ctl_t, tv], dim=1)
            sel = torch.topk(v, how_many, dim=1).indices
            ctl_v, ctl_i, ctl_t = (torch.gather(v, 1, sel), torch.gather(i, 1, sel),
                                   torch.gather(t, 1, sel))
        del s
    ref = TopN(ref_i.cpu().numpy(), ref_v.cpu().numpy(), ref_v.cpu().numpy())
    ctl = (TopN(ctl_i.cpu().numpy(), ctl_v.cpu().numpy(), ctl_t.cpu().numpy())
           if control else None)
    return ref, served_true.cpu().numpy(), ctl


def judge(ref: TopN, served_ids: np.ndarray, served_scores: np.ndarray,
          served_true: np.ndarray, known: np.ndarray, how_many: int) -> dict:
    """The numbers compared, over the sampled answers: ``score_err``, the
    widest gap between a served score and the float64 score of its item;
    ``rank_gap``, the widest amount by which the item served at a rank
    lies below the float64 ranking's item at that rank; both relative to
    the user's best float64 score. ``bad_answers`` counts answers that
    are short, repeat an item, name an unknown item or serve a known
    one."""
    scale = np.maximum(np.abs(ref.true[:, 0]), 1e-30)[:, None]
    bad = 0
    for j in range(len(served_ids)):
        row = served_ids[j]
        if (len(row) != how_many or (row < 0).any() or len(set(row.tolist())) != len(row)
                or set(row.tolist()) & set(known[j].tolist())):
            bad += 1
    valid = np.isfinite(served_true)
    score_err = np.abs(served_scores - served_true) / scale
    rank_gap = (ref.true - served_true) / scale
    worst = lambda a: float(np.max(np.where(valid, a, np.inf))) if a.size else float("inf")
    return {"score_err": worst(score_err), "rank_gap": worst(rank_gap),
            "bad_answers": float(bad)}
