"""The plain references agree with the port at tiny sizes on the CPU, the
controls fail the checks, and a run with the timed path broken
underneath comes out not correct."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import calibrate, gen
from portbench.reference import als as als_ref
from portbench.tests.tiny import PARKED_TRAINING, run_cell, tiny_cell

SERVE = "als-serve-20m-250f.recommend-c2"
TRAIN = PARKED_TRAINING["name"]


def correct(cell, checks: dict) -> bool:
    return all(checks.get(k, float("inf")) <= lim for k, lim in cell.config["limits"].items())


@pytest.mark.parametrize("workload", [SERVE, TRAIN])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_the_port_agrees_with_the_reference(workload, seed):
    cell = tiny_cell(workload)
    out, setup = run_cell(cell, seed=seed, seconds=0.5)
    assert correct(cell, out.checks), out.checks
    assert out.attempted > 0 and out.failed == 0
    assert setup.seconds is not None and set(setup.pieces)


def test_the_serving_control_fails():
    """The bfloat16 ranking in the program's place reads far past the
    limits (score_err is a float32-rounding number for the port)."""
    cell = tiny_cell(SERVE)
    for seed in (1, 2, 3):
        numbers = calibrate.serving_control(cell, seed, torch.device("cpu"))
        assert not correct(cell, numbers), numbers


@pytest.mark.cuda
def test_the_training_control_fails_on_the_card():
    """The reference's sweeps with TF32 products in the program's place
    fail factor_err (TF32 has no effect on the CPU, so this runs on the
    card), at a size a test run holds."""
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    cell = tiny_cell(TRAIN)
    cell.config.update(users=3000, items=2000, interactions=60000, features=64)
    for seed in (1, 2, 3):
        numbers = calibrate.training_control(cell, seed, torch.device("cuda"))
        assert not correct(cell, numbers), numbers


def _swap_first_two(trim):
    def broken(*a, **kw):
        pairs = trim(*a, **kw)
        if len(pairs) >= 2:
            (i0, s0), (i1, s1) = pairs[0], pairs[1]
            pairs = [(i1, s0), (i0, s1)] + pairs[2:]
        return pairs
    return broken


def _half_of_them(trim):
    def broken(*a, **kw):
        pairs = trim(*a, **kw)
        return pairs[: len(pairs) // 2]
    return broken


def _score_nudged(trim):
    def broken(*a, **kw):
        return [(i, s * 1.001) for i, s in trim(*a, **kw)]
    return broken


@pytest.mark.parametrize("fault", [_swap_first_two, _half_of_them, _score_nudged])
def test_an_altered_answer_is_not_correct(monkeypatch, fault):
    """An answer altered where it is produced (the serving model's trim of
    its ranked pairs): items swapped, half left out, or scores off by a
    tenth of a percent."""
    from oryx_tpu_torch.apps.als import serving

    monkeypatch.setattr(serving, "_trim_pairs", fault(serving._trim_pairs))
    cell = tiny_cell(SERVE)
    out, _ = run_cell(cell, seconds=0.5)
    assert not correct(cell, out.checks), out.checks


def _unchanged(factors, gram_f, buckets, lam, alpha, implicit, blocks, out, **kw):
    return out


def _half_rows(half_step):
    def broken(factors, gram_f, idx, val, mask, *a, **kw):
        x = half_step(factors, gram_f, idx, val, mask, *a, **kw)
        x[x.shape[0] // 2:] = 0.0
        return x
    return broken


@pytest.mark.parametrize("fault", ["unchanged", "half_rows"])
def test_a_broken_sweep_is_not_correct(monkeypatch, fault):
    """A half-step that returns its state unchanged, or that leaves half of
    its rows unsolved."""
    from oryx_tpu_torch.ops import als

    if fault == "unchanged":
        monkeypatch.setattr(als, "_half_step_buckets", _unchanged)
    else:
        monkeypatch.setattr(als, "_half_step", _half_rows(als._half_step))
    cell = tiny_cell(TRAIN)
    out, _ = run_cell(cell, seconds=0.2)
    assert not correct(cell, out.checks), out.checks


def test_the_truncation_rule_keeps_the_largest_values_first():
    users = np.array([0, 0, 0, 0, 1])
    items = np.array([5, 6, 7, 8, 5])
    values = np.array([1.0, 3.0, 3.0, 2.0, 1.0])
    e, o, v, counts = als_ref.side_lists(users, items, values, 2, 2, torch.device("cpu"))
    assert e.tolist() == [0, 0, 1] and o.tolist() == [6, 7, 5]
    assert counts.tolist() == [2, 1]


def test_inputs_follow_the_seed():
    cpu = torch.device("cpu")
    g = tiny_cell(TRAIN).config["generator"] | {"oversample": 4.0}
    a = gen.interactions(5, 300, 200, 1000, g, cpu)
    b = gen.interactions(5, 300, 200, 1000, g, cpu)
    c = gen.interactions(2 ** 32 + 5, 300, 200, 1000, g, cpu)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[1], c[1])
    pairs = set(zip(a[0].tolist(), a[1].tolist()))
    assert len(pairs) == 1000
    rows = gen.factor_rows(9, "Y", 5000, 4, [4999, 3], cpu)
    whole = torch.from_numpy(gen.factor_table(9, "Y", 5000, 4, cpu))
    assert torch.equal(rows, whole[[4999, 3]])
