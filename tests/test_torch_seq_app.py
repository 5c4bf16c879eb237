"""The seq app of the PyTorch port (oryx_tpu_torch/apps/seq): its batch,
speed and serving tiers and /recommend-next, on ``device="cpu"``.

- tests/test_seq_app.py's contracts against port objects: sessionize,
  windowing, parsing, the aggregate merge and its round trip, update
  application, the trainer's warm-start early stop, the speed fold's delta,
  bounded tails and replay idempotence, the serving view's dirty-row delta
  sync and the unknown-context answer. The port's view holds live rows
  only, so the delta grows the device copy by the new row instead of
  filling a padding row.
- tests/test_e2e_seq.py's lambda slice and read-only mode against the
  port's layers.
- Across the packages: the validate hook on the chaos lines, MODEL + UP
  floods and aggregate snapshots written by one package and loaded by the
  other, the speed managers' UP rows and the serving models' answers on
  the same inputs, and a warm second generation from the same previous
  weights.
- The app registry and ``--app seq`` on the CLI.
"""

from __future__ import annotations

import json
import shutil
import time

import numpy as np
import pytest

from e2e_common import http_request as _http

from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.bus.broker import get_broker, topics
from oryx_tpu_torch.bus.inproc import InProcBroker
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.rng import RandomManager

CPU = "cpu"


@pytest.fixture(autouse=True)
def _fresh():
    from oryx_tpu.bus.inproc import InProcBroker as JaxInProc

    InProcBroker.reset_all()
    JaxInProc.reset_all()
    RandomManager.use_test_seed()
    yield
    InProcBroker.reset_all()
    JaxInProc.reset_all()


def _cfg(**extra):
    return load_config(overlay={**extra})


def _kms(lines):
    return [KeyMessage(None, line) for line in lines]


class _Collect:
    """A producer that keeps what it is sent: [(key, message)]."""

    def __init__(self):
        self.sent = []

    def send(self, key, message):
        self.sent.append((key, message))

    def send_batch(self, records):
        self.sent.extend(records)


# ---- windowed ingest -------------------------------------------------------

def test_sessionize_orders_dedups_and_caps():
    from oryx_tpu_torch.apps.seq.common import session_key, sessionize

    users = np.asarray(["u1"] * 5, dtype=object)
    sess = np.asarray(["s1"] * 5, dtype=object)
    items = np.asarray(["c", "a", "b", "a", "d"], dtype=object)
    tss = np.asarray([30, 10, 20, 10, 40], dtype=np.int64)  # dup (10, a)
    out = sessionize(users, sess, items, tss)
    assert list(out) == [session_key("u1", "s1")]
    assert out[session_key("u1", "s1")] == [(10, "a"), (20, "b"), (30, "c"), (40, "d")]
    capped = sessionize(users, sess, items, tss, max_events=2)
    assert capped[session_key("u1", "s1")] == [(30, "c"), (40, "d")]


def test_windowed_examples_shapes_and_padding():
    from oryx_tpu_torch.apps.seq.common import windowed_examples

    vocab = {f"i{j}": j for j in range(5)}
    contexts, mask, targets = windowed_examples({"k": ["i0", "i1", "i2", "i3"]},
                                                vocab, window=2)
    assert contexts.shape == (3, 2) and mask.shape == (3, 2)
    assert list(targets) == [1, 2, 3]
    assert mask[0].tolist() == [0.0, 1.0] and contexts[0, 1] == 0
    assert contexts[2].tolist() == [1, 2]
    assert windowed_examples({"k": ["i0"]}, vocab, 2)[2].size == 0
    _, _, t2 = windowed_examples({"k": ["i0", "zzz", "i1"]}, vocab, 2)
    assert t2.size == 0


def test_parse_session_events_skips_bad_lines():
    from oryx_tpu_torch.apps.seq.common import parse_session_events

    users, _sess, items, tss = parse_session_events(_kms([
        "u1,s1,i1,1000", "u1,s1,i2", "u1,,i2,1000", '["u2","s2","i3",7]',
    ]))
    assert list(users) == ["u1", "u2"]
    assert list(items) == ["i1", "i3"]
    assert list(tss) == [1000, 7]


def _chaos_lines():
    return [
        "u1,s1,i1,1000", '["u2","s2","i2",5]', "u3,s3,i3", "u4,s4,,1000",
        "u5,s5,i5,notats", "u6,s6,i6,1e400", "",
    ]


def test_valid_session_lines_agree_with_jax_and_parse():
    """The validate hook in lockstep with parse_session_events (the JAX
    package's tests/test_chaos.py contract) and with the JAX package's
    hook, line class by line class."""
    from oryx_tpu.apps.seq.common import valid_session_lines as jax_valid
    from oryx_tpu_torch.apps.seq.common import (
        parse_session_events, valid_session_line, valid_session_lines,
    )

    lines = _chaos_lines()
    got = valid_session_lines(lines)
    assert got == [valid_session_line(l) for l in lines] == jax_valid(lines)
    assert got == [True, True, False, False, False, False, False]
    assert len(parse_session_events(lines)[3]) == sum(got)


# ---- mergeable aggregate ---------------------------------------------------

def _random_lines(seed=3, n=60):
    rng = np.random.default_rng(seed)
    return [f"u{rng.integers(0, 4)},s{rng.integers(0, 6)},i{rng.integers(0, 9)},{t}"
            for t in rng.permutation(n)]


def test_aggregate_merge_matches_from_scratch_and_roundtrips():
    from oryx_tpu.apps.seq.batch import SeqAggregateState as JaxAgg
    from oryx_tpu_torch.apps.seq.batch import SeqAggregateState
    from oryx_tpu_torch.apps.seq.common import parse_session_events

    lines = _random_lines()
    ev = parse_session_events(_kms(lines))
    full = SeqAggregateState.from_events(*ev, 50)
    merged = SeqAggregateState.empty(50)
    for lo in range(0, 60, 17):
        chunk = parse_session_events(_kms(lines[lo : lo + 17]))
        merged = merged.merge(SeqAggregateState.from_events(*chunk, 50))
    assert merged.sessions == full.sessions
    back = SeqAggregateState.from_arrays(full.to_arrays(), 50)
    assert back.sessions == full.sessions and back.entries == full.entries
    # the arrays cross between the packages both ways
    assert JaxAgg.from_arrays(full.to_arrays(), 50).sessions == full.sessions
    assert SeqAggregateState.from_arrays(
        JaxAgg.from_events(*ev, 50).to_arrays(), 50).sessions == full.sessions


# ---- update-topic state ----------------------------------------------------

def _model_message(n_items=4, dim=8, window=3, inline_e=True):
    from oryx_tpu_torch.common.artifact import ModelArtifact
    from oryx_tpu_torch.ops.seq import init_gru_params

    import torch

    rng = np.random.default_rng(1)
    tensors = dict(init_gru_params(torch.Generator().manual_seed(0), dim))
    if inline_e:
        tensors["E"] = rng.standard_normal((n_items, dim)).astype(np.float32)
    art = ModelArtifact("seq", extensions={"dim": str(dim), "window": str(window)},
                        tensors=tensors)
    art.set_extension("ItemIDs", [f"i{j}" for j in range(n_items)])
    return art.to_string()


def test_apply_seq_update_model_then_up_flood():
    from oryx_tpu_torch.apps.seq.state import apply_seq_update
    from oryx_tpu_torch.apps.updates import vector_update_message

    st = apply_seq_update(None, "MODEL", _model_message(inline_e=False))
    assert st.fraction_loaded() == 0.0
    for j in range(4):
        _, msg = vector_update_message("E", f"i{j}", np.full(8, float(j)))
        st = apply_seq_update(st, "UP", msg)
    assert st.fraction_loaded() == 1.0
    assert st.items.get("i2")[0] == 2.0
    _, stale = vector_update_message("E", "i0", np.zeros(5))
    st2 = apply_seq_update(st, "UP", stale)
    assert st2 is st and st.items.get("i0")[0] == 0.0
    assert apply_seq_update(None, "UP", stale) is None


def test_apply_seq_update_dim_change_resets_state():
    from oryx_tpu_torch.apps.seq.state import apply_seq_update

    st = apply_seq_update(None, "MODEL", _model_message(dim=8))
    assert st.fraction_loaded() == 1.0
    st2 = apply_seq_update(st, "MODEL", _model_message(dim=16))
    assert st2 is not st and st2.dim == 16
    # same width: the state is kept, the window and weights swap
    st3 = apply_seq_update(st2, "MODEL", _model_message(dim=16, window=5))
    assert st3 is st2 and st3.window == 5


def test_model_without_weights_is_rejected():
    from oryx_tpu_torch.apps.seq.state import apply_seq_update
    from oryx_tpu_torch.common.artifact import ModelArtifact

    art = ModelArtifact("seq", extensions={"dim": "8", "window": "3"})
    with pytest.raises(ValueError):
        apply_seq_update(None, "MODEL", art.to_string())


# ---- trainer: warm start + early stop --------------------------------------

def test_train_gru_warm_start_early_stops():
    import torch

    from oryx_tpu_torch.apps.seq.common import windowed_examples
    from oryx_tpu_torch.ops.seq import train_gru

    vocab = {f"i{j}": j for j in range(12)}
    sessions = {f"s{s}": [f"i{(s + t) % 12}" for t in range(6)] for s in range(40)}
    contexts, mask, targets = windowed_examples(sessions, vocab, window=4)
    ids = list(vocab)
    cold, ran_cold = train_gru(
        contexts, mask, targets, n_items=12, dim=8, item_ids=ids, epochs=10,
        seed_key=torch.Generator().manual_seed(0), device=CPU,
    )
    assert ran_cold == 10
    _warm, ran_warm = train_gru(
        contexts, mask, targets, n_items=12, dim=8, item_ids=ids, epochs=10,
        resume_e=cold.e, resume_params=cold.params, tol=0.05, min_epochs=2,
        check_every=2, seed_key=torch.Generator().manual_seed(1), device=CPU,
    )
    assert ran_warm < ran_cold, "warm start from a converged model did not early-stop"


# ---- speed fold-in ---------------------------------------------------------

def _speed(cfg=None):
    from oryx_tpu_torch.apps.seq.speed import SeqSpeedModelManager

    return SeqSpeedModelManager(cfg or _cfg(), device=CPU)


def test_speed_fold_emits_delta_and_bounds_tails():
    mgr = _speed(_cfg(**{"oryx.seq.speed.max-sessions": 3}))
    assert mgr.build_updates(_kms(["u1,s1,i1,1"])) == []  # no model
    mgr.consume_key_message("MODEL", _model_message(n_items=6, dim=8))
    ups = mgr.build_updates(_kms(["u1,s1,i0,10", "u1,s1,i1,11"]))
    assert len(ups) == 1 and ups[0][0] == "UP" and ups[0][1].startswith('["E"')
    for s in range(5):
        mgr.build_updates(_kms([f"u1,sx{s},i0,{100 + s}", f"u1,sx{s},i1,{200 + s}"]))
    assert len(mgr._tails) <= 3


def test_speed_fold_replayed_window_is_idempotent():
    mgr = _speed()
    mgr.consume_key_message("MODEL", _model_message(n_items=6, dim=8))
    window = _kms(["u1,s1,i0,100", "u1,s1,i1,101", "u1,s1,i2,102"])
    assert mgr.build_updates(window), "the first pass must fold the window"
    assert mgr.build_updates(window) == [], "replayed window double-folded"
    assert mgr.build_updates(_kms(["u1,s1,i3,103"]))


def test_speed_managers_publish_alike():
    """The same MODEL and window through both packages' speed managers:
    the same UP ids, vectors within 1e-5 (a new item included)."""
    from oryx_tpu.apps.seq.speed import SeqSpeedModelManager as JaxSpeed
    from oryx_tpu.bus.api import KeyMessage as JaxKM
    from oryx_tpu.common.config import load_config as jax_load

    msg = _model_message(n_items=30, dim=8, window=4)
    rng = np.random.default_rng(4)
    window = [f"u{s % 3},s{s},i{rng.integers(0, 30)},{1000 + 10 * s + t}"
              for s in range(12) for t in range(5)]
    window += ["u9,snew,i3,5000", "u9,snew,iNEW,5001"]
    jm = JaxSpeed(jax_load())
    jm.consume_key_message("MODEL", msg)
    pm = _speed()
    pm.consume_key_message("MODEL", msg)
    ju = jm.build_updates([JaxKM(None, l) for l in window])
    pu = pm.build_updates(_kms(window))
    assert len(ju) == len(pu) > 0
    rows_j = {json.loads(m)[1]: json.loads(m)[2] for k, m in ju}
    rows_p = {json.loads(m)[1]: json.loads(m)[2] for k, m in pu}
    assert set(rows_j) == set(rows_p) and "iNEW" in rows_p
    for ident, vec in rows_j.items():
        np.testing.assert_allclose(rows_p[ident], vec, atol=1e-5, rtol=0, err_msg=ident)


# ---- serving device view: delta sync ---------------------------------------

def _serving(cfg=None):
    from oryx_tpu_torch.apps.seq.serving import SeqServingModelManager

    return SeqServingModelManager(cfg or _cfg(), device=CPU)


def test_serving_view_applies_dirty_row_delta_not_full_rebuild():
    from oryx_tpu_torch.apps.updates import vector_update_message

    mgr = _serving()
    mgr.consume_key_message("MODEL", _model_message(n_items=6, dim=8))
    model = mgr.get_model()
    assert model._device_view is not None, "the listener builds the view"
    pairs = model.next_items(["i0", "i1"], 3, exclude={"i0", "i1"})
    assert len(pairs) == 3
    v1 = model.served_version()
    host1 = model._device_view[3]
    resyncs = get_registry().counter("oryx_view_resync_total")
    deltas = resyncs.value(kind="delta")
    _, msg = vector_update_message("E", "iNEW", np.ones(8))
    mgr.consume_key_message("UP", msg)
    pairs2 = model.next_items(["i0", "i1"], 8, exclude=set())
    assert model.served_version() > v1
    assert any(i == "iNEW" for i, _ in pairs2) or len(pairs2) == 8
    view = model._device_view
    assert resyncs.value(kind="delta") == deltas + 1
    # live rows only: the device copy grew by the new row, the host mirror
    # took it within its capacity
    assert int(view[0].shape[0]) == len(view[1]) == 7 and "iNEW" in view[1]
    assert view[3] is host1 and host1.shape[0] >= 7
    np.testing.assert_array_equal(view[0][6].float().numpy(), np.ones(8))


def test_serving_encode_unknown_context_is_none():
    mgr = _serving()
    mgr.consume_key_message("MODEL", _model_message())
    model = mgr.get_model()
    assert model.encode(["nope", "alsono"]) is None
    assert model.next_items(["nope"], 3) is None
    assert model.encode([]) is None


def test_serving_readiness_waits_for_the_view():
    """A skeleton MODEL reports nothing loaded; the UP flood builds the
    view on the listener's thread once the load fraction is reached."""
    from oryx_tpu_torch.apps.updates import vector_update_message

    mgr = _serving(_cfg(**{"oryx.serving.min-model-load-fraction": 1.0}))
    mgr.consume_key_message("MODEL", _model_message(inline_e=False))
    model = mgr.get_model()
    for j in range(4):
        assert model.fraction_loaded() == 0.0 and model._device_view is None
        mgr.consume_key_message("UP", vector_update_message("E", f"i{j}", np.full(8, j + 1.0))[1])
    assert model.fraction_loaded() == 1.0 and len(model._device_view[1]) == 4


def test_sharded_serving_view_is_not_ported():
    with pytest.raises(ValueError, match="shard"):
        _serving(_cfg(**{"oryx.serving.api.sync.shard-count": 2}))


def test_serving_answers_match_jax():
    """The same MODEL into both packages' serving managers: the same ids
    and values (values within 1e-5; ids equal but where two candidates
    tie within that)."""
    from oryx_tpu.apps.seq.serving import SeqServingModelManager as JaxServing
    from oryx_tpu.common.config import load_config as jax_load

    msg = _model_message(n_items=200, dim=16, window=5)
    jm = JaxServing(jax_load())
    jm.consume_key_message("MODEL", msg)
    pm = _serving()
    pm.consume_key_message("MODEL", msg)
    rng = np.random.default_rng(9)
    for r in range(20):
        ctx = [f"i{j}" for j in rng.integers(0, 200, 1 + r % 7)]
        want = jm.get_model().next_items(ctx, 10, exclude=set(ctx))
        got = pm.get_model().next_items(ctx, 10, exclude=set(ctx))
        assert len(got) == len(want) == 10
        vj = np.asarray([v for _, v in want])
        vp = np.asarray([v for _, v in got])
        np.testing.assert_allclose(vp, vj, atol=1e-5, rtol=0)
        for (ij, a), (ip, b) in zip(want, got):
            assert ij == ip or abs(a - b) <= 1e-5, (ctx, want, got)
        h_j = jm.get_model().encode(ctx)
        np.testing.assert_allclose(pm.get_model().encode(ctx), h_j, atol=1e-5, rtol=0)


# ---- artifacts across the packages ------------------------------------------

def _train_lines(n_sessions=40, v=20, per=6, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for s in range(n_sessions):
        it = int(rng.integers(0, v))
        for t in range(per):
            lines.append(f"u{s % 7},s{s},i{it},{1000 + s * 100 + t}")
            it = (it * 3 + 1) % v
    return lines


def _seq_overlay(tmp_path=None, **extra):
    overlay = {"oryx.seq.hyperparams.dim": 8, "oryx.seq.hyperparams.epochs": 4,
               "oryx.seq.window": 4, "oryx.ml.eval.test-fraction": 0.1}
    if tmp_path is not None:
        overlay["oryx.batch.storage.data-dir"] = str(tmp_path)
    overlay.update(extra)
    return overlay


def _published(update, model, tmp_path):
    """What a SeqUpdate publishes for ``model``: the MODEL skeleton, the
    stamp and the E row flood, as (key, message) pairs."""
    out = _Collect()
    path = str(model.write(tmp_path / "m"))
    update.publish_model(model, path, out)
    update.publish_additional_model_data(model, path, out)
    return out.sent


@pytest.mark.parametrize("direction", ["jax-to-port", "port-to-jax"])
def test_model_and_up_flood_cross_the_packages(direction, tmp_path):
    """A MODEL + UP flood published by one package's batch tier loads into
    the other's SeqState: the same item rows, bit for bit, and the same
    recurrent weights."""
    from oryx_tpu.apps.seq.batch import SeqUpdate as JaxUpdate
    from oryx_tpu.apps.seq.state import apply_seq_update as jax_apply
    from oryx_tpu.bus.api import KeyMessage as JaxKM
    from oryx_tpu.common.config import load_config as jax_load
    from oryx_tpu_torch.apps.seq.batch import SeqUpdate
    from oryx_tpu_torch.apps.seq.state import apply_seq_update

    lines = _train_lines()
    if direction == "jax-to-port":
        up = JaxUpdate(jax_load(overlay=_seq_overlay()))
        model = up.build_model([JaxKM(None, l) for l in lines], {"dim": 8, "lr": 0.5})
        apply_to = apply_seq_update
    else:
        up = SeqUpdate(load_config(overlay=_seq_overlay()), device=CPU)
        model = up.build_model(_kms(lines), {"dim": 8, "lr": 0.5})
        apply_to = jax_apply
    sent = _published(up, model, tmp_path)
    assert sent[0][0] == "MODEL" and any(k == "UP" for k, _ in sent)
    st = None
    for key, msg in sent:
        st = apply_to(st, key, msg)
    ids = model.get_extension_list("ItemIDs")
    assert st.fraction_loaded() == 1.0 and st.dim == 8 and st.window == 4
    got, have = st.items.get_many(ids)
    assert have.all()
    # the UP codec rounds to 6 decimals
    np.testing.assert_allclose(got, np.asarray(model.tensors["E"]), atol=1e-6, rtol=0)
    for name in ("Wx", "Wh", "b"):
        np.testing.assert_array_equal(st.params[name], np.asarray(model.tensors[name]))


def test_jax_snapshot_resumes_and_second_generation_publishes_alike(tmp_path):
    """Generation 1 in the JAX package leaves an aggregate snapshot; each
    package's fresh SeqUpdate resumes it (the fingerprint
    seq:v1:w{window}:cap{cap} is shared) and runs the incremental second
    generation from the same previous weights. The window adds no new
    item, its examples fit one full batch and the probe is every row, so
    the warm builds agree: the same epochs, ids and extensions, weights
    within 1e-4, UP rows within 1e-4."""
    from oryx_tpu.apps.seq.batch import SeqUpdate as JaxUpdate
    from oryx_tpu.bus.api import KeyMessage as JaxKM
    from oryx_tpu.common.config import load_config as jax_load
    from oryx_tpu_torch.apps.seq.batch import SeqUpdate
    from oryx_tpu_torch.apps.seq.state import apply_seq_update

    lines = _train_lines()
    second = [f"u{s % 7},s{s},i{(s + t) % 20},{900_000 + s * 10 + t}"
              for s in range(40, 52) for t in range(4)]
    ts1, ts2 = 1_700_000_000_000, 1_700_000_060_000
    gen1 = tmp_path / "gen1"
    jup = JaxUpdate(jax_load(overlay=_seq_overlay(gen1)))
    train = [JaxKM(None, l) for l in lines]
    model = jup.build_model(train, {"dim": 8, "lr": 0.5})
    jup.after_full_build(ts1, train, [], model)
    jup.finalize_generation(ts1)

    published, updates = {}, {}
    for name, load, make, km in (
        ("jax", jax_load, lambda c: JaxUpdate(c), JaxKM),
        ("port", load_config, lambda c: SeqUpdate(c, device=CPU), KeyMessage),
    ):
        data = tmp_path / f"data-{name}"
        shutil.copytree(gen1, data)
        up = make(load(overlay=_seq_overlay(data)))
        assert up._load_snapshot() is not None, name
        up._prev_item_ids = model.get_extension_list("ItemIDs")
        up._prev_e = np.asarray(model.tensors["E"])
        up._prev_params = {k: np.asarray(model.tensors[k]) for k in ("Wx", "Wh", "b")}
        out = _Collect()
        assert up.incremental_update(
            ts2, [km(None, l) for l in second], str(tmp_path / f"model-{name}"), out)
        published[name], updates[name] = out.sent, up
    assert updates["jax"]._m_epochs.value() == updates["port"]._m_epochs.value()
    assert [k for k, _ in published["jax"]] == [k for k, _ in published["port"]]
    states = {n: None for n in published}
    for n, sent in published.items():
        for key, msg in sent:
            states[n] = apply_seq_update(states[n], key, msg)
    sj, sp = states["jax"], states["port"]
    assert sorted(sj.items.ids()) == sorted(sp.items.ids())
    assert sj.window == sp.window == 4
    for k in ("Wx", "Wh", "b"):
        np.testing.assert_allclose(sp.params[k], sj.params[k], atol=1e-4, rtol=0)
    ids = sj.items.ids()
    np.testing.assert_allclose(sp.items.get_many(ids)[0], sj.items.get_many(ids)[0],
                               atol=1e-4, rtol=0)
    assert not np.allclose(sp.items.get_many(ids)[0],
                           np.asarray(model.tensors["E"]), atol=1e-3)


# ---- the lambda slice (tests/test_e2e_seq.py) -------------------------------

def _chain_sessions(n_sessions=80, chains=4, chain_len=5, events_per=6, seed=0):
    rng = np.random.default_rng(seed)
    lines = []
    for s in range(n_sessions):
        g = s % chains
        base = g * chain_len
        it = base + int(rng.integers(0, chain_len))
        for t in range(events_per):
            lines.append(f"u{s % 10},s{s},i{it},{1000 + s * 100 + t}")
            it = base + (it - base + 1) % chain_len
    return lines


def _e2e_cfg(tmp_path, name, **extra):
    overlay = {
        "oryx.id": name,
        "oryx.input-topic.broker": f"mem://{name}",
        "oryx.update-topic.broker": f"mem://{name}",
        "oryx.batch.storage.data-dir": str(tmp_path / "data"),
        "oryx.batch.storage.model-dir": str(tmp_path / "model"),
        "oryx.monitoring.quarantine.dir": str(tmp_path / "quarantine"),
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.api.port": 0,
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common",
            "oryx_tpu_torch.serving.resources.seq",
        ],
        "oryx.seq.hyperparams.dim": 16,
        "oryx.seq.hyperparams.epochs": 12,
        "oryx.speed.streaming.generation-interval-sec": 1,
        "oryx.ml.eval.test-fraction": 0.1,
        "oryx.serving.min-model-load-fraction": 1.0,
    }
    overlay.update(extra)
    topics.maybe_create(f"mem://{name}", "OryxInput", partitions=2)
    topics.maybe_create(f"mem://{name}", "OryxUpdate", partitions=1)
    return load_config(overlay=overlay)


def _poll(fn, what: str, timeout: float = 30.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.1)
    raise AssertionError(what)


def test_full_seq_lambda_slice(tmp_path):
    from oryx_tpu_torch.apps.seq.batch import SeqUpdate
    from oryx_tpu_torch.apps.seq.serving import SeqServingModelManager
    from oryx_tpu_torch.apps.seq.speed import SeqSpeedModelManager
    from oryx_tpu_torch.layers import BatchLayer, SpeedLayer
    from oryx_tpu_torch.serving.server import ServingLayer

    RandomManager.use_test_seed(99)
    cfg = _e2e_cfg(tmp_path, "e2e-seq")
    broker = get_broker("mem://e2e-seq")
    serving = ServingLayer(cfg, model_manager=SeqServingModelManager(cfg, device=CPU))
    serving.start()
    speed = None
    try:
        base = f"http://127.0.0.1:{serving.port}"
        assert _http("GET", f"{base}/ready")[0] == 503
        lines = _chain_sessions()
        status, resp = _http("POST", f"{base}/ingest", body="\n".join(lines).encode())
        assert status == 200 and json.loads(resp)["ingested"] == len(lines)

        gen1 = 1_700_000_000_000
        batch = BatchLayer(cfg, update=SeqUpdate(cfg, device=CPU))
        batch.ensure_streams()
        batch._consumer._fetch_pos = {p: 0 for p in batch._consumer._fetch_pos}
        assert batch.run_generation(timestamp_ms=gen1) == len(lines)
        recs = broker.read("OryxUpdate", 0, 0, 10)
        assert recs[0][1] == "MODEL" and json.loads(recs[0][2])["app"] == "seq"
        _poll(lambda: _http("GET", f"{base}/ready")[0] == 200, "never ready")

        status, resp = _http("GET", f"{base}/console")
        assert status == 200 and "Seq next-item model" in resp
        status, resp = _http("GET", f"{base}/recommend-next/i0/i1?howMany=5")
        assert status == 200, resp
        recs5 = json.loads(resp)
        assert len(recs5) == 5 and recs5[0][0] == "i2", recs5
        assert not ({"i0", "i1"} & {r[0] for r in recs5})
        status, resp = _http("GET", f"{base}/recommend-next/i0?howMany=2",
                             accept="text/csv")
        assert status == 200 and len(resp.strip().splitlines()) == 2 and "," in resp
        assert _http("GET", f"{base}/recommend-next/unknownitem")[0] == 404
        assert _http("GET", f"{base}/recommend-next/i0?howMany=0")[0] == 400

        def generation():
            return json.loads(_http("GET", f"{base}/healthz")[1]).get("model_generation")

        _poll(lambda: generation() == gen1, "generation 1 never served")
        more = [f"u1,s100,i{j},{2_000_000 + j}" for j in (0, 1, 2, 3)]
        assert _http("POST", f"{base}/event", body="\n".join(more).encode())[0] == 200
        delta_counter = get_registry().counter("oryx_batch_incremental_total")
        deltas_before = delta_counter.value(kind="delta")
        gen2 = gen1 + 60_000
        assert batch.run_generation(timestamp_ms=gen2) == len(more)
        assert delta_counter.value(kind="delta") == deltas_before + 1
        batch.close()
        _poll(lambda: generation() == gen2, "generation 2 never served")

        speed = SpeedLayer(cfg, manager=SeqSpeedModelManager(cfg, device=CPU))
        speed.start()
        _poll(lambda: speed.manager.state is not None
              and speed.manager.state.fraction_loaded() >= 0.8, "speed never loaded")
        up_end_before = broker.end_offsets("OryxUpdate")[0]
        fold = ["u9,snew,i2,5000000", "u9,snew,iNEWCLICK,5000001"]
        assert _http("POST", f"{base}/event", body="\n".join(fold).encode())[0] == 200

        def new_item_served():
            status, resp = _http("GET", f"{base}/recommend-next/i2?howMany=8")
            return status == 200 and any(i == "iNEWCLICK" for i, _ in json.loads(resp))

        _poll(new_item_served, "speed fold-in never reached serving")
        new_recs = broker.read("OryxUpdate", 0, up_end_before, 1000)
        assert new_recs and all(k == "UP" for _, k, _ in new_recs)
        assert all(len(m) < 2048 for _, _, m in new_recs)
        assert get_registry().counter("oryx_seq_sessions_folded_total").value() >= 1
    finally:
        if speed is not None:
            speed.close()
        serving.close()


def test_seq_serving_read_only_mode(tmp_path):
    from oryx_tpu_torch.apps.seq.serving import SeqServingModelManager
    from oryx_tpu_torch.serving.server import ServingLayer

    cfg = _e2e_cfg(tmp_path, "e2e-seq-ro", **{"oryx.serving.api.read-only": True})
    serving = ServingLayer(cfg, model_manager=SeqServingModelManager(cfg, device=CPU))
    serving.start()
    try:
        base = f"http://127.0.0.1:{serving.port}"
        assert _http("POST", f"{base}/event", body=b"u1,s1,i1,1000")[0] == 405
    finally:
        serving.close()


# ---- the registry and the CLI ------------------------------------------------

def test_spi_registers_seq():
    import importlib

    from oryx_tpu_torch.apps import spi
    from oryx_tpu_torch.common.classutil import load_class

    spec = spi.get_app("seq")
    overlay = spi.app_overlay("seq")
    assert overlay["oryx.batch.update-class"] == "oryx_tpu_torch.apps.seq.batch.SeqUpdate"
    for mod in spec.serving_resources:
        assert mod.startswith("oryx_tpu_torch.")
        assert hasattr(importlib.import_module(mod), "register")
    cfg = load_config(overlay=overlay)
    for dotted in (spec.batch_update, spec.speed_manager, spec.serving_manager):
        assert dotted.startswith("oryx_tpu_torch.")
        load_class(dotted)(cfg, device=CPU)


def test_seq_classes_from_config_resolve_cuda(monkeypatch):
    """Built from config alone (as the layers and the CLI build them) each
    class resolves the card, and raises where there is none."""
    import torch

    from oryx_tpu_torch.apps import spi
    from oryx_tpu_torch.common.classutil import load_class

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = spi.get_app("seq")
    cfg = load_config(overlay=spi.app_overlay("seq"))
    for dotted in (spec.batch_update, spec.speed_manager, spec.serving_manager):
        with pytest.raises(RuntimeError, match="CUDA"):
            load_class(dotted)(cfg)


@pytest.mark.parametrize("command", ["batch", "speed", "serving"])
def test_cli_app_seq_overlays_the_port_classes(command, monkeypatch):
    """The port twin of tests/test_cli.py's ``--app seq`` overlay: every
    layer's command gets the seq classes and resources, and an explicit
    --set still wins."""
    from oryx_tpu_torch import cli

    seen = {}
    monkeypatch.setattr(cli, f"cmd_{command}", lambda config, *_: seen.setdefault("cfg", config) and 0)
    cli.main([command, "--app", "seq"])
    cfg = seen["cfg"]
    assert cfg.get_string("oryx.batch.update-class") == \
        "oryx_tpu_torch.apps.seq.batch.SeqUpdate"
    assert cfg.get_string("oryx.speed.model-manager-class") == \
        "oryx_tpu_torch.apps.seq.speed.SeqSpeedModelManager"
    assert cfg.get_string("oryx.serving.model-manager-class") == \
        "oryx_tpu_torch.apps.seq.serving.SeqServingModelManager"
    assert "oryx_tpu_torch.serving.resources.seq" in \
        cfg.get_list("oryx.serving.application-resources")
    seen.clear()
    cli.main([command, "--app", "seq", "--set", "oryx.batch.update-class=custom.Update"])
    assert seen["cfg"].get_string("oryx.batch.update-class") == "custom.Update"
