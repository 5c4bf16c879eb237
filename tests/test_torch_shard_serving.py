"""Sharded serving views of the port (tests/test_shard_serving.py's
contracts on port objects, on the CPU): owning-shard delta sync, per-shard
sync-byte accounting, sharded answers equal to unsharded ones, and the
batch layer's shard mesh reached through config. The same stores go
through the JAX package's sharded models, whose answers the port's must
name the same items."""

from __future__ import annotations

import time

import numpy as np
import pytest

from oryx_tpu_torch.apps.als.serving import ALSServingModel, SyncConfig
from oryx_tpu_torch.apps.als.state import ALSState
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.ops.transfer import (
    QuantizedMatrix,
    ShardedMatrix,
    quantized_scatter_bytes,
    scatter_transfer_bytes,
)

CPU = "cpu"


def _fill(st, n, k, rng):
    st.y.bulk_set(
        [f"i{j}" for j in range(n)],
        rng.standard_normal((n, k)).astype(np.float32),
    )
    st.x.bulk_set(["u0"], rng.standard_normal((1, k)).astype(np.float32))
    st.set_expected(["u0"], [f"i{j}" for j in range(n)])
    return st


def _als_model(n=64, k=8, seed=2, **kw):
    st = _fill(ALSState(k, implicit=True), n, k, np.random.default_rng(seed))
    return st, ALSServingModel(st, device=CPU, **kw)


def _wait_delta(model, timeout=10.0):
    q = np.ones(model.state.features, dtype=np.float32)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if ((model.served_version() or -1) >= model.state.y.get_version()
                and (model.last_resync or {}).get("kind") == "delta"):
            return True
        model.top_n(q, 3)
        time.sleep(0.01)
    return False


def _shard_bytes(reg, n_shards):
    c = reg.counter("oryx_device_sync_bytes")
    return {s: c.value(shard=f"s{s}") for s in range(n_shards)}


def test_sharded_view_full_build_splits_bytes_evenly():
    reg = get_registry()
    before = _shard_bytes(reg, 2)
    st, model = _als_model(sync=SyncConfig(shard_count=2))
    try:
        model.top_n(np.ones(8, dtype=np.float32), 5)
        y_dev = model._device_view[0]
        assert isinstance(y_dev, ShardedMatrix) and y_dev.n_shards == 2
        after = _shard_bytes(reg, 2)
        moved = {s: after[s] - before[s] for s in after}
        full = 64 * 8 * 2  # bf16 live rows
        assert moved[0] + moved[1] == full
        assert moved[0] == moved[1]
        g = reg.gauge("oryx_shard_rows")
        assert g.value(shard="s0") + g.value(shard="s1") == 64
    finally:
        model.close()


def test_sharded_delta_moves_only_owning_shard_fraction():
    reg = get_registry()
    st, model = _als_model(n=1000, sync=SyncConfig(shard_count=2))
    try:
        q = np.ones(8, dtype=np.float32)
        model.top_n(q, 5)
        before = _shard_bytes(reg, 2)
        st.y.set("i0", (q * 50).astype(np.float32))  # global row 0: shard 0
        assert _wait_delta(model)
        lr = model.last_resync
        after = _shard_bytes(reg, 2)
        moved = {s: after[s] - before[s] for s in after}
        one_row = scatter_transfer_bytes(1, 2, 8)
        assert moved == {0: one_row, 1: 0.0}
        assert lr["shard_bytes"] == {0: one_row}
        assert model.top_n(q, 5)[0][0] == "i0"
        assert model._device_view[0].plan.owner(0) == 0
    finally:
        model.close()


def test_sharded_answers_identical_to_unsharded():
    """Same store, unsharded and 4-sharded, in the port and the JAX
    package: the port's two models give identical answers (values too),
    and the JAX package's sharded model names the same items."""
    from oryx_tpu.apps.als.serving import (
        ALSServingModel as JaxModel, SyncConfig as JaxSync,
    )
    from oryx_tpu.apps.als.state import ALSState as JaxState

    st1, unsharded = _als_model(n=100, seed=5)
    st2, sharded = _als_model(n=100, seed=5, sync=SyncConfig(shard_count=4))
    jst = _fill(JaxState(8, implicit=True), 100, 8, np.random.default_rng(5))
    jax_sharded = JaxModel(jst, sync=JaxSync(shard_count=4))
    try:
        rng = np.random.default_rng(9)
        for _ in range(5):
            q = rng.standard_normal(8).astype(np.float32)
            for cosine in (False, True):
                a = unsharded.top_n(q, 10, cosine=cosine)
                b = sharded.top_n(q, 10, cosine=cosine)
                assert a == b
                j = jax_sharded.top_n(q, 10, cosine=cosine)
                assert [p[0] for p in b] == [p[0] for p in j]
                np.testing.assert_allclose(
                    [p[1] for p in b], [p[1] for p in j], rtol=1e-5, atol=1e-6)
    finally:
        unsharded.close()
        sharded.close()
        jax_sharded.close()


def test_sharded_quantized_delta_requantizes_shard_locally():
    st, model = _als_model(
        n=40, sync=SyncConfig(shard_count=2), score_mode="quantized"
    )
    try:
        q = np.ones(8, dtype=np.float32)
        model.top_n(q, 5)
        model.top_n(q, 5, cosine=True)  # materialize the unit view
        y_dev = model._device_view[0]
        assert isinstance(y_dev, ShardedMatrix)
        assert all(isinstance(s, QuantizedMatrix) for s in y_dev.shards)
        shard1_q_before = y_dev.shards[1].q.clone()
        st.y.set("i1", (q * 30).astype(np.float32))  # shard 0
        assert _wait_delta(model)
        y_new = model._device_view[0]
        assert y_new.shards[1] is y_dev.shards[1]
        assert y_new.shards[1].q.equal(shard1_q_before)
        # the unit view keeps sharing the device view's int8 rows per shard
        uv = model._unit_view
        assert uv is not None and uv[2] == model._device_view[2]
        assert uv[0].shards[0].q is y_new.shards[0].q
        assert model.last_resync["shard_bytes"] == {
            0: quantized_scatter_bytes(1, 8) + scatter_transfer_bytes(1, 4, 1)
        }
        assert model.top_n(q, 5)[0][0] == "i1"
    finally:
        model.close()


def _whole(view):
    """The logical matrix of a device view, shard rows in order: (rows,)
    or (int8 rows, scales)."""
    import torch

    shards = view.shards if isinstance(view, ShardedMatrix) else [view]
    if isinstance(shards[0], QuantizedMatrix):
        return (torch.cat([s.q for s in shards]),
                torch.cat([s.scale for s in shards]))
    return (torch.cat(list(shards)),)


@pytest.mark.parametrize("score_mode", ["exact", "quantized"])
def test_one_delta_path_for_sharded_and_unsharded_views(score_mode):
    """The delta is written once, per shard (the unsharded view is the
    one-shard case): the same dirty rows in two shards plus appended rows,
    with the cosine view materialized, leave the 3-sharded and the
    unsharded model answering identically, both views equal to a full
    rebuild, and the int8 unit view still sharing each shard's rows."""
    models = [
        _als_model(n=90, seed=4, score_mode=score_mode,
                   sync=SyncConfig(shard_count=c))
        for c in (1, 3)
    ]
    try:
        q = np.ones(8, dtype=np.float32)
        for _, m in models:
            m.top_n(q, 5)
            m.top_n(q, 5, cosine=True)
        rng = np.random.default_rng(8)
        upd = rng.standard_normal((4, 8)).astype(np.float32)
        for st, m in models:
            st.y.set("i1", upd[0])      # shard 0
            st.y.set("i70", upd[1])     # shard 2
            st.y.set("new0", upd[2])    # appended: the last shard
            st.y.set("new1", upd[3])
            assert _wait_delta(m)
            assert m.last_resync["rows"] == 4
        (_, one), (_, three) = models
        sm = three._device_view[0]
        assert sm.plan.bounds == (0, 30, 60, 92)
        if score_mode == "quantized":
            for y_s, u_s in zip(sm.shards, three._unit_view[0].shards):
                assert u_s.q is y_s.q
        assert set(three.last_resync["shard_bytes"]) == {0, 2}
        for trial in range(4):
            x = rng.standard_normal(8).astype(np.float32)
            for cosine in (False, True):
                assert one.top_n(x, 12, cosine=cosine) == three.top_n(
                    x, 12, cosine=cosine)
        for _, m in models:
            delta_views = (m._device_view[0], m._unit_view[0])
            with m._sync_lock:
                m._build_views_full()
            full_views = (m._device_view[0], m._unit_view[0])
            for j, (got, want) in enumerate(zip(delta_views, full_views)):
                got, want = _whole(got), _whole(want)
                if score_mode == "quantized" or j == 0:
                    assert all(a.equal(b) for a, b in zip(got, want))
                else:
                    # a delta normalizes the f32 rows, a full build the
                    # bf16 view's rows: one bf16 rounding apart
                    np.testing.assert_allclose(
                        got[0].float().numpy(), want[0].float().numpy(),
                        rtol=2.0 ** -7, atol=0)
    finally:
        for _, m in models:
            m.close()


def test_als_update_shard_mesh_reachable_through_config(tmp_path, monkeypatch):
    """oryx.batch.train.shards reaches the trainer as a model-axis mesh,
    clamped to the devices that exist; an explicit tensor-parallel mesh
    wins over it; shards <= 1 is never a mesh."""
    import oryx_tpu_torch.parallel.shardspec as shardspec
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.parallel.mesh import MODEL_AXIS, MeshSpec, make_mesh

    cfg = load_config(overlay={
        "oryx.id": "shardwire",
        "oryx.batch.storage.model-dir": str(tmp_path / "m"),
        "oryx.batch.train.shards": 2,
        "oryx.als.hyperparams.features": 4,
    })
    # one device: the shard count clamps to it and trains unsharded
    assert ALSUpdate(cfg, device=CPU)._shard_mesh() is None
    # eight devices, as the JAX package's tests have
    monkeypatch.setattr(shardspec, "local_devices",
                        lambda platform=None: [shardspec.torch.device(CPU)] * 8)
    upd = ALSUpdate(cfg, device=CPU)
    sm = upd._shard_mesh()
    assert sm is not None and sm.shape[MODEL_AXIS] == 2
    tp_mesh = make_mesh(MeshSpec(data=4, model=2), [CPU] * 8)
    assert ALSUpdate(cfg, device=CPU, mesh=tp_mesh)._shard_mesh() is None
    cfg1 = load_config(overlay={
        "oryx.id": "shardwire1",
        "oryx.batch.storage.model-dir": str(tmp_path / "m1"),
        "oryx.als.hyperparams.features": 4,
    })
    assert ALSUpdate(cfg1, device=CPU)._shard_mesh() is None


def test_seq_sharded_view_builds_and_deltas():
    from oryx_tpu_torch.apps.seq.serving import SeqServingModel
    from oryx_tpu_torch.apps.seq.state import SeqState

    rng = np.random.default_rng(3)
    n, d = 50, 8
    st = SeqState(dim=d, window=8)
    st.params = {
        "Wx": rng.standard_normal((d, 3 * d)).astype(np.float32) * 0.1,
        "Wh": rng.standard_normal((d, 3 * d)).astype(np.float32) * 0.1,
        "b": np.zeros(3 * d, dtype=np.float32),
    }
    st.items.bulk_set(
        [f"i{j}" for j in range(n)],
        rng.standard_normal((n, d)).astype(np.float32),
    )
    model = SeqServingModel(st, sync=SyncConfig(shard_count=2), device=CPU)
    out = model.next_items(["i1", "i2"], 5)
    assert out and len(out) == 5
    view = model._device_view[0]
    assert isinstance(view, ShardedMatrix)
    # growth and an update route through the owning shard
    st.items.set("i3", rng.standard_normal(d).astype(np.float32))
    st.items.set("new", rng.standard_normal(d).astype(np.float32))
    out2 = model.next_items(["i1", "i2"], 5)
    assert out2 and len(out2) == 5
    grown = model._device_view[0]
    assert grown.shape[0] == n + 1 and grown.plan.bounds[-2] == 25
    assert grown.shards[1].shape[0] == 26


@pytest.mark.parametrize("shards", [0, -1])
def test_sync_config_refuses_a_shard_count_below_one(shards):
    from oryx_tpu_torch.common.config import load_config

    with pytest.raises(ValueError, match="shard-count must be >= 1"):
        SyncConfig.from_config(load_config(overlay={
            "oryx.serving.api.sync.shard-count": shards}))
