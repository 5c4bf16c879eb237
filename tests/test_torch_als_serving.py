"""The ALS serving slice as a whole: the same model artifact (written by the
JAX package's ModelArtifact) and the same UP stream go to both packages'
ALSServingModelManager, and their top_n answers must agree -- identical ids,
scores within 1e-5. The port runs on the CPU, through the plain versions of
its kernels."""

from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from oryx_tpu.apps.als.serving import ALSServingModelManager as JManager
from oryx_tpu.common.artifact import ModelArtifact as JArtifact
from oryx_tpu.common.config import load_config as j_load_config
from oryx_tpu_torch.apps.als.serving import ALSServingModel, SyncConfig
from oryx_tpu_torch.apps.als.serving import ALSServingModelManager as PManager
from oryx_tpu_torch.apps.als.state import state_from_arrays
from oryx_tpu_torch.common.artifact import ModelArtifact as PArtifact
from oryx_tpu_torch.common.config import load_config as p_load_config
from oryx_tpu_torch.ops import topk as T

N_USERS, N_ITEMS, FEATURES = 40, 600, 12


def _artifact(tmp_path, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N_USERS, FEATURES)).astype(np.float32)
    y = rng.standard_normal((N_ITEMS, FEATURES)).astype(np.float32)
    x_ids = [f"u{j}" for j in range(N_USERS)]
    y_ids = [f"i{j}" for j in range(N_ITEMS)]
    known = {
        u: sorted({f"i{int(j)}" for j in rng.integers(0, N_ITEMS, size=6)})
        for u in x_ids[:10]
    }
    art = JArtifact("als", content={"knownItems": known},
                    tensors={"X": x, "Y": y})
    art.set_extension("features", str(FEATURES))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", x_ids)
    art.set_extension("YIDs", y_ids)
    path = tmp_path / "model"
    art.write(path)
    return str(path), art


def _managers(path, mode="exact"):
    overlay = {"oryx.serving.api.score-mode": mode}
    jm = JManager(j_load_config(overlay=overlay))
    pm = PManager(p_load_config(overlay=overlay), device="cpu")
    for m in (jm, pm):
        m.consume_key_message("MODEL-REF", path)
    return jm, pm


def _same(a, b):
    assert [i for i, _ in a] == [i for i, _ in b]
    np.testing.assert_allclose([s for _, s in a], [s for _, s in b],
                               atol=1e-5)


def _compare(jm, pm, users, how_many=10, cosine=False, exclude_known=False):
    for u in users:
        xu = jm.get_model().get_user_vector(u)
        assert np.array_equal(xu, pm.get_model().get_user_vector(u))
        excl = set()
        if exclude_known:
            excl = jm.get_model().state.get_known_items(u)
            assert excl == pm.get_model().state.get_known_items(u)
        got_j = jm.get_model().top_n(xu, how_many, exclude=excl,
                                     cosine=cosine)
        got_p = pm.get_model().top_n(xu, how_many, exclude=excl,
                                     cosine=cosine)
        assert len(got_p) == how_many
        _same(got_j, got_p)
        assert not excl & {i for i, _ in got_p}


def _wait_synced(*models):
    deadline = time.monotonic() + 20
    while time.monotonic() < deadline:
        if all(m.served_version() == m.state.y.get_version() for m in models):
            return
        for m in models:
            m.top_n(np.ones(FEATURES, dtype=np.float32), 1)  # observe drift
        time.sleep(0.02)
    raise AssertionError("delta resync never caught up")


def test_port_reads_the_jax_artifact(tmp_path):
    path, art = _artifact(tmp_path)
    got = PArtifact.read(path)
    assert got.app == art.app and got.extensions == art.extensions
    assert got.content == art.content
    for name in ("X", "Y"):
        assert np.array_equal(got.tensors[name], art.tensors[name])
    inline = PArtifact.from_string(art.to_string())
    assert np.array_equal(inline.tensors["Y"], art.tensors["Y"])


@pytest.mark.parametrize("mode", ["exact", "quantized", "approx"])
def test_top_n_matches_jax(tmp_path, mode):
    path, _ = _artifact(tmp_path, seed=1)
    jm, pm = _managers(path, mode)
    try:
        users = [f"u{j}" for j in range(0, N_USERS, 3)]
        _compare(jm, pm, users)
        _compare(jm, pm, users[:5], exclude_known=True)
        _compare(jm, pm, users[:5], how_many=3, cosine=True)
    finally:
        jm.close()
        pm.close()


@pytest.mark.parametrize("mode", ["exact", "quantized"])
def test_top_n_matches_jax_after_delta_resync(tmp_path, mode):
    path, _ = _artifact(tmp_path, seed=2)
    jm, pm = _managers(path, mode)
    try:
        users = ["u0", "u4", "u9"]
        _compare(jm, pm, users)
        _compare(jm, pm, users, how_many=4, cosine=True)  # build unit views
        rng = np.random.default_rng(9)
        probe = jm.get_model().get_user_vector("u4")
        msgs = []
        for j in range(30):
            vec = rng.standard_normal(FEATURES)
            msgs.append(json.dumps(["Y", f"i{j * 7}", [float(v) for v in vec]]))
        # a new item that must become u4's best answer
        star = 5.0 * probe / np.linalg.norm(probe)
        msgs.append(json.dumps(["Y", "new-star", [float(v) for v in star]]))
        for msg in msgs:
            jm.consume_key_message("UP", msg)
            pm.consume_key_message("UP", msg)
        _wait_synced(jm.get_model(), pm.get_model())
        # the port's view went through the delta path (the JAX package's
        # own resync thread may race the message storm into a full rebuild,
        # which does not change its answers)
        assert pm.get_model().last_resync["kind"] == "delta"
        assert pm.get_model().top_n(probe, 1)[0][0] == "new-star"
        _compare(jm, pm, users)
        _compare(jm, pm, users, how_many=4, cosine=True)
    finally:
        jm.close()
        pm.close()


@pytest.mark.parametrize("mode", ["full", "blocking"])
def test_other_sync_modes_serve_new_rows(tmp_path, mode):
    path, _ = _artifact(tmp_path, seed=3)
    pm = PManager(p_load_config(overlay={"oryx.serving.api.sync.mode": mode}),
                  device="cpu")
    try:
        pm.consume_key_message("MODEL-REF", path)
        model = pm.get_model()
        probe = model.get_user_vector("u1")
        model.top_n(probe, 5)
        star = 5.0 * probe / np.linalg.norm(probe)
        pm.consume_key_message(
            "UP", json.dumps(["Y", "new-star", [float(v) for v in star]])
        )
        if mode == "full":
            _wait_synced(model)
            assert model.last_resync["kind"] == "full"
        assert model.top_n(probe, 1)[0][0] == "new-star"
    finally:
        pm.close()


def test_top_n_async_and_fold_in_match_jax(tmp_path):
    path, _ = _artifact(tmp_path, seed=4)
    jm, pm = _managers(path)
    try:
        xu = jm.get_model().get_user_vector("u2")
        fut = pm.get_model().top_n_async(xu, 7)
        _same(jm.get_model().top_n(xu, 7), fut.result(timeout=30))
        prefs = [("i3", 1.0), ("i50", 2.0), ("nope", 1.0), ("i77", -1.0)]
        v_j = jm.get_model().fold_in_user_vector(prefs)
        v_p = pm.get_model().fold_in_user_vector(prefs)
        np.testing.assert_allclose(v_p, v_j, atol=1e-5)
        assert pm.get_model().fold_in_user_vector([("nope", 1.0)]) is None
    finally:
        jm.close()
        pm.close()


class _DropEvenRescorer:
    """Filters items with an even number and halves the rest."""

    def is_filtered(self, item):
        return int(item[1:]) % 2 == 0

    def rescore(self, item, score):
        return score / 2.0


def test_other_query_methods_match_jax(tmp_path):
    path, _ = _artifact(tmp_path, seed=7)
    jm, pm = _managers(path)
    try:
        j, p = jm.get_model(), pm.get_model()
        assert p.dot("u3", "i11") == pytest.approx(j.dot("u3", "i11"), abs=1e-6)
        assert p.dot("u3", "nope") is None
        assert np.array_equal(p.get_item_vector("i8"), j.get_item_vector("i8"))
        np.testing.assert_allclose(p.cosine_to_items(["i1", "i2", "x"]),
                                   j.cosine_to_items(["i1", "i2", "x"]),
                                   atol=1e-6)
        assert p.most_popular_items(5) == j.most_popular_items(5)
        rs = _DropEvenRescorer()
        assert (p.most_popular_items(5, rescorer=rs)
                == j.most_popular_items(5, rescorer=rs))
        assert p.most_active_users(4) == j.most_active_users(4)
        assert p.representative_items(7) == j.representative_items(7)
        xu = j.get_user_vector("u6")
        _same(j.top_n(xu, 6, rescorer=rs), p.top_n(xu, 6, rescorer=rs))
    finally:
        jm.close()
        pm.close()


def test_state_from_arrays_matches_jax_snapshot(tmp_path):
    path, _ = _artifact(tmp_path, seed=5)
    jm, pm = _managers(path)
    try:
        js = jm.get_model().state
        x, x_ids, _ = js.x.snapshot()
        y, y_ids, _ = js.y.snapshot()
        state = state_from_arrays(js.features, js.implicit, x_ids,
                                  np.asarray(x), y_ids, np.asarray(y))
        assert state.fraction_loaded() == 1.0
        for store, (mat, ids) in ((state.x, (x, x_ids)), (state.y, (y, y_ids))):
            got, got_ids, _ = store.snapshot()
            assert got_ids == list(ids)
            assert np.array_equal(got, np.asarray(mat))
        model = ALSServingModel(state, sync=SyncConfig(), device="cpu")
        try:
            xu = js.x.get("u5")
            _same(jm.get_model().top_n(xu, 10), model.top_n(xu, 10))
        finally:
            model.close()
    finally:
        jm.close()
        pm.close()


@pytest.mark.parametrize("mode", ["exact", "quantized"])
def test_small_catalog_scores_live_rows_only(tmp_path, mode):
    # every score is negative, so a zero padding row would outrank every
    # real item: the device view must hold the live rows and no more, also
    # after a delta resync that appends a row
    rng = np.random.default_rng(11)
    n = 20
    y = -np.abs(rng.standard_normal((n, FEATURES))).astype(np.float32)
    x = np.abs(rng.standard_normal((2, FEATURES))).astype(np.float32)
    art = JArtifact("als", content={"knownItems": {}},
                    tensors={"X": x, "Y": y})
    art.set_extension("features", str(FEATURES))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", ["u0", "u1"])
    art.set_extension("YIDs", [f"i{j}" for j in range(n)])
    art.write(tmp_path / "model")
    jm, pm = _managers(str(tmp_path / "model"), mode)
    try:
        model = pm.get_model()
        _compare(jm, pm, ["u0", "u1"], how_many=n)
        assert model._device_view[0].shape[0] == n
        new = -0.01 * np.abs(rng.standard_normal(FEATURES))
        msg = json.dumps(["Y", "i-new", [float(v) for v in new]])
        for m in (jm, pm):
            m.consume_key_message("UP", msg)
        _wait_synced(jm.get_model(), model)
        assert model.last_resync["kind"] == "delta"
        assert model._device_view[0].shape[0] == n + 1
        _compare(jm, pm, ["u0", "u1"], how_many=n + 1)
        assert model.top_n(x[0], 1)[0][0] == "i-new"
    finally:
        jm.close()
        pm.close()


def test_serving_on_the_cpu_launches_no_kernel(tmp_path):
    path, _ = _artifact(tmp_path, seed=6)
    pm = PManager(p_load_config(), device="cpu")
    try:
        pm.consume_key_message("MODEL-REF", path)
        T.reset_launches()
        pm.get_model().top_n(np.ones(FEATURES, dtype=np.float32), 5)
        assert T.LAUNCHES == {"topk_dot_partial": 0, "topk_merge": 0}
        assert pm.get_model()._device_view[0].device == torch.device("cpu")
    finally:
        pm.close()


def _assert_pitched_view(view, want):
    # pitched item view (ops/transfer.py): shape [n, F], a row stride of a
    # 16-byte multiple, zero padding columns, the dense path's values
    n, f = want.shape
    assert tuple(view.shape) == (n, f)
    assert (view.stride(0) * view.element_size()) % 16 == 0
    assert view.stride(1) == 1 and view.data_ptr() % 16 == 0
    whole = view.as_strided((n, view.stride(0)), (view.stride(0), 1))
    assert torch.equal(whole[:, f:], torch.zeros_like(whole[:, f:]))
    assert torch.equal(view, want)


@pytest.mark.parametrize("mode", ["exact", "quantized"])
def test_served_views_are_pitched(tmp_path, mode):
    # the device view and the cosine view after a full build, then after a
    # delta that moves rows and appends one, match the JAX package's answers
    # and are pitched with the values the dense path would hold
    from oryx_tpu_torch.ops.transfer import quantize_rows_int8

    path, _ = _artifact(tmp_path, seed=6)
    jm, pm = _managers(path, mode)
    try:
        users = ["u1", "u5"]
        model = pm.get_model()
        for step in range(2):
            _compare(jm, pm, users)
            _compare(jm, pm, users, how_many=4, cosine=True)
            y, ids, _v, host = model._device_view
            mat = host[:len(ids)]
            unit = model._unit_view[0]
            if mode == "quantized":
                _assert_pitched_view(y.q, torch.from_numpy(quantize_rows_int8(mat)[0]))
                assert unit.q is y.q
            else:
                _assert_pitched_view(y, torch.from_numpy(mat).to(torch.bfloat16))
                # a full build normalizes the bf16 rows; a delta writes its
                # dirty rows normalized from the f32 store
                yf = y.float()
                norms = torch.clamp(torch.linalg.norm(yf, dim=1, keepdim=True),
                                    min=1e-12)
                want = (yf / norms).to(torch.bfloat16)
                dirty = [3, 77, N_ITEMS] if step else []
                m = mat[dirty]
                want[dirty] = torch.from_numpy(
                    m / np.maximum(np.linalg.norm(m, axis=1), 1e-12)[:, None]
                ).to(torch.bfloat16)
                _assert_pitched_view(unit, want)
            if step == 0:
                rng = np.random.default_rng(11)
                for j in (3, 77):
                    vec = rng.standard_normal(FEATURES)
                    msg = json.dumps(["Y", f"i{j}", [float(v) for v in vec]])
                    jm.consume_key_message("UP", msg)
                    pm.consume_key_message("UP", msg)
                msg = json.dumps(["Y", "appended", [0.5] * FEATURES])
                jm.consume_key_message("UP", msg)
                pm.consume_key_message("UP", msg)
                _wait_synced(jm.get_model(), model)
                assert model.last_resync["kind"] == "delta"
                assert model._device_view[0].shape[0] == N_ITEMS + 1
    finally:
        jm.close()
        pm.close()
