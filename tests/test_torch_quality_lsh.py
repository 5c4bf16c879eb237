"""LSH candidate sampling, the live quality plane and the score-mode recall
gate of the port, against the JAX package's own contracts
(tests/test_lsh.py, tests/test_qualitystats.py but its `cli flight` and
chaos cases, which tests/test_torch_cli.py and tests/test_torch_fleet_chaos.py
hold, and tests/test_quality_gate.py::test_score_mode_recall_gate), the
fleet-front case of tests/test_score_modes.py, and side by side with the
JAX package on the same seeded inputs:

- LSH: with the same ``RandomManager`` test seed both packages draw the
  same hyperplanes and partitions, and their serving models give the same
  LSH ``top_n`` answers, with and without cosine, also after a delta that
  moves rows between partitions. Tolerance: exact (the same numpy
  operations on the same float32 inputs).
- Shadow sampler: the same offered samples (exact, wrong, with
  exclusions, cosine) give the same recall and margins, and the same
  live recall per mode, within 1e-6.
- Drift: the same TrainingProfile and events (under one fake clock) give
  the same drift gauges, within 1e-6.
- Recall gate: the port's ``evaluate_score_mode_recall(device="cpu")`` on
  the gate's corpus has the JAX package's quantized and approx recall.
  Both compute approx exactly off the TPU and the int8 dot is bit-exact;
  the only allowed difference is 1/(k * n_queries) for each query whose
  exact f32 top-k has a tie at its k-th place within accumulation order
  (32 f32 roundoffs per feature of the scores' scale, ``f32_tolerance``),
  and the test counts them.
"""

from __future__ import annotations

import json
import math
import time
from types import SimpleNamespace

import numpy as np
import pytest

import oryx_tpu.common.qualitystats as jqs
import oryx_tpu_torch.common.qualitystats as qmod
from oryx_tpu.apps.als.lsh import LocalitySensitiveHash as JaxLSH
from oryx_tpu.apps.als.serving import ALSServingModel as JaxServingModel
from oryx_tpu.apps.als.state import ALSState as JaxALSState
from oryx_tpu.common.config import load_config as jax_load_config
from oryx_tpu.common.rng import RandomManager as JaxRandomManager
from oryx_tpu_torch.apps.als.lsh import MAX_HASHES, LocalitySensitiveHash
from oryx_tpu_torch.apps.als.serving import ALSServingModel
from oryx_tpu_torch.apps.als.state import ALSState
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.qualitystats import (
    QualityStats,
    TrainingProfile,
    build_training_profile,
    sketch_of,
)
from oryx_tpu_torch.common.rng import RandomManager

PARITY_TOL = 1e-6


@pytest.fixture(autouse=True)
def _seed():
    RandomManager.use_test_seed(123)
    JaxRandomManager.use_test_seed(123)
    yield
    RandomManager.clear_test_seed()
    JaxRandomManager.clear_test_seed()


# ---- LSH: the JAX package's contracts ---------------------------------------


@pytest.mark.parametrize(
    "sample_rate,cores,hashes,bits",
    [
        (1.0, 1, 0, 0), (0.5, 1, 1, 0), (0.1, 1, 4, 0),
        (1.0, 2, 1, 1), (0.75, 3, 2, 1),
        (0.5, 3, 3, 1), (0.1, 8, 7, 1), (0.01, 8, 11, 1),
        (0.001, 8, 14, 1), (0.0001, 8, 16, 1), (0.00001, 8, MAX_HASHES, 1),
    ],
)
def test_hashes_bits_selection(sample_rate, cores, hashes, bits):
    lsh = LocalitySensitiveHash(sample_rate, 10, cores)
    assert lsh.num_hashes == hashes
    assert lsh.max_bits_differing == bits


def test_candidate_indices_no_sample():
    lsh = LocalitySensitiveHash(1.0, 10, 8)
    cands = lsh.candidate_indices(np.zeros(10, dtype=np.float32))
    assert len(cands) == lsh.num_partitions
    assert np.array_equal(np.sort(cands), np.arange(lsh.num_partitions))


def test_candidate_indices_one_bit():
    lsh = LocalitySensitiveHash(0.1, 10, 8)
    assert lsh.max_bits_differing == 1
    zero = lsh.candidate_indices(np.zeros(10, dtype=np.float32))
    assert len(zero) == 1 + lsh.num_hashes
    assert zero[0] == 0
    assert sorted(zero[1:]) == [1 << i for i in range(lsh.num_hashes)]
    one = lsh.candidate_indices(np.ones(10, dtype=np.float32))
    main = one[0]
    assert sorted(c ^ main for c in one[1:]) == [1 << i for i in range(lsh.num_hashes)]


def test_candidate_count_within_sample_rate_budget():
    for rate in (0.5, 0.1, 0.01):
        lsh = LocalitySensitiveHash(rate, 10, 1)
        cands = lsh.candidate_indices(np.ones(10, dtype=np.float32))
        assert len(cands) <= max(1, rate * lsh.num_partitions) + 1e-9


def test_hash_distribution_roughly_uniform():
    lsh = LocalitySensitiveHash(0.1, 40, 8)
    vecs = np.random.default_rng(7).standard_normal((2000, 40)).astype(np.float32)
    parts = lsh.indices_for(vecs)
    assert parts.min() >= 0 and parts.max() < lsh.num_partitions
    assert len(np.unique(parts)) > lsh.num_partitions // 4


def test_indices_for_matches_index_for():
    lsh = LocalitySensitiveHash(0.1, 16, 8)
    vecs = np.random.default_rng(3).standard_normal((64, 16)).astype(np.float32)
    assert [lsh.index_for(v) for v in vecs] == list(lsh.indices_for(vecs))


def test_candidate_partitions_contain_similar_vectors():
    lsh = LocalitySensitiveHash(0.1, 32, 8)
    rng = np.random.default_rng(11)
    hits = 0
    for _ in range(200):
        v = rng.standard_normal(32).astype(np.float32)
        w = v + 0.05 * rng.standard_normal(32).astype(np.float32)
        if lsh.index_for(w) in set(lsh.candidate_indices(v)):
            hits += 1
    assert hits > 150


def test_serving_topn_with_lsh_approximates_exact():
    rng = np.random.default_rng(5)
    features = 16
    state = ALSState(features=features, implicit=True)
    for i in range(500):
        state.y.set(f"I{i}", rng.standard_normal(features).astype(np.float32))
    exact = ALSServingModel(state, device="cpu")
    approx = ALSServingModel(state, sample_rate=0.5, num_cores=4, device="cpu")
    try:
        user = rng.standard_normal(features).astype(np.float32)
        top_exact = [i for i, _ in exact.top_n(user, 10)]
        top_approx = [i for i, _ in approx.top_n(user, 10)]
        assert len(top_approx) == 10
        assert len(set(top_exact) & set(top_approx)) >= 5
        for ident, v in dict(approx.top_n(user, 10)).items():
            np.testing.assert_allclose(
                v, float(state.y.get(ident) @ user), rtol=1e-4, atol=1e-4)
        # the LSH model scores on the host: it built no device view
        assert approx._device_view is None
    finally:
        exact.close()
        approx.close()


def test_representative_items_one_per_partition():
    rng = np.random.default_rng(9)
    state = ALSState(features=8, implicit=True)
    for i in range(200):
        state.y.set(f"I{i}", rng.standard_normal(8).astype(np.float32))
    model = ALSServingModel(state, sample_rate=0.1, num_cores=4, device="cpu")
    reps = model.representative_items(50)
    assert 0 < len(reps) <= 50
    _lsh, ids, parts, _pindex = model._lsh_index()
    part_of = {ids[i]: parts[i] for i in range(len(ids))}
    chosen = [part_of[r] for r in reps]
    assert len(set(chosen)) == len(chosen)


def test_lsh_max_bits_override():
    from oryx_tpu_torch.apps.als.common import ALSConfig

    with pytest.raises(ValueError, match="lsh-max-bits-differing"):
        ALSConfig.from_config(
            load_config(overlay={"oryx.als.lsh-max-bits-differing": -5}))
    with pytest.raises(ValueError, match="candidate-partitions"):
        ALSConfig.from_config(
            load_config(overlay={"oryx.als.candidate-partitions": -4}))
    auto = LocalitySensitiveHash(0.1, 8, num_cores=8)
    forced = LocalitySensitiveHash(0.1, 8, num_cores=8, max_bits_differing=0)
    assert forced.max_bits_differing == 0
    assert forced.num_hashes == auto.num_hashes
    wide = LocalitySensitiveHash(0.1, 8, num_cores=8, max_bits_differing=99)
    assert wide.max_bits_differing == wide.num_hashes  # clamped


# ---- LSH in both packages ----------------------------------------------------


@pytest.mark.parametrize("rate,cores,features", [(0.3, 8, 50), (0.1, 4, 16),
                                                 (0.5, 2, 8)])
def test_lsh_hyperplanes_and_partitions_equal_the_jax_package(
        rate, cores, features):
    port, jax = (LocalitySensitiveHash(rate, features, cores),
                 JaxLSH(rate, features, cores))
    np.testing.assert_array_equal(port.hash_vectors, jax.hash_vectors)
    assert port.max_bits_differing == jax.max_bits_differing
    vecs = np.random.default_rng(4).standard_normal((3000, features)).astype(np.float32)
    np.testing.assert_array_equal(port.indices_for(vecs), jax.indices_for(vecs))
    for v in vecs[:50]:
        np.testing.assert_array_equal(port.candidate_indices(v),
                                      jax.candidate_indices(v))


def _twin_models(n_items=3000, features=16, rate=0.3, cores=4):
    """The same factors in both packages' states, each behind an LSH
    serving model (delta sync mode); the LSH views are built under the
    same test seed."""
    rng = np.random.default_rng(31)
    y = rng.standard_normal((n_items, features)).astype(np.float32)
    ids = [f"i{j}" for j in range(n_items)]
    pstate, jstate = ALSState(features, True), JaxALSState(features, True)
    for st in (pstate, jstate):
        st.y.bulk_set(ids, y)
        st.set_expected([], ids)
    RandomManager.use_test_seed(77)
    JaxRandomManager.use_test_seed(77)
    port = ALSServingModel(pstate, sample_rate=rate, num_cores=cores,
                           device="cpu")
    jax = JaxServingModel(jstate, sample_rate=rate, num_cores=cores)
    port.build_views()
    jax._lsh_index()
    return port, jax, rng


def _same_partitions(port, jax) -> None:
    _pl, pids, pparts, pindex = port._lsh_index()
    _jl, jids, jparts, jindex = jax._lsh_index()
    assert pids == jids
    np.testing.assert_array_equal(pparts, jparts)
    for p in range(len(pindex.rows)):
        np.testing.assert_array_equal(pindex.rows[p], jindex.rows[p])
        np.testing.assert_array_equal(pindex.mats[p], jindex.mats[p])


def _same_answers(port, jax, users, how_many=10) -> None:
    for j, u in enumerate(users):
        exclude = {f"i{j}", f"i{j + 7}"} if j % 3 == 0 else frozenset()
        for cosine in (False, True):
            assert (port.top_n(u, how_many, exclude=exclude, cosine=cosine)
                    == jax.top_n(u, how_many, exclude=exclude, cosine=cosine))


def test_lsh_top_n_equals_the_jax_package_before_and_after_a_delta():
    port, jax, rng = _twin_models()
    try:
        assert port.fraction_loaded() == 1.0  # the partition view exists
        _same_partitions(port, jax)
        users = rng.standard_normal((40, 16)).astype(np.float32)
        _same_answers(port, jax, users)
        parts_before = port._lsh_index()[2].copy()
        # a delta: moved rows (negated vectors land in the opposite
        # partition) and new rows, then each package's resync
        moved = [f"i{j}" for j in range(0, 300, 3)]
        new_vecs = rng.standard_normal((20, 16)).astype(np.float32)
        for st in (port.state, jax.state):
            for ident in moved:
                st.y.set(ident, -st.y.get(ident))
            for j, v in enumerate(new_vecs):
                st.y.set(f"new{j}", v)
        assert port._resync_once() and jax._resync_once()
        assert port.last_resync["kind"] == jax.last_resync["kind"] == "delta"
        _same_partitions(port, jax)
        parts_after = port._lsh_index()[2]
        assert (parts_after[:len(parts_before)] != parts_before).sum() >= 50
        _same_answers(port, jax, users)
    finally:
        port.close()
        jax.close()


def test_lsh_shadow_samples_label_lsh(monkeypatch):
    """Every LSH answer without a rescorer is offered to the quality
    sampler as score mode "lsh", with a full-store reference."""
    offered = []
    monkeypatch.setattr(
        ALSServingModel, "_shadow_sample",
        lambda self, *a: offered.append(a))
    port, jax, rng = _twin_models(n_items=500)
    try:
        user = rng.standard_normal(16).astype(np.float32)
        pairs = port.top_n(user, 5)
        (vec, got, how_many, _excl, cosine, mode, _tid, snap), = offered
        assert got == pairs and mode == "lsh" and how_many == 5
        mat, ids, n = snap()
        assert n == 500 and mat.shape == (500, 16)
    finally:
        port.close()
        jax.close()


# ---- the quality plane: the JAX package's contracts --------------------------


def _qs(**overlay) -> QualityStats:
    cfg = load_config(overlay={
        "oryx.monitoring.quality.sample-rate": 1.0,
        "oryx.monitoring.quality.window-sec": 60,
        **overlay,
    })
    qs = QualityStats()
    qs.configure(cfg)
    return qs


def _corpus(n=64, f=8, seed=0):
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((n, f)).astype(np.float32)
    return mat, [f"i{j}" for j in range(n)]


def _served(mat, ids, vec, k=10):
    scores = mat @ vec
    order = np.argsort(-scores)[:k]
    return [(ids[int(j)], float(scores[j])) for j in order]


def test_shadow_sample_exact_answer_scores_recall_one():
    qs = _qs()
    mat, ids = _corpus()
    vec = np.random.default_rng(1).standard_normal(8).astype(np.float32)
    assert qs.maybe_sample(
        vec, _served(mat, ids, vec), how_many=10,
        score_mode="exact", snapshot_fn=lambda: (mat, ids, len(ids)))
    assert qs.flush(10)
    assert qs.live_recall() == pytest.approx(1.0)
    assert qs.live_recall("exact") == pytest.approx(1.0)
    assert math.isnan(qs.live_recall("quantized"))
    qs.close()


def test_shadow_sample_wrong_answer_counts_bad_and_margin():
    qs = _qs()
    mat, ids = _corpus()
    vec = np.random.default_rng(2).standard_normal(8).astype(np.float32)
    exact = _served(mat, ids, vec)
    worst = exact[-1][1] - 10.0
    wrong = [(i, worst) for i, _ in _served(mat, ids, -vec)]
    c_bad = get_registry().counter("oryx_quality_bad_samples_total")
    bad_before = sum(c_bad.series().values())
    qs.maybe_sample(vec, wrong, how_many=10, score_mode="quantized",
                    snapshot_fn=lambda: (mat, ids, len(ids)))
    assert qs.flush(10)
    assert qs.live_recall("quantized") < 0.5
    assert sum(c_bad.series().values()) == bad_before + 1
    assert get_registry().histogram("oryx_live_score_margin").count() >= 1
    qs.close()


def test_shadow_recall_respects_exclusions():
    qs = _qs()
    mat, ids = _corpus()
    vec = np.random.default_rng(3).standard_normal(8).astype(np.float32)
    full = _served(mat, ids, vec, k=14)
    exclude = {full[0][0], full[2][0]}
    served = [(i, s) for i, s in full if i not in exclude][:10]
    qs.maybe_sample(vec, served, how_many=10, exclude=exclude,
                    score_mode="exact",
                    snapshot_fn=lambda: (mat, ids, len(ids)))
    assert qs.flush(10)
    assert qs.live_recall() == pytest.approx(1.0)
    qs.close()


def test_saturated_queue_drops_samples_never_blocks():
    qs = _qs(**{"oryx.monitoring.quality.max-queue": 2})
    mat, ids = _corpus()
    vec = np.random.default_rng(4).standard_normal(8).astype(np.float32)
    served = _served(mat, ids, vec)
    drops = get_registry().counter("oryx_quality_sample_drops_total")
    before = drops.value()
    qs.drain_gate.set()  # park the drain: the burst must overflow
    try:
        t0 = time.monotonic()
        accepted = sum(
            qs.maybe_sample(vec, served, how_many=10,
                            snapshot_fn=lambda: (mat, ids, len(ids)))
            for _ in range(20))
        elapsed = time.monotonic() - t0
    finally:
        qs.drain_gate.clear()
    assert accepted <= 3
    assert drops.value() - before >= 17
    assert elapsed < 1.0
    assert qs.flush(10)
    qs.close()


def test_sampler_off_is_free():
    qs = _qs(**{"oryx.monitoring.quality.sample-rate": 0.0})
    mat, ids = _corpus()
    assert not qs.maybe_sample(
        np.zeros(8, np.float32), [("i0", 1.0)], how_many=10,
        snapshot_fn=lambda: (mat, ids, len(ids)))
    assert qs.samples_processed() == 0


def test_quality_families_openmetrics_roundtrip_with_exemplar():
    parser = pytest.importorskip("prometheus_client.openmetrics.parser")
    from oryx_tpu_torch.common import slo
    from oryx_tpu_torch.common.freshness import model_freshness

    qs = _qs()
    mat, ids = _corpus()
    vec = np.random.default_rng(5).standard_normal(8).astype(np.float32)
    qs.maybe_sample(vec, _served(mat, ids, vec), how_many=10,
                    score_mode="exact", trace_id="abc123def4567890",
                    snapshot_fn=lambda: (mat, ids, len(ids)))
    assert qs.flush(10)
    qs.note_catalog(ids)
    qs.set_training_profile(
        build_training_profile(ids, np.ones(len(ids)), scores=mat @ vec))
    qs.note_input_events(ids[:16], np.arange(16) * 1000)
    model_freshness()
    slo._sample_errors()
    text = get_registry().render_prometheus(openmetrics=True)
    families = {f.name: f for f in parser.text_string_to_metric_families(text)}
    for name in ("oryx_live_recall_at_k", "oryx_live_score_margin",
                 "oryx_quality_samples", "oryx_quality_bad_samples",
                 "oryx_quality_sample_drops", "oryx_input_drift",
                 "oryx_prediction_drift", "oryx_generation_quality",
                 "oryx_slo_sample_errors"):
        assert name in families, f"{name} missing from OpenMetrics page"
    exemplars = [
        s.exemplar for s in families["oryx_live_score_margin"].samples
        if s.name.endswith("_bucket") and s.exemplar is not None
    ]
    assert exemplars, "recall-margin histogram lost its trace exemplar"
    assert exemplars[0].labels["trace_id"] == "abc123def4567890"
    qs.close()


def test_training_profile_roundtrips_and_sketch_is_normalized():
    ids = [f"i{j}" for j in range(100)]
    p = build_training_profile(
        ids, np.arange(100) + 1.0,
        timestamps_ms=np.arange(1_000, 101_000, 1_000),
        prev_item_ids=ids[:50],
        scores=np.random.default_rng(0).standard_normal(64))
    q = TrainingProfile.from_json(p.to_json())
    assert q.events_per_sec == pytest.approx(p.events_per_sec)
    assert q.new_item_fraction == pytest.approx(0.5)
    assert q.score_mean == pytest.approx(p.score_mean)
    assert sum(q.item_sketch) == pytest.approx(1.0, abs=1e-3)
    assert sketch_of([]).sum() == 0.0


def test_drift_signals_move_with_distribution_shift(tmp_path):
    from oryx_tpu_torch.common import flightrec

    rec = flightrec.get_flightrec()
    rec.dir = str(tmp_path)
    rec.enabled = True
    with rec._lock:
        rec._last_episode.pop("drift-alarm", None)
    qs = _qs(**{"oryx.monitoring.quality.drift.alarm-threshold": 0.4})
    ids = [f"i{j}" for j in range(200)]
    qs.set_training_profile(
        build_training_profile(ids, np.ones(200), scores=np.zeros(8)))
    qs.note_catalog(ids)
    qs.note_input_events(ids)
    assert qs.input_drift("item-popularity") == pytest.approx(0.0, abs=0.05)
    assert qs.input_drift("new-item-fraction") == 0.0
    qs.note_input_events(["alien-hot"] * 400)
    assert qs.input_drift("item-popularity") > 0.4
    assert qs.input_drift("new-item-fraction") > 0.5
    events = [e for e in flightrec.read_events(str(tmp_path))
              if e.get("kind") == "drift-alarm"]
    assert events, "drift past the threshold recorded no drift-alarm"
    assert events[-1]["signal"].startswith(("input:", "prediction:"))


def test_drift_is_nan_without_profile_or_window():
    qs = _qs()
    assert math.isnan(qs.input_drift("item-popularity"))
    assert math.isnan(qs.prediction_drift("score-mean"))
    qs.set_training_profile(TrainingProfile(item_sketch=[1.0] * 4))
    assert math.isnan(qs.input_drift("item-popularity"))


def _profile_agg(n_u=12, n_i=20):
    from oryx_tpu_torch.ops.als import InteractionData

    rng = np.random.default_rng(0)
    return InteractionData(
        user_ids=[f"u{j}" for j in range(n_u)],
        item_ids=[f"i{j}" for j in range(n_i)],
        users=rng.integers(0, n_u, 100).astype(np.int32),
        items=rng.integers(0, n_i, 100).astype(np.int32),
        values=np.ones(100, np.float32),
    ), rng


def test_als_artifact_carries_profile_and_serving_adopts_it(monkeypatch):
    """ALSUpdate stamps qualityProfile into the artifact; the serving
    state's MODEL apply hands it to the live tracker — and the JAX
    package's serving state adopts the port's profile alike."""
    import oryx_tpu.apps.als.state as jstate
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.apps.als.state import apply_update_message

    upd = ALSUpdate(load_config(overlay={"oryx.id": "qprof"}), device="cpu")
    upd._window_tss = np.arange(10_000, 20_000, 100)
    agg, rng = _profile_agg()
    f = 4

    class M:
        x = rng.standard_normal((12, f)).astype(np.float32)
        y = rng.standard_normal((20, f)).astype(np.float32)
        user_ids = agg.user_ids
        item_ids = agg.item_ids

    art = upd._artifact_from_model(
        M, {"features": f, "lambda": 0.1, "alpha": 1.0}, agg)
    prof_json = art.get_extension("qualityProfile")
    assert prof_json, "artifact lacks the qualityProfile extension"
    prof = TrainingProfile.from_json(prof_json)
    assert prof.events_per_sec and prof.events_per_sec > 0
    assert prof.score_mean is not None
    for mod, apply in ((qmod, apply_update_message),
                       (jqs, jstate.apply_update_message)):
        fresh = mod.QualityStats()
        monkeypatch.setattr(mod, "_default", fresh)
        apply(None, "MODEL", art.to_string())
        assert fresh.profile is not None
        assert fresh.profile.item_sketch == pytest.approx(prof.item_sketch)
        with fresh._lock:
            assert fresh._known_items == set(agg.item_ids)


def test_publish_stamp_quality_feeds_gauge_and_freshness():
    from oryx_tpu_torch.common.freshness import model_freshness, publish_stamp

    mf = model_freshness()
    mf.note_loaded("MODEL", "m1")
    mf.note_stamp(publish_stamp(generation=777, quality={"auc": 0.87}))
    assert mf.generation == 777
    assert mf.quality == {"auc": 0.87}
    g = get_registry().gauge("oryx_generation_quality")
    assert g.value(metric="auc") == pytest.approx(0.87)
    mf.note_loaded("MODEL", "m2")
    mf.note_stamp(publish_stamp(generation=778))
    assert mf.quality is None
    assert g.value(metric="auc") == 0.0


def test_generation_swap_resets_live_sample_windows(monkeypatch):
    from oryx_tpu_torch.common.freshness import model_freshness, publish_stamp

    qs = _qs()
    mat, ids = _corpus()
    vec = np.random.default_rng(9).standard_normal(8).astype(np.float32)
    qs.maybe_sample(vec, _served(mat, ids, vec), how_many=10,
                    snapshot_fn=lambda: (mat, ids, len(ids)))
    assert qs.flush(10)
    assert qs.live_recall() == pytest.approx(1.0)
    monkeypatch.setattr(qmod, "_default", qs)
    mf = model_freshness()
    mf.note_loaded("MODEL", "m-reset")
    mf.note_stamp(publish_stamp(generation=999))
    assert math.isnan(qs.live_recall())  # the window is generation-scoped
    qs.close()


def test_mlupdate_note_eval_rides_the_stamp():
    from oryx_tpu_torch.apps.als.batch import ALSUpdate

    upd = ALSUpdate(load_config(overlay={"oryx.id": "stampq"}), device="cpu")
    assert upd.eval_metric_name() == "auc"
    upd.note_eval(0.91)
    sent = []

    class P:
        def send(self, key, msg):
            sent.append((key, msg))

    upd.send_publish_stamp("/models/123456", P())
    (key, msg), = sent
    assert key == "TRACE"
    stamp = json.loads(msg)
    assert stamp["generation"] == 123456
    assert stamp["quality"] == {"auc": 0.91}
    upd.note_eval(float("nan"))
    upd.send_publish_stamp("/models/123457", P())
    assert "quality" not in json.loads(sent[-1][1])


def test_quality_slo_burns_on_bad_samples():
    from oryx_tpu_torch.common import slo

    slo.ensure_quality_slo(load_config(overlay={
        "oryx.monitoring.slo.fast-window-sec": 60,
        "oryx.monitoring.slo.quality.objective": 0.95,
    }))
    t = slo.tracker("quality")
    assert t is not None
    t.burn_rate(t.fast_s)
    time.sleep(slo._MIN_SAMPLE_GAP_S + 0.02)
    c_all = get_registry().counter("oryx_quality_samples_total")
    c_bad = get_registry().counter("oryx_quality_bad_samples_total")
    for _ in range(20):
        c_all.inc(score_mode="quantized")
        c_bad.inc(score_mode="quantized")
    assert t.burn_rate(t.fast_s) > 5


def test_slo_sample_errors_counted_and_surfaced():
    from oryx_tpu_torch.common import slo

    c = get_registry().counter("oryx_slo_sample_errors_total")
    before = c.value(slo="broken-source")

    def exploding():
        raise RuntimeError("metric renamed out from under the SLO")

    t = slo.SloTracker("broken-source", 0.99, exploding, 1.0, 2.0)
    with slo._trackers_lock:
        slo._trackers["broken-source"] = t
    try:
        assert t.burn_rate(t.fast_s) == 0.0
        assert c.value(slo="broken-source") == before + 1
        assert "metric renamed" in t.last_error
        assert "broken-source" in slo.sample_errors()
    finally:
        with slo._trackers_lock:
            slo._trackers.pop("broken-source", None)


def _als_model_message(gen: int) -> str:
    rng = np.random.default_rng(gen)
    from oryx_tpu_torch.common.artifact import ModelArtifact

    art = ModelArtifact("als", extensions={
        "features": "16", "implicit": "true"},
        tensors={"X": rng.standard_normal((64, 16)).astype(np.float32),
                 "Y": rng.standard_normal((512, 16)).astype(np.float32)})
    art.set_extension("XIDs", [f"u{j}" for j in range(64)])
    art.set_extension("YIDs", [f"i{j}" for j in range(512)])
    return art.to_string()


def test_healthz_quality_section_and_console_row(tmp_path, monkeypatch):
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.serving.app import Request, ServingApp

    monkeypatch.setattr(qmod, "_default", QualityStats())
    cfg = load_config(overlay={
        "oryx.id": "qhealthz",
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common",
            "oryx_tpu_torch.serving.resources.als",
        ],
        "oryx.monitoring.quality.sample-rate": 1.0,
    })
    manager = ALSServingModelManager(cfg, device="cpu")
    app = ServingApp(cfg, manager, input_producer=None)
    manager.consume_key_message("MODEL", _als_model_message(1))
    # one served answer, sampled at rate 1.0 and rescored exactly
    status, _body, _ = app.dispatch(
        Request("GET", "/recommend/u3", {}, {}, b"", {}))
    assert status == 200
    assert qmod.get_qualitystats().flush(10)
    status, body, _ = app.dispatch(Request("GET", "/healthz", {}, {}, b"", {}))
    assert status == 200
    q = json.loads(body)["quality"]
    assert {"live_recall_at_10", "samples", "dropped", "sample_rate"} <= set(q)
    assert q["samples"] == 1 and q["live_recall_at_10"] == 1.0
    json.dumps(q)  # strictly JSON-finite
    status, body, _ = app.dispatch(Request("GET", "/console", {}, {}, b"", {}))
    assert status == 200
    assert b"live recall@10 (measured)" in body
    assert b"LSH sample rate" in body
    manager.close()
    qmod.get_qualitystats().close()


# ---- the quality plane in both packages ---------------------------------------


def _samples(pkg):
    """Exact, wrong, excluding and cosine samples on one corpus."""
    Sample = (jqs if pkg == "jax" else qmod)._Sample
    mat, ids = _corpus(n=400, f=12, seed=8)
    rng = np.random.default_rng(12)
    out = []
    for j in range(24):
        vec = rng.standard_normal(12).astype(np.float32)
        cosine = j % 4 == 3
        scores = mat @ vec
        if cosine:
            scores = scores / np.linalg.norm(mat, axis=1)
        order = np.argsort(-scores)
        exclude = frozenset({ids[int(order[0])]}) if j % 3 == 0 else frozenset()
        served = [(ids[int(r)], float(scores[r])) for r in order
                  if ids[int(r)] not in exclude][:10]
        if j % 2 == 1:  # a wrong answer: the tail, at lower scores
            served = [(ids[int(r)], float(scores[r]) - 0.5)
                      for r in order[-10:]]
        if j % 5 == 4:  # half right
            served = served[:5] + [(ids[int(r)], float(scores[r]))
                                   for r in order[-5:]]
        out.append(Sample(
            vec=vec, served_ids=[p[0] for p in served],
            served_scores=[p[1] for p in served], how_many=10,
            exclude=exclude, cosine=cosine,
            score_mode=("exact", "quantized", "lsh")[j % 3], trace_id=None,
            snapshot_fn=lambda: (mat, ids, len(ids))))
    return out


def test_shadow_scores_equal_the_jax_package():
    port = QualityStats()
    jax = jqs.QualityStats()
    for ps, js in zip(_samples("port"), _samples("jax")):
        (pr, pm), (jr, jm) = port.score_sample(ps), jax.score_sample(js)
        assert abs(pr - jr) <= PARITY_TOL and abs(pm - jm) <= PARITY_TOL


def _fake_clock(monkeypatch, t0=1000.0):
    clock = SimpleNamespace(now=t0)
    fake = SimpleNamespace(monotonic=lambda: clock.now, time=time.time,
                           sleep=time.sleep, perf_counter=time.perf_counter)
    for mod in (jqs, qmod):
        monkeypatch.setattr(mod, "time", fake)
    return clock


def test_live_recall_and_drift_equal_the_jax_package(monkeypatch, tmp_path):
    clock = _fake_clock(monkeypatch)
    overlay = {"oryx.monitoring.quality.sample-rate": 1.0,
               "oryx.monitoring.quality.window-sec": 60,
               "oryx.monitoring.flight.dir": str(tmp_path / "flight")}
    port, jax = QualityStats(), jqs.QualityStats()
    port.configure(load_config(overlay=overlay))
    jax.configure(jax_load_config(overlay=overlay))
    ids = [f"i{j}" for j in range(400)]
    rng = np.random.default_rng(40)
    counts = rng.integers(1, 50, 400).astype(np.float64)
    profile_json = build_training_profile(
        ids, counts, timestamps_ms=np.arange(0, 400_000, 1000),
        prev_item_ids=ids[:300], scores=rng.standard_normal(32) + 2.0,
    ).to_json()
    port.set_training_profile(TrainingProfile.from_json(profile_json))
    jax.set_training_profile(jqs.TrainingProfile.from_json(profile_json))
    for q in (port, jax):
        q.note_catalog(ids)
    for step in range(5):
        clock.now += 3.0
        batch = [f"i{int(j)}" for j in rng.integers(0, 500, 200)]
        for q in (port, jax):
            q.note_input_events(batch)
    for ps, js in zip(_samples("port"), _samples("jax")):
        port._process(ps)
        jax._process(js)
    clock.now += 1.0
    for mode in (None, "exact", "quantized", "lsh"):
        pr, jr = port.live_recall(mode), jax.live_recall(mode)
        assert abs(pr - jr) <= PARITY_TOL, mode
    for signal in ("item-popularity", "event-rate", "new-item-fraction"):
        pd, jd = port.input_drift(signal), jax.input_drift(signal)
        assert math.isfinite(pd) and abs(pd - jd) <= PARITY_TOL, signal
    for signal in ("score-mean", "score-spread"):
        pd, jd = port.prediction_drift(signal), jax.prediction_drift(signal)
        assert math.isfinite(pd) and abs(pd - jd) <= PARITY_TOL, signal
    ph, jh = port.healthz_section(), jax.healthz_section()
    for key in ("input_drift", "prediction_drift"):
        assert ph[key] == jh[key]
    assert ph["live_recall_at_10"] == jh["live_recall_at_10"]


# ---- the score-mode recall gate -----------------------------------------------


def test_score_mode_recall_gate():
    from oryx_tpu_torch.ml.quality import (
        MIN_SCORE_MODE_RECALL,
        evaluate_score_mode_recall,
    )

    rep = evaluate_score_mode_recall(n_items=40_000, n_queries=128,
                                     device="cpu")
    assert rep.min_recall == MIN_SCORE_MODE_RECALL == 0.95
    assert rep.recall_quantized >= rep.min_recall, (
        f"quantized recall@{rep.k} {rep.recall_quantized:.4f} below the "
        f"{rep.min_recall} gate — int8 selection + exact rescore regressed")
    assert rep.recall_approx >= rep.min_recall, (
        f"approx recall@{rep.k} {rep.recall_approx:.4f} below the "
        f"{rep.min_recall} gate")
    assert rep.green


def test_recall_gate_equals_the_jax_package():
    from oryx_tpu.ml.quality import evaluate_score_mode_recall as jax_gate
    from oryx_tpu_torch.ml.quality import (
        evaluate_score_mode_recall,
        recall_corpus,
    )
    from oryx_tpu_torch.ops.topk import f32_tolerance

    n_items, n_queries, k, features = 40_000, 128, 10, 50
    port = evaluate_score_mode_recall(n_items=n_items, n_queries=n_queries,
                                      device="cpu")
    jax = jax_gate(n_items=n_items, n_queries=n_queries)
    # queries whose exact k-th and (k+1)-th f32 scores lie within the f32
    # accumulation error of each other: the only place the two packages'
    # exact references may rank differently
    y, xs = recall_corpus(n_items, features, n_queries, 23)
    s = np.sort(xs.astype(np.float64) @ y.T.astype(np.float64), axis=1)
    kth, nxt = s[:, -k], s[:, -k - 1]
    scale = np.abs(xs).max(axis=1) * np.abs(y).max() * features
    tied = int(np.sum(kth - nxt <= f32_tolerance(features) * scale))
    allowance = tied / (k * n_queries)
    assert abs(port.recall_quantized - jax.recall_quantized) <= allowance
    assert abs(port.recall_approx - jax.recall_approx) <= allowance
    assert (port.k, port.n_items, port.n_queries, port.features) == (
        jax.k, jax.n_items, jax.n_queries, jax.features)


# ---- the fleet front ----------------------------------------------------------


def test_fleet_status_carries_quality_and_slo_errors():
    """tests/test_qualitystats.py's fleet case: /fleet/status federates a
    replica's quality scorecard verbatim and carries the SLO read errors."""
    from oryx_tpu_torch.fleet.front import FleetFront

    cfg = load_config(overlay={"oryx.id": "tqfleet"})
    front = FleetFront(cfg, backends=[("r0", "127.0.0.1", 18099)], port=0)
    front.replicas[0].quality = {"live_recall_at_10": 0.97, "samples": 12}
    status, body, ctype, _ = front._local_endpoint("GET", "/fleet/status")
    assert status == 200 and ctype == "application/json"
    doc = json.loads(body)
    assert "slo_errors" in doc
    assert doc["replicas"][0]["quality"] == {
        "live_recall_at_10": 0.97, "samples": 12
    }


def _recall(got_ids, exact_ids) -> float:
    return len(set(got_ids) & set(exact_ids)) / max(1, len(exact_ids))


@pytest.mark.parametrize("mode", ["quantized", "approx"])
def test_score_mode_serves_end_to_end_http_and_fleet_front(mode):
    """tests/test_score_modes.py's end to end case against the port (its
    manager on the CPU): each non-exact mode serves /recommend at recall
    >= 0.95 over HTTP, and >= 0.9 routed through the fleet front."""
    import urllib.request

    from oryx_tpu.common.artifact import ModelArtifact
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.bus.inproc import InProcBroker
    from oryx_tpu_torch.fleet.front import FleetFront
    from oryx_tpu_torch.serving.server import ServingLayer

    InProcBroker.reset_all()
    rng = np.random.default_rng(17)
    n, f = 1500, 16
    bus = f"mem://tmode-{mode}"
    cfg = load_config(overlay={
        "oryx.id": f"tmode-{mode}",
        "oryx.input-topic.broker": bus,
        "oryx.update-topic.broker": bus,
        "oryx.serving.api.port": 0,
        "oryx.serving.api.read-only": True,
        "oryx.serving.init-topics": True,
        "oryx.serving.api.score-mode": mode,
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common",
            "oryx_tpu_torch.serving.resources.als",
        ],
        "oryx.als.hyperparams.features": f,
    })
    topics.maybe_create(bus, "OryxUpdate", partitions=1)
    topics.maybe_create(bus, "OryxInput", partitions=1)
    x_mat = rng.standard_normal((8, f)).astype(np.float32)
    y_mat = rng.standard_normal((n, f)).astype(np.float32)
    art = ModelArtifact(app="als", tensors={"X": x_mat, "Y": y_mat})
    art.set_extension("features", str(f))
    art.set_extension("implicit", "true")
    art.set_extension("XIDs", [f"u{j}" for j in range(8)])
    art.set_extension("YIDs", [f"i{j}" for j in range(n)])
    get_broker(bus).send("OryxUpdate", "MODEL", art.to_string())

    manager = ALSServingModelManager(cfg, device="cpu")
    assert manager.score_mode == mode
    serving = ServingLayer(cfg, model_manager=manager)
    serving.start()
    front = None
    try:
        base = f"http://127.0.0.1:{serving.port}"
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            try:
                with urllib.request.urlopen(f"{base}/ready", timeout=5) as r:
                    if r.status == 200:
                        break
            except Exception:
                pass
            time.sleep(0.1)
        assert manager.model is not None and manager.model.score_mode == mode

        def exact_top10(uj: int) -> list[str]:
            scores = y_mat @ x_mat[uj]
            return [f"i{int(j)}" for j in np.argsort(-scores, kind="stable")[:10]]

        recalls = []
        for uj in range(8):
            with urllib.request.urlopen(
                f"{base}/recommend/u{uj}?howMany=10", timeout=30
            ) as r:
                assert r.status == 200
                got = [p[0] for p in json.loads(r.read())]
            recalls.append(_recall(got, exact_top10(uj)))
        assert np.mean(recalls) >= 0.95, (mode, recalls)

        front = FleetFront(
            load_config(overlay={"oryx.fleet.front.probe-interval-sec": 0.2}),
            backends=[("r0", "127.0.0.1", serving.port)],
            port=0,
        )
        front.start()
        with urllib.request.urlopen(
            f"http://127.0.0.1:{front.port}/recommend/u0?howMany=10",
            timeout=30,
        ) as r:
            assert r.status == 200
            got = [p[0] for p in json.loads(r.read())]
        assert _recall(got, exact_top10(0)) >= 0.9
    finally:
        if front is not None:
            front.close()
        serving.close()
        InProcBroker.reset_all()
