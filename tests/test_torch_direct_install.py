"""A model installed on the port's serving managers outside the update
listener (``manager.model = ALSServingModel(state)``, as the JAX package's
tests install theirs) gets its scoring view at install and becomes ready.

The port twins of four JAX tests that install models this way, on
``device="cpu"``:

- tests/test_aserver.py::test_recommend_dispatch_is_deferred
- tests/test_aserver.py::test_multi_loop_cross_loop_coalescing
- tests/test_perfattr.py::test_e2e_attribution_covers_request_wall_clock
- tests/test_tracing.py::test_loadtest_produces_span_tree_with_batcher_children

then the install rule itself: the view is built on the installing thread
when the state's load fraction reaches ``min-model-load-fraction`` (the
device view, or with LSH the partition view), never for a state below it,
and the seq manager follows the same rule.
"""

from __future__ import annotations

import http.client
import io
import json
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest

from e2e_common import http_request
from oryx_tpu_torch.apps.als.serving import ALSServingModel, ALSServingModelManager
from oryx_tpu_torch.apps.als.state import ALSState
from oryx_tpu_torch.bus.broker import get_broker, topics
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.serving.server import ServingLayer

RESOURCES = [
    "oryx_tpu_torch.serving.resources.common",
    "oryx_tpu_torch.serving.resources.als",
]


def _als_state(n_users: int, n_items: int, features: int, seed: int = 0) -> ALSState:
    rng = np.random.default_rng(seed)
    state = ALSState(features, implicit=True)
    state.x.bulk_set(
        [f"u{i}" for i in range(n_users)],
        rng.standard_normal((n_users, features)).astype(np.float32),
    )
    state.y.bulk_set(
        [f"i{i}" for i in range(n_items)],
        rng.standard_normal((n_items, features)).astype(np.float32),
    )
    state.set_expected(state.x.ids(), state.y.ids())
    return state


def _serving_config(bus: str, tmp_path, **extra):
    broker = get_broker(bus)
    for t in ("OryxInput", "OryxUpdate"):
        if not broker.topic_exists(t):
            broker.create_topic(t, 1)
    overlay = {
        "oryx.input-topic.broker": bus,
        "oryx.update-topic.broker": bus,
        "oryx.serving.api.port": 0,
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.model-manager-class":
            "oryx_tpu_torch.apps.als.serving.ALSServingModelManager",
        "oryx.serving.application-resources": RESOURCES,
    }
    overlay.update(extra)
    return load_config(overlay=overlay)


def _installed_manager(cfg, state: ALSState, **model_kw) -> ALSServingModelManager:
    manager = ALSServingModelManager(cfg, device="cpu")
    manager.model = ALSServingModel(state, device="cpu", **model_kw)
    return manager


# ---- twins of the JAX package's direct-install tests -----------------------


def test_recommend_dispatch_is_deferred(tmp_path):
    """The recommend-family endpoints must not park the dispatch thread:
    dispatch_nowait returns a Deferred whose future completes with the
    rendered response; blocking dispatch() answers the same."""
    from oryx_tpu_torch.serving.app import Deferred, Request, ServingApp

    rng = np.random.default_rng(0)
    state = ALSState(4, implicit=True)
    state.y.bulk_set(["i0", "i1", "i2"], rng.standard_normal((3, 4), dtype=np.float32))
    state.x.bulk_set(["u0"], rng.standard_normal((1, 4), dtype=np.float32))
    state.set_expected(["u0"], ["i0", "i1", "i2"])
    cfg = load_config(overlay={
        "oryx.serving.application-resources": RESOURCES,
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
    })
    mgr = _installed_manager(cfg, state, sample_rate=1.0)
    app = ServingApp(cfg, mgr)

    resp = app.dispatch_nowait(
        Request("GET", "/recommend/u0", {}, {"howMany": ["2"]}, b"",
                {"accept": "application/json"})
    )
    assert isinstance(resp, Deferred)
    status, body, ctype = resp.future.result(timeout=30)
    assert status == 200
    assert len(json.loads(body)) == 2
    status2, body2, _ = app.dispatch(
        Request("GET", "/recommend/u0", {}, {"howMany": ["2"]}, b"",
                {"accept": "application/json"})
    )
    assert status2 == 200 and json.loads(body2) == json.loads(body)


def test_multi_loop_cross_loop_coalescing(monkeypatch, tmp_path):
    """Requests arriving on DIFFERENT event loops coalesce into shared
    dispatches: the process-wide batcher's dispatch count stays below its
    coalesced request count, and more than one loop carried traffic."""
    import oryx_tpu_torch.serving.batcher as batcher_mod
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    state = _als_state(32, 500, 8)
    cfg = load_config(overlay={
        "oryx.id": "txloop",
        "oryx.input-topic.broker": "mem://txloop",
        "oryx.update-topic.broker": "mem://txloop",
        "oryx.serving.api.port": 0,
        "oryx.serving.api.read-only": True,
        "oryx.serving.api.loops": 4,
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.application-resources": RESOURCES,
    })
    topics.maybe_create("mem://txloop", "OryxUpdate", partitions=1)
    mgr = _installed_manager(cfg, state, sample_rate=1.0)

    # hold each dispatch briefly so concurrent arrivals pile into the
    # NEXT batch deterministically (the batcher's natural backpressure,
    # made stable on a fast CPU where dispatches are sub-ms)
    real = batcher_mod.topk_dot_batch

    def slowed(*a, **k):
        time.sleep(0.01)
        return real(*a, **k)

    monkeypatch.setattr(batcher_mod, "topk_dot_batch", slowed)
    b = TopKBatcher.shared()
    d0, c0 = b.dispatches, b.coalesced

    with ServingLayer(cfg, model_manager=mgr) as sl:
        results: list = [None] * 32

        def client(i):
            conn = http.client.HTTPConnection("127.0.0.1", sl.port, timeout=60)
            ok = True
            for _ in range(4):
                conn.request("GET", f"/recommend/u{i}?howMany=5")
                r = conn.getresponse()
                body = r.read()
                ok = ok and r.status == 200 and len(json.loads(body)) == 5
            conn.close()
            results[i] = ok

        threads = [threading.Thread(target=client, args=(i,)) for i in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert all(results), results
        served = [ls.requests for ls in sl._aio_server._loopstates]

    coalesced = b.coalesced - c0
    dispatches = b.dispatches - d0
    assert coalesced == 128
    assert dispatches < coalesced, (dispatches, coalesced)
    assert sum(1 for n in served if n > 0) >= 2, served


def _phase_metric_sums(text: str) -> dict[str, dict[str, float]]:
    """family -> {label value -> _sum} for the perfattr histograms."""
    from oryx_tpu_torch.cli import _parse_metric_sample

    out: dict[str, dict[str, float]] = {
        "oryx_request_phase_seconds": {},
        "oryx_device_idle_gap_seconds": {},
        "oryx_serving_request_seconds": {},
    }
    for line in text.splitlines():
        if line.startswith("#"):
            continue
        parsed = _parse_metric_sample(line)
        if parsed is None:
            continue
        name, labels, value = parsed
        for family, acc in out.items():
            if name == family + "_sum":
                key = labels.get("phase") or labels.get("cause") or (
                    labels.get("method", "")
                )
                acc[key] = acc.get(key, 0.0) + value
    return out


def test_e2e_attribution_covers_request_wall_clock(tmp_path):
    """After warmup, phase stamps tile the measured request wall-clock
    (>= 95% of the serving-request histogram delta), every idle gap
    classifies with no unattributed share, and /healthz advertises the
    latency budget."""
    from oryx_tpu_torch.common.metrics import get_registry
    from oryx_tpu_torch.common.perfattr import PHASES, configure_perfattr

    cfg = _serving_config(
        "mem://tperfattr-e2e", tmp_path,
        **{"oryx.monitoring.perfattr.window-sec": 300},
    )
    manager = _installed_manager(cfg, _als_state(32, 64, 8))
    try:
        with ServingLayer(cfg, model_manager=manager) as sl:
            base = f"http://127.0.0.1:{sl.port}"
            for i in range(5):
                status, _ = http_request("GET", f"{base}/recommend/u{i}?howMany=4")
                assert status == 200
            time.sleep(0.3)
            before = _phase_metric_sums(get_registry().render_prometheus())

            n = 40
            for i in range(n):
                status, _ = http_request(
                    "GET", f"{base}/recommend/u{i % 16}?howMany=6"
                )
                assert status == 200
            time.sleep(0.3)
            after = _phase_metric_sums(get_registry().render_prometheus())

            def delta(family: str) -> dict[str, float]:
                return {
                    k: after[family].get(k, 0.0) - before[family].get(k, 0.0)
                    for k in after[family]
                }

            phase_d = delta("oryx_request_phase_seconds")
            serving_d = sum(delta("oryx_serving_request_seconds").values())
            attributed = sum(phase_d.values())
            assert serving_d > 0.0
            assert attributed >= 0.95 * serving_d, (
                f"phases covered {attributed:.4f}s of {serving_d:.4f}s "
                f"({attributed / serving_d:.1%}): {phase_d}"
            )
            assert phase_d.get("queue_wait", 0.0) > 0.0
            assert phase_d.get("device", 0.0) + phase_d.get(
                "host_fallback", 0.0
            ) > 0.0
            assert phase_d.get("serialize", 0.0) > 0.0
            assert {k for k, v in phase_d.items() if v > 0.0} <= set(PHASES)

            gap_d = delta("oryx_device_idle_gap_seconds")
            classified = sum(v for k, v in gap_d.items() if k != "unattributed")
            assert classified > 0.0
            assert gap_d.get("unattributed", 0.0) == pytest.approx(0.0, abs=1e-9)

            status, body = http_request("GET", f"{base}/healthz")
            assert status == 200
            lb = json.loads(body).get("latency_budget")
            assert lb and lb["phases"], body[:400]
            assert "device" in lb["phases"] or "host_fallback" in lb["phases"]
            for row in lb["phases"].values():
                assert set(row) == {"count", "p50_ms", "p99_ms", "share"}
    finally:
        configure_perfattr(load_config())


def test_loadtest_produces_span_tree_with_batcher_children(tmp_path):
    """A real loadtest against the async frontend with tracing on:
    /debug/traces returns a request span tree holding the batcher's
    queue-wait and device children, the chrome export loads, and /healthz
    reports liveness."""
    from oryx_tpu_torch.cli import main as cli_main
    from oryx_tpu_torch.common.tracing import get_tracer

    cfg = _serving_config(
        "mem://ttracesmoke", tmp_path,
        **{
            "oryx.serving.api.loops": 2,
            "oryx.monitoring.tracing.enabled": True,
            "oryx.monitoring.tracing.buffer-size": 8192,
        },
    )
    manager = _installed_manager(cfg, _als_state(32, 64, 8))
    paths = tmp_path / "paths.txt"
    paths.write_text("/recommend/u0?howMany=4\n/recommend/u1?howMany=4\n")
    try:
        with ServingLayer(cfg, model_manager=manager) as sl:
            base = f"http://127.0.0.1:{sl.port}"
            out = io.StringIO()
            with redirect_stdout(out):
                rc = cli_main([
                    "loadtest", "--url", base, "--paths", str(paths),
                    "--duration", "1.5", "--workers", "4",
                ])
            assert rc == 0
            report = json.loads(out.getvalue().strip().splitlines()[-1])
            assert report["errors"] == 0 and report["requests"] > 10

            status, body = http_request("GET", f"{base}/debug/traces")
            assert status == 200
            payload = json.loads(body)
            assert payload["enabled"] is True
            roots = [
                t for t in payload["traces"]
                if t["name"] == "http.request"
                and "/recommend" in t["attrs"].get("target", "")
            ]
            assert roots, "no request span trees recorded"
            with_batcher = [
                t for t in roots
                if any(c["name"] == "batcher.queue_wait" for c in t["children"])
            ]
            assert with_batcher, json.dumps(roots[:2])[:800]
            tree = with_batcher[-1]
            child_names = {c["name"] for c in tree["children"]}
            assert "batcher.device" in child_names
            assert "http.dispatch" in child_names
            assert tree["attrs"].get("status") == 200

            status, body = http_request("GET", f"{base}/debug/traces?format=chrome")
            assert status == 200
            chrome = json.loads(body)
            assert chrome["traceEvents"] and chrome["traceEvents"][0]["ph"] == "X"

            status, body = http_request("GET", f"{base}/healthz")
            assert status == 200
            health = json.loads(body)
            assert health["status"] == "up"
            assert health["uptime_seconds"] >= 0
    finally:
        get_tracer().configure(enabled=False)


# ---- the install rule ------------------------------------------------------


@pytest.mark.parametrize("sample_rate", [1.0, 0.5])
def test_install_builds_the_scoring_view_and_readies(sample_rate, tmp_path):
    """Installing a loaded model builds its scoring view on the installing
    thread (the device view; with LSH the partition view), so the model
    reports its state's fraction and /ready answers 200 at once."""
    cfg = _serving_config(f"mem://tinstall-{sample_rate}", tmp_path)
    state = _als_state(8, 40, 4)
    model = ALSServingModel(state, device="cpu", sample_rate=sample_rate)
    assert model.fraction_loaded() == 0.0  # no view yet
    manager = ALSServingModelManager(cfg, device="cpu")
    manager.model = model
    assert model._scoring_view() is not None
    assert model.fraction_loaded() == state.fraction_loaded() == 1.0
    with ServingLayer(cfg, model_manager=manager) as sl:
        status, _ = http_request("GET", f"http://127.0.0.1:{sl.port}/ready")
        assert status == 200
        status, body = http_request(
            "GET", f"http://127.0.0.1:{sl.port}/recommend/u0?howMany=3"
        )
        assert status == 200 and len(json.loads(body)) == 3


def test_install_below_the_load_fraction_builds_nothing(tmp_path):
    """A state below min-model-load-fraction keeps /ready's guarantee:
    no view is built for it and the model reports 0 loaded."""
    cfg = _serving_config("mem://tinstall-partial", tmp_path)
    state = _als_state(8, 40, 4)
    state.set_expected(state.x.ids() + [f"u{i}" for i in range(8, 80)],
                       state.y.ids())
    assert state.fraction_loaded() < 0.8
    manager = ALSServingModelManager(cfg, device="cpu")
    manager.model = ALSServingModel(state, device="cpu")
    assert manager.get_model()._scoring_view() is None
    assert manager.get_model().fraction_loaded() == 0.0
    manager.model = None
    assert manager.get_model() is None


def test_seq_install_builds_the_device_view(tmp_path):
    """The seq manager follows the same rule: a loaded model installed
    directly gets its device view and reports its state's fraction."""
    import torch

    from oryx_tpu_torch.apps.seq.serving import SeqServingModel, SeqServingModelManager
    from oryx_tpu_torch.apps.seq.state import SeqState
    from oryx_tpu_torch.ops.seq import init_gru_params

    dim = 8
    state = SeqState(dim, window=4)
    rng = np.random.default_rng(3)
    ids = [f"i{j}" for j in range(30)]
    for j, ident in enumerate(ids):
        state.set_item(ident, rng.standard_normal(dim).astype(np.float32))
    state.params = init_gru_params(torch.Generator().manual_seed(0), dim)
    state.set_expected(ids)
    cfg = load_config(overlay={
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
    })
    model = SeqServingModel(state, device="cpu")
    assert model.fraction_loaded() == 0.0
    manager = SeqServingModelManager(cfg, device="cpu")
    manager.model = model
    assert model._device_view is not None
    assert model.fraction_loaded() == 1.0
    assert manager.get_model() is model
