"""The port's fleet beside the JAX package's on the same inputs (numpy
seeds): ring placement, metrics federation, latency-budget merging, trace
stitching, replica overlays, and one two-replica front of each package
over the same ALS artifact answering the same /recommend requests.

Tolerance of the front-to-front comparison: the one
tests/test_torch_serving_layer.py holds the two serving layers to. Both
packages scan the catalog in bf16 and re-rank the candidates in exact f32
on the host, so values agree within 1e-5 relative, and ids agree at every
slot except where the two entries' scores are within 1e-6 relative of each
other (a near-tie ordered the other way). Everything else here is exact.
"""

from __future__ import annotations

import copy
import http.client
import json
import subprocess
import time

import numpy as np
import pytest

from oryx_tpu.common.config import load_config as jax_load_config
from oryx_tpu.fleet import observe as jax_observe
from oryx_tpu.fleet.ring import HashRing as JaxHashRing
from oryx_tpu.fleet.supervisor import replica_overlays as jax_replica_overlays
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.fleet import observe
from oryx_tpu_torch.fleet.ring import HashRing
from oryx_tpu_torch.fleet.supervisor import replica_overlays

VALUE_RTOL = 1e-5
TIE_RTOL = 1e-6


def _keys(seed: int, n: int = 3000) -> list[str]:
    rng = np.random.default_rng(seed)
    return [f"user-{int(v)}" for v in rng.integers(0, 10**9, n)]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5])
def test_ring_places_keys_as_the_jax_ring(n):
    nodes = [f"r{i}" for i in range(n)]
    ring, ref = HashRing(nodes), JaxHashRing(nodes)
    for k in _keys(n):
        assert ring.lookup(k) == ref.lookup(k)
        assert list(ring.lookup_seq(k)) == list(ref.lookup_seq(k))
    # the same after a resize, in both directions
    ring.add(f"r{n}")
    ref.add(f"r{n}")
    ring.remove("r0")
    ref.remove("r0")
    for k in _keys(n + 10, 500):
        assert list(ring.lookup_seq(k)) == list(ref.lookup_seq(k))


def _pages(seed: int) -> list[tuple[str, str]]:
    """Replica exposition pages with shared and one-sided families,
    labelled samples, histograms, exemplars and one stray sample."""
    rng = np.random.default_rng(seed)
    pages = []
    for r in range(3):
        lines = [
            "# HELP oryx_serving_requests_total reqs",
            "# TYPE oryx_serving_requests_total counter",
        ]
        for code in ("200", "503"):
            lines.append(
                f'oryx_serving_requests_total{{method="GET",status="{code}"}} '
                f"{int(rng.integers(0, 1000))}"
            )
        lines += [
            "# TYPE oryx_serving_request_seconds histogram",
            f'oryx_serving_request_seconds_bucket{{le="0.01"}} '
            f"{int(rng.integers(0, 50))} # {{trace_id=\"{r:032x}\"}} 0.004 1.5",
            f'oryx_serving_request_seconds_bucket{{le="+Inf"}} 60',
            f"oryx_serving_request_seconds_sum {rng.random():.6f}",
            "oryx_serving_request_seconds_count 60",
            f"# TYPE only_r{r} gauge",
            f'only_r{r}{{shard_replica="1"}} {rng.random():.6f}',
            f"stray_metric {r}",
        ]
        pages.append((f"r{r}", "\n".join(lines) + "\n"))
    return pages


@pytest.mark.parametrize("openmetrics", [False, True])
def test_federate_matches_the_jax_package(openmetrics):
    pages = _pages(7)
    got = observe.federate(pages, openmetrics=openmetrics)
    assert got == jax_observe.federate(pages, openmetrics=openmetrics)
    assert got.count("# TYPE oryx_serving_requests_total counter") == 1
    for rid, page in pages:
        fams, order = observe.parse_exposition(page)
        ref_fams, ref_order = jax_observe.parse_exposition(page)
        assert order == ref_order
        assert {k: (f.help, f.type, f.unit, f.samples) for k, f in fams.items()} == {
            k: (f.help, f.type, f.unit, f.samples) for k, f in ref_fams.items()
        }
        for line in page.splitlines():
            assert observe.inject_label(line, "replica", rid) == (
                jax_observe.inject_label(line, "replica", rid)
            )


def _budgets(seed: int) -> list:
    rng = np.random.default_rng(seed)
    out: list = []
    for _ in range(4):
        phases = {}
        for name in ("parse", "queue_wait", "device", "serialize"):
            if rng.random() < 0.8:
                p50 = float(rng.random() * 5)
                phases[name] = {
                    "count": int(rng.integers(0, 200)),
                    "p50_ms": p50, "p99_ms": p50 * 3, "share": 0.25,
                }
        gaps = {
            c: {"seconds": float(rng.random()), "share": 0.5}
            for c in ("empty_queue", "host_serialize")
        }
        out.append({"window_s": float(rng.integers(10, 300)),
                    "phases": phases, "idle_gaps": gaps})
    out += [None, "junk"]
    return out


def test_merge_latency_budgets_matches_the_jax_package():
    for seed in range(5):
        b = _budgets(seed)
        assert observe.merge_latency_budgets(copy.deepcopy(b)) == (
            jax_observe.merge_latency_budgets(copy.deepcopy(b))
        )
    assert observe.merge_latency_budgets([]) == jax_observe.merge_latency_budgets([])


def _forests(seed: int) -> list[tuple[str, list[dict]]]:
    """Front and replica span forests sharing some trace ids (and one span
    id duplicated across processes)."""
    rng = np.random.default_rng(seed)
    traces = [f"{int(v):032x}" for v in rng.integers(1, 2**62, 4)]
    procs = []
    for label in ("front", "r0", "r1"):
        roots = []
        for t in traces:
            if rng.random() < 0.3:
                continue
            start = float(rng.random() * 100)
            kids = [
                {"name": f"{label}.child", "trace_id": t,
                 "span_id": f"{label}-{t[:4]}-{j}", "parent_id": f"{label}-{t[:4]}",
                 "start_ms": start + j, "duration_ms": float(rng.random()),
                 "attrs": {"j": j}, "children": []}
                for j in range(int(rng.integers(0, 3)))
            ]
            roots.append({
                "name": f"{label}.root", "trace_id": t,
                "span_id": f"{label}-{t[:4]}", "parent_id": None,
                "start_ms": start, "duration_ms": float(rng.random() * 5),
                "attrs": {"status": 200}, "children": kids,
            })
        roots.append({"name": "shared", "trace_id": traces[0], "span_id": "dup",
                      "parent_id": None, "start_ms": 1.0, "duration_ms": 1.0,
                      "attrs": {}, "children": []})
        roots.append({"name": "no-trace", "children": []})
        procs.append((label, roots))
    return procs


def test_stitching_matches_the_jax_package():
    from oryx_tpu.common import tracing as jax_tracing
    from oryx_tpu_torch.common import tracing

    for seed in range(4):
        procs = _forests(seed)
        assert tracing.stitch_traces(copy.deepcopy(procs)) == (
            jax_tracing.stitch_traces(copy.deepcopy(procs))
        )
        assert tracing.stitched_chrome(copy.deepcopy(procs)) == (
            jax_tracing.stitched_chrome(copy.deepcopy(procs))
        )
        for _, forest in procs:
            assert tracing.flatten_forest(copy.deepcopy(forest)) == (
                jax_tracing.flatten_forest(copy.deepcopy(forest))
            )


@pytest.mark.parametrize("overlay,kw", [
    ({"oryx.id": "prod", "oryx.fleet.data-dir": "/tmp/fx"},
     {"n": 3, "base_port": 9100}),
    ({"oryx.fleet.replicas": 4, "oryx.fleet.canary.enabled": True},
     {}),
    ({"oryx.fleet.replicas": 2, "oryx.fleet.canary.enabled": True,
      "oryx.fleet.canary.replica": "r1"}, {"base_port": 9500}),
    ({"oryx.fleet.replicas": 3, "oryx.fleet.shards": 2}, {}),
    ({"oryx.fleet.replicas": 2}, {"shards": 4}),
])
def test_replica_overlays_match_the_jax_package(overlay, kw):
    assert replica_overlays(load_config(overlay=overlay), **kw) == (
        jax_replica_overlays(jax_load_config(overlay=overlay), **kw)
    )


# ---- the two fronts --------------------------------------------------------

N_USERS, N_ITEMS, FEATURES = 40, 1500, 8


def _model_message() -> str:
    from oryx_tpu.common.artifact import ModelArtifact

    rng = np.random.default_rng(21)
    art = ModelArtifact(
        "als",
        extensions={
            "features": str(FEATURES), "lambda": "0.001", "alpha": "1.0",
            "implicit": "true", "logStrength": "false",
        },
        tensors={
            "X": rng.standard_normal((N_USERS, FEATURES), dtype=np.float32),
            "Y": rng.standard_normal((N_ITEMS, FEATURES), dtype=np.float32),
        },
    )
    art.set_extension("XIDs", [f"u{j}" for j in range(N_USERS)])
    art.set_extension("YIDs", [f"i{j}" for j in range(N_ITEMS)])
    return art.to_string()


def _supervisor(pkg: str, root, message: str):
    """One package's supervisor of two replicas, not yet started, over its
    own file:// bus holding ``message``: (supervisor, FleetFront class)."""
    if pkg == "jax":
        from oryx_tpu.bus.broker import get_broker, topics
        from oryx_tpu.common.executil import (
            config_overlay_from_sets, cpu_subprocess_env, free_port_run,
        )
        from oryx_tpu.fleet import FleetFront, FleetSupervisor

        env = cpu_subprocess_env()
        platform = []
    else:
        import os

        from oryx_tpu_torch.bus.broker import get_broker, topics
        from oryx_tpu_torch.common.executil import (
            config_overlay_from_sets, free_port_run,
        )
        from oryx_tpu_torch.fleet import FleetFront, FleetSupervisor

        env = dict(os.environ, TMPDIR=str(root))
        platform = ["oryx.compute.platform=cpu"]
    bus = f"file://{root / 'bus'}"
    topics.maybe_create(bus, "OryxInput", 1)
    topics.maybe_create(bus, "OryxUpdate", 1)
    get_broker(bus).send("OryxUpdate", "MODEL", message)
    sets = [
        f"oryx.id=parity-{pkg}",
        f"oryx.input-topic.broker={bus}",
        f"oryx.update-topic.broker={bus}",
        f"oryx.serving.model-manager-class={pkg_mod(pkg)}.apps.als.serving."
        "ALSServingModelManager",
        "oryx.serving.application-resources="
        f'["{pkg_mod(pkg)}.serving.resources.common",'
        f'"{pkg_mod(pkg)}.serving.resources.als"]',
        "oryx.serving.api.read-only=true",
        "oryx.serving.api.loops=1",
        "oryx.serving.api.score-mode=exact",
        "oryx.fleet.replicas=2",
        f"oryx.fleet.base-port={free_port_run(2)}",
        f"oryx.fleet.data-dir={root / 'fleet'}",
        "oryx.fleet.front.policy=hash",
        "oryx.fleet.front.probe-interval-sec=0.3",
        f"oryx.monitoring.flight.dir={root / 'front-flight'}",
        *platform,
    ]
    cfg = (jax_load_config if pkg == "jax" else load_config)(
        overlay=config_overlay_from_sets(sets)
    )
    sup = FleetSupervisor(
        cfg, argv=[x for s in sets for x in ("--set", s)], env=env,
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    return sup, FleetFront


def pkg_mod(pkg: str) -> str:
    return "oryx_tpu" if pkg == "jax" else "oryx_tpu_torch"


def _get(port: int, path: str) -> tuple[int, bytes]:
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", path, headers={"Accept": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _close(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) <= rtol * max(abs(a), abs(b), 1e-30)


def test_two_fronts_answer_recommend_alike(tmp_path):
    """A two-replica hash front of each package over the same artifact:
    every /recommend answers 200 on both, with the same ids (near-ties
    aside) and values within the stated tolerance, and each front spread
    the users over both of its replicas."""
    message = _model_message()
    fleets = {}
    fronts = {}
    try:
        for pkg in ("jax", "port"):
            root = tmp_path / pkg
            root.mkdir()
            fleets[pkg] = _supervisor(pkg, root, message)
            fleets[pkg][0].start()
        for sup, _ in fleets.values():
            sup.wait_listening(90)
            for _, _, port in sup.backends():
                deadline = time.time() + 90
                while _get(port, "/ready")[0] != 200:
                    assert time.time() < deadline, f"replica :{port} never ready"
                    time.sleep(0.3)
        for pkg, (sup, front_cls) in fleets.items():
            fronts[pkg] = front_cls(sup.config, backends=sup.backends(), port=0)
            fronts[pkg].start()
        # the fronts' request counters are process-wide: count this run's
        answered0 = {pkg: _answered(f) for pkg, f in fronts.items()}

        for u in range(N_USERS):
            path = f"/recommend/u{u}?howMany=10"
            js, jb = _get(fronts["jax"].port, path)
            ps, pb = _get(fronts["port"].port, path)
            assert js == ps == 200, (path, js, ps)
            jp, pp = json.loads(jb), json.loads(pb)
            assert len(jp) == len(pp) == 10
            for (ji, jv), (pi, pv) in zip(jp, pp):
                assert _close(float(jv), float(pv), VALUE_RTOL), (u, ji, jv, pi, pv)
                if ji != pi:
                    assert _close(float(jv), float(pv), TIE_RTOL), (u, ji, jv, pi, pv)
        for pkg, front in fronts.items():
            answered = _answered(front)
            served = {r for r, v in answered.items()
                      if v > answered0[pkg].get(r, 0.0)}
            assert served == {"r0", "r1"}, (pkg, answered, answered0[pkg])
    finally:
        for front in fronts.values():
            front.close()
        for sup, _ in fleets.values():
            sup.stop()


def _answered(front) -> dict:
    return {
        dict(k).get("replica"): v for k, v in front._m_requests.series().items()
    }
