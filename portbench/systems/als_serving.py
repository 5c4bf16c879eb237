"""ALS serving: the port's ``ServingLayer`` answering ``/recommend`` over
HTTP from a model installed in-process.

Set-up draws the factor tables and known items from the seed on the
device, hands them to the program as an ``ALSState``
(``state_from_arrays``) and installs it on an ``ALSServingModelManager``
(``manager.model = ALSServingModel(state)``, which builds the device
view), so no artifact is written. The layer starts from configuration on
a ``mem://`` bus, and a child process (``portbench/client.py``) drives
the traffic mix: a warm-up, then the measured window. Afterwards the
model is closed and freed, and a sample of the window's answers, drawn
from the seed, is held to the plain reference
(``portbench/reference/topn.py``).
"""

from __future__ import annotations

import gc
import json
import re
import subprocess
import sys
import time
import urllib.error
import urllib.request
from contextlib import contextmanager

import numpy as np

from portbench import gen
from portbench import harness
from portbench.harness import BENCH_DIR, ROOT
from portbench.reference import topn
from portbench.systems import Outcome, Setup, cpu_s, span_ns

PHASE_RE = re.compile(r'^oryx_request_phase_seconds_(sum|count)\{[^}]*phase="([a-z_]+)"[^}]*\}\s+(\S+)')


def phase_totals(port: int) -> dict:
    """{phase: [seconds, count]} from the layer's /metrics."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=60) as r:
        text = r.read().decode()
    out: dict = {}
    for line in text.splitlines():
        m = PHASE_RE.match(line)
        if m:
            kind, phase, val = m.groups()
            out.setdefault(phase, [0.0, 0.0])[0 if kind == "sum" else 1] += float(val)
    return out


def _status(port: int, path: str) -> int:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def overlay(cfg: dict, broker: str, scratch) -> dict:
    from oryx_tpu_torch.apps.spi import app_overlay

    out = dict(app_overlay("als"))
    out.update(cfg.get("overlay", {}))
    out.update({
        "oryx.update-topic.broker": broker,
        "oryx.input-topic.broker": broker,
        "oryx.serving.api.port": 0,
        "oryx.monitoring.flight.dir": str(scratch / "flight"),
    })
    return out


def start_layer(cfg: dict, state, device, scratch, setup: Setup):
    """The ServingLayer over ``state``, installed directly, /ready 200."""
    from oryx_tpu_torch.apps.als.serving import ALSServingModel, ALSServingModelManager
    from oryx_tpu_torch.bus import topic_admin
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.serving.server import ServingLayer

    broker = "mem://portbench"
    config = load_config(overlay=overlay(cfg, broker, scratch))
    for which in ("input", "update"):
        topic_admin.maybe_create(broker, config.get_string(f"oryx.{which}-topic.message.topic"))
    manager = ALSServingModelManager(config, device=device)
    with setup.piece("device_view"):
        manager.model = ALSServingModel(
            state, approx_recall=manager.als.approx_recall, sync=manager.sync,
            score_mode=manager.score_mode, device=manager.device,
            sample_rate=manager.als.sample_rate,
            num_cores=manager.als.candidate_partitions or None,
            lsh_max_bits_differing=manager.als.lsh_max_bits_differing)
    with setup.piece("server_start"):
        layer = ServingLayer(config, model_manager=manager)
        layer.start()
        t0 = time.monotonic()
        while _status(layer.port, "/ready") != 200:
            if time.monotonic() - t0 > 120:
                layer.close()
                raise RuntimeError("/ready did not answer 200 within 120 s")
            time.sleep(0.05)
    return layer, manager


@contextmanager
def collector_spans():
    """The interpreter's full (generation 2) collections while inside, as
    (name, start_ns, end_ns): every thread of the layer waits them out."""
    spans: list = []
    start: list = []

    def hook(phase, info):
        if info.get("generation") != 2:
            return
        if phase == "start":
            start.append(time.monotonic_ns())
        elif start:
            spans.append(("gc full collection", start.pop(), time.monotonic_ns()))

    gc.callbacks.append(hook)
    try:
        yield spans
    finally:
        gc.callbacks.remove(hook)


class Client:
    """The load-generator child process."""

    def __init__(self, port: int, traffic: dict, users: int, seed: int, how_many: int):
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "portbench.client"], cwd=str(ROOT),
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        path = traffic["path"].replace("{how_many}", str(how_many))
        self._send(json.dumps({"port": port, "clients": traffic["clients"],
                               "path": path, "users": users, "seed": seed}))
        if self.proc.stdout.readline().strip() != "ready":
            raise RuntimeError("the load generator did not start")

    def _send(self, line: str) -> None:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()

    def run(self, seconds: float, keep: bool) -> dict:
        self._send(f"run {seconds} {int(keep)}")
        line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the load generator exited {self.proc.wait()}")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self._send("quit")
                self.proc.wait(timeout=60)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def _served(body: str | None, how_many: int) -> tuple[np.ndarray, np.ndarray]:
    """Item indices (-1 where missing or unreadable) and scores of one
    answer."""
    ids = np.full(how_many, -1, dtype=np.int64)
    scores = np.full(how_many, np.nan)
    try:
        pairs = json.loads(body)
        for j, (ident, score) in enumerate(pairs[:how_many]):
            ids[j] = int(ident[1:]) if ident.startswith("i") else -1
            scores[j] = float(score)
    except (TypeError, ValueError, KeyError, IndexError, AttributeError):
        pass
    return ids, scores


def run(spec) -> Outcome:
    import torch

    from oryx_tpu_torch.apps.als.state import state_from_arrays
    from oryx_tpu_torch.serving.batcher import TopKBatcher

    from portbench.trace import DeviceTrace

    cfg, traffic, seed, device = spec.cell.config, spec.cell.traffic, spec.seed, spec.device
    n_items, n_users, f = cfg["items"], cfg["users"], cfg["features"]
    how_many = int(traffic["how_many"])
    # the counts of the view this mode streams; a mode they do not know
    # raises here, before set-up, and is never counted as another
    score_mode = cfg["overlay"]["oryx.serving.api.score-mode"]
    harness.counts("topk").view(score_mode)
    setup = spec.setup
    scratch = BENCH_DIR.parent / "build" / "portbench"
    with setup.piece("factors"):
        y = gen.factor_table(seed, "Y", n_items, f, device)
        x = gen.factor_table(seed, "X", n_users, f, device)
        known = gen.known_items(seed, n_users, n_items, cfg["known_items_per_user"], device)
    with setup.piece("ids"):
        x_ids = [f"u{j}" for j in range(n_users)]
        y_ids = [f"i{j}" for j in range(n_items)]
    with setup.piece("state"):
        state = state_from_arrays(f, bool(cfg["implicit"]), x_ids, x, y_ids, y)
        del x, y
    with setup.piece("known_items"):
        names = np.char.add("i", known.astype(str)).tolist()
        for user, row in zip(x_ids, names):
            state.add_known_items(user, row)
    # the program keeps its own id lists: these copies would only add to
    # what the interpreter's collector walks during the window
    del names, x_ids, y_ids
    layer, manager = start_layer(cfg, state, device, scratch, setup)
    del state
    if manager.model.score_mode != score_mode:
        layer.close()
        raise ValueError(f"the layer serves score mode {manager.model.score_mode!r}, "
                         f"the configuration states {score_mode!r}")
    client = None
    try:
        with setup.piece("client_start"):
            client = Client(layer.port, traffic, n_users, seed, how_many)
        with setup.piece("warmup"):
            client.run(float(traffic["warmup_s"]), keep=False)
        with setup.piece("collect"):
            # every window starts one full collection after the last, so the
            # collections the window meets fall alike in every run
            gc.collect()
        batcher = TopKBatcher.shared()
        d0, c0 = batcher.dispatches, batcher.coalesced
        ph0 = phase_totals(layer.port)
        setup.close()
        cpu0 = cpu_s()
        with DeviceTrace(torch, spec.trace) as tr, collector_spans() as gc_spans:
            res = client.run(spec.seconds, keep=True)
        server_cpu_s = cpu_s() - cpu0
        d1, c1 = batcher.dispatches, batcher.coalesced
        ph1 = phase_totals(layer.port)
        timeline = gc_spans + [(f"dispatcher {p}", span_ns(a), span_ns(b))
                               for p, a, b in list(batcher.timeline)]
        peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    finally:
        if client is not None:
            client.close()
        layer.close()
    del layer, manager
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    rows, t_start, t_end = res["rows"], res["t_start"], res["t_end"]
    window = t_end - t_start
    ok = [r for r in rows if r[1] == 200]
    answered = sum(1 for r in ok if r[3] <= t_end)
    lat = np.array([(r[3] - r[2]) * 1e3 for r in rows])
    phases = {p: [ph1.get(p, [0, 0])[0] - ph0.get(p, [0, 0])[0],
                  ph1.get(p, [0, 0])[1] - ph0.get(p, [0, 0])[1]] for p in ph1}

    # the check: a sample of the window's answers, drawn from the seed
    rng = np.random.default_rng(gen.subseed(seed, "check"))
    take = rng.choice(len(ok), size=min(len(ok), int(traffic["check_requests"])), replace=False)
    sample = [ok[j] for j in sorted(take)]
    users = np.array([r[0] for r in sample], dtype=np.int64)
    got = [_served(r[4], how_many) for r in sample]
    served_ids = np.stack([g[0] for g in got]) if got else np.zeros((0, how_many), np.int64)
    served_scores = np.stack([g[1] for g in got]) if got else np.zeros((0, how_many))
    t_check = time.monotonic()
    ref, served_true, _ = topn.reference_scores(seed, cfg, users, served_ids, how_many, device)
    checks = topn.judge(ref, served_ids, served_scores, served_true,
                        known[users], how_many) if got else {"score_err": float("inf")}
    check_s = time.monotonic() - t_check
    return Outcome(
        end_to_end={
            "recommend_qps": answered / window,
            "peak_mem_gib": peak / 2 ** 30,
        },
        attempted=len(rows), failed=len(rows) - len(ok), memory_peak_bytes=peak,
        checks=checks, trace=tr if spec.trace else None,
        spans=timeline,
        counters={
            "window_s": window, "answers": answered, "requests": len(rows),
            "dispatches": d1 - d0, "rows": c1 - c0, "phases": phases,
            "items": n_items, "features": f, "score_mode": score_mode,
            "k": selected_k(how_many, cfg["known_items_per_user"]),
            "check_s": check_s, "checked": len(sample),
            **{f"latency_p{q}_ms": float(np.percentile(lat, q)) for q in (50, 90, 95, 99)},
            "latency_max_ms": float(lat.max()) if lat.size else 0.0,
            "latency_mean_ms": float(lat.mean()) if lat.size else 0.0,
            "gc_full_collections": len(gc_spans),
            "gc_full_s": sum(b - a for _, a, b in gc_spans) / 1e9,
            "server_cpu_s": server_cpu_s, "client_cpu_s": res["cpu_s"],
        },
    )


def selected_k(how_many: int, known: int) -> int:
    """The candidates a /recommend dispatch selects a row: its over-fetch
    (how_many + known + 8) rounded up to a power of two, at least 16."""
    return max(16, 1 << (how_many + known + 8 - 1).bit_length())
