"""The port deployed as separate OS processes, on the CPU because the
caller asks for it (``oryx.compute.platform = cpu``): a batch build killed
mid-training resumes from its checkpoint in a fresh process
(tests/test_multiprocess_e2e.py), and the ALS lambda loop runs as
``python -m oryx_tpu_torch.cli`` processes joined only by kafka:// topics
on the port's test broker: setup, input, a batch generation published in
chunks, two serving replicas on one port, the speed layer folding events
(one of them inside a gzip batch of a foreign producer), tail.
"""

from __future__ import annotations

import gzip
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from e2e_common import http_request as _http
from oryx_tpu_torch.common.ioutil import choose_free_port

ROOT = Path(__file__).resolve().parents[1]


def test_batch_build_killed_and_resumed(tmp_path):
    """A batch build that dies between checkpoint writes resumes from the
    last checkpointed sweep in a fresh process, through ALSUpdate built
    from config (the operator's platform switch puts it on the CPU)."""
    worker = """
import sys, os, logging
logging.basicConfig(level=logging.INFO, stream=sys.stderr)
sys.path.insert(0, sys.argv[3])
import numpy as np
from oryx_tpu_torch import device
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.rng import RandomManager
from oryx_tpu_torch.apps.als.batch import ALSUpdate
from oryx_tpu_torch.bus.api import KeyMessage
device.set_platform("cpu")
td = sys.argv[1]
cfg = load_config(overlay={
    "oryx.batch.storage.model-dir": td + "/models",
    "oryx.als.hyperparams.features": 8,
    "oryx.als.hyperparams.iterations": 6,
    "oryx.als.checkpoint-interval": 2,
    "oryx.ml.eval.test-fraction": 0.0,
})
RandomManager.use_test_seed(77)
rng = np.random.default_rng(1)
lines = [KeyMessage(None, f"u{u},i{i},1,{j}") for j, (u, i) in enumerate(
    zip(rng.integers(0, 200, 8000), rng.integers(0, 150, 8000)))]
upd = ALSUpdate(cfg)
if sys.argv[2] == "abort":
    import oryx_tpu_torch.ops.als as als
    orig = als.train_als
    calls = {"n": 0}
    def wrapped(*a, **k):
        m = orig(*a, **k)
        calls["n"] += 1
        if calls["n"] == 2:
            os._exit(9)  # die between chunk 2's compute and its checkpoint
        return m
    als.train_als = wrapped
art = upd.build_model(lines, {"features": 8, "lambda": 0.001, "alpha": 1.0})
print("BUILD_OK", art.tensors["X"].shape, flush=True)
"""
    p1 = subprocess.run([sys.executable, "-c", worker, str(tmp_path), "abort", str(ROOT)],
                        capture_output=True, text=True, timeout=150)
    assert p1.returncode == 9, (p1.returncode, p1.stderr[-500:])
    ck = tmp_path / "models" / ".als-checkpoint"
    cks = list(ck.rglob("als-train.ckpt.npz"))
    assert cks, "no checkpoint left behind by the killed build"
    with np.load(cks[0]) as z:
        assert int(z["done"]) == 2
    p2 = subprocess.run([sys.executable, "-c", worker, str(tmp_path), "run", str(ROOT)],
                        capture_output=True, text=True, timeout=150)
    assert p2.returncode == 0 and "BUILD_OK" in p2.stdout, p2.stderr[-500:]
    assert "resuming ALS build from checkpoint: 2/6" in p2.stderr, p2.stderr[-500:]
    assert not list(ck.rglob("als-train.ckpt.npz"))  # consumed on success


def _get(url):
    """(status, body), or (None, None) while nothing listens."""
    try:
        return _http("GET", url)
    except OSError:
        return None, None


def _on_one_replica(port: int, path: str) -> tuple:
    """(replica name, status) of GET /healthz and then GET path on one
    keep-alive connection, so one replica answers both."""
    import http.client

    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request("GET", "/healthz")
        name = json.loads(c.getresponse().read()).get("replica")
        c.request("GET", path)
        r = c.getresponse()
        r.read()
        return name, r.status
    except (OSError, ValueError):
        return None, None
    finally:
        c.close()


def _cli(*args, **kw) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch.cli", *args], cwd=ROOT,
        start_new_session=True, **kw)


def _until(pred, what, limit=120, procs=()):
    deadline = time.time() + limit
    while time.time() < deadline:
        for name, p in procs:
            if p.poll() is not None:
                raise AssertionError(f"{name} exited {p.returncode} while {what}")
        got = pred()
        if got:
            return got
        time.sleep(0.2)
    raise AssertionError(f"timed out: {what}")


def test_lambda_over_kafka_through_cli_processes(tmp_path):
    from oryx_tpu_torch.bus import kafkawire
    from oryx_tpu_torch.bus.broker import get_broker
    from tests.test_torch_kafka import _foreign_batch
    from tests.torch_kafka_testbroker import LocalKafkaTestBroker

    port = choose_free_port()
    rng = np.random.default_rng(4)
    events = [f"u{u},i{i},1,{1000 + j}" for j, (u, i) in enumerate(
        zip(rng.integers(0, 60, 1500), rng.integers(0, 40, 1500)))]
    procs: list[tuple[str, subprocess.Popen]] = []
    with LocalKafkaTestBroker() as srv:
        conf = tmp_path / "oryx.conf"
        conf.write_text(f'''
oryx.id = mp-kafka
oryx.input-topic.broker = "{srv.uri}"
oryx.update-topic.broker = "{srv.uri}"
oryx.update-topic.message.max-size = 1024
oryx.batch.storage.data-dir = "{tmp_path / 'data'}"
oryx.batch.storage.model-dir = "{tmp_path / 'model'}"
oryx.monitoring.flight.dir = "{tmp_path / 'flight'}"
oryx.monitoring.quarantine.dir = "{tmp_path / 'quarantine'}"
oryx.serving.api.port = {port}
oryx.serving.api.processes = 2
oryx.serving.min-model-load-fraction = 1.0
oryx.speed.min-model-load-fraction = 1.0
oryx.batch.streaming.generation-interval-sec = 3
oryx.speed.streaming.generation-interval-sec = 1
oryx.als.hyperparams.features = 4
oryx.als.hyperparams.iterations = 3
oryx.ml.eval.test-fraction = 0.1
oryx.compute.platform = cpu
''')
        flags = ["--app", "als", "--conf", str(conf)]
        assert subprocess.run([sys.executable, "-m", "oryx_tpu_torch.cli", "setup",
                               *flags], cwd=ROOT, timeout=60).returncode == 0
        broker = get_broker(srv.uri)
        assert broker.num_partitions("OryxInput") == 4
        pump = subprocess.run([sys.executable, "-m", "oryx_tpu_torch.cli", "input",
                               *flags], cwd=ROOT, input="\n".join(events), text=True,
                              capture_output=True, timeout=60)
        assert pump.returncode == 0 and "sent 1500 lines" in pump.stderr
        # the batch group starts at the earliest offset (what an operator's
        # reset of the group to earliest does), so its first generation
        # reads the events written before it started
        broker.commit_offsets("OryxGroup-mp-kafka-batch", "OryxInput",
                              {p: 0 for p in range(4)})
        tail = _cli("tail", *flags, stdout=subprocess.PIPE, text=True,
                    stderr=subprocess.DEVNULL)
        try:
            batch = _cli("batch", *flags, stderr=subprocess.DEVNULL)
            procs.append(("batch", batch))
            keys = lambda: [k for _, k, _ in broker.read("OryxUpdate", 0, 0, 100_000)]
            # the generation is out once its MODEL-REF and a factor row for
            # every user and item are (60 + 40); the next one is 3 s away
            _until(lambda: "MODEL-REF" in keys() and keys().count("UP") >= 100,
                   "the generation publishes", procs=procs)
            os.killpg(batch.pid, signal.SIGTERM)
            assert batch.wait(timeout=60) == 0
            procs.remove(("batch", batch))
            assert keys().count("MODEL-CHUNK") > 1

            serving = _cli("serving", *flags, stderr=subprocess.DEVNULL)
            speed = _cli("speed", *flags, stderr=subprocess.DEVNULL)
            procs += [("serving", serving), ("speed", speed)]
            base = f"http://127.0.0.1:{port}"
            replicas: dict[str, int] = {}

            def both_ready():
                name, status = _on_one_replica(port, "/ready")
                if status == 200:
                    replicas[name] = 1
                return len(replicas) == 2

            _until(both_ready, "both replicas ready", procs=procs)
            status, body = _http("GET", f"{base}/recommend/u5?howMany=3")
            assert status == 200 and len(json.loads(body)) == 3

            # a probe event per second until the speed layer folds one:
            # it drops events until its model has loaded
            def folded(user):
                return any(k == "UP" and json.loads(m)[:2] == ["X", user]
                           for _, k, m in broker.read("OryxUpdate", 0, 0, 100_000))

            probes = iter(range(1, 1000))

            def probe():
                user = f"u-probe-{next(probes)}"
                broker.send("OryxInput", None, f"{user},i1,1,5")
                deadline = time.time() + 3
                while time.time() < deadline:
                    if folded(user):
                        return True
                    time.sleep(0.2)
                return False

            _until(probe, "the speed layer folds a probe", procs=procs)
            srv.append_raw_batch("OryxInput", 0, _foreign_batch(
                kafkawire, [(None, b"u-gzip,i2,3,9")], 1, gzip.compress))
            assert subprocess.run(
                [sys.executable, "-m", "oryx_tpu_torch.cli", "input", *flags],
                cwd=ROOT, input="u-new,i3,3,7\n", text=True, timeout=60,
                capture_output=True).returncode == 0
            for user in ("u-new", "u-gzip"):
                seen: set[str] = set()

                def served(user=user, seen=seen):
                    name, status = _on_one_replica(port, f"/recommend/{user}?howMany=3")
                    if status == 200:
                        seen.add(name)
                    return len(seen) == 2

                _until(served, f"{user} served by both replicas", procs=procs)
        finally:
            for _, p in procs:
                try:
                    os.killpg(p.pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
            for _, p in procs:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    os.killpg(p.pid, signal.SIGKILL)
            tail.send_signal(signal.SIGINT)
            out, _ = tail.communicate(timeout=30)
    lines = out.splitlines()
    assert any(x.startswith("OryxUpdate\tMODEL-REF\t") for x in lines)
    assert any(x.startswith("OryxUpdate\tUP\t") for x in lines)
    assert any(x.startswith("OryxInput\tNone\tu-probe-") for x in lines)
