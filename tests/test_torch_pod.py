"""The port's pod: tests/test_multihost.py's pod cases and
tests/test_pod_cli.py's cases with gloo ranks on the CPU.

Each multi-process case spawns OS processes that join one
``torch.distributed`` process group over 127.0.0.1 (gloo), each holding
its own CPU cells of the pod's mesh:

- the pod-agreed batch window: both edges, from the leader's row;
- the process-group candidate search: one candidate per process group,
  scores gathered pod-wide, the winner shipped to members that did not
  build it, equal to the serial lockstep winner;
- three processes split into groups [0, 1] and [2] (a group spanning two
  processes beside one that does not) without a hang;
- the collectives across processes: int64 values round-trip the host
  all-gather, the default-seeded trainer starts every process from one Y,
  and the ring crosses the process boundary;
- ``cli pod``: two compute ranks and a serving child over a file:// bus.
The window and search cases run the JAX package's members (jax.distributed
over CPU processes, two virtual devices each) beside the port's on the
same bus layout and messages, and hold the port to them: the same records
and timestamp, the same groups, the same winner, eval scores within
SCORE_TOL. Winners are exact (a lambda string); numbers carry their
tolerance.
"""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

from oryx_tpu_torch import cli
from oryx_tpu_torch.common.ioutil import choose_free_port

ROOT = str(pathlib.Path(__file__).resolve().parent.parent)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_env() -> dict:
    """The JAX package's CPU worker env: two virtual devices per process."""
    from oryx_tpu.common.executil import cpu_subprocess_env

    env = cpu_subprocess_env(dict(os.environ))
    flags = [f for f in env.get("XLA_FLAGS", "").split()
             if "xla_force_host_platform_device_count" not in f]
    env["XLA_FLAGS"] = " ".join(
        flags + ["--xla_force_host_platform_device_count=2"])
    return env


def _run_ranks(worker: str, n: int, *extra: str, timeout: int = 240,
               jax_worker: str | None = None, jax_extra: tuple = ()) -> None:
    """Run ``worker`` as ranks 0..n-1 of one gloo group and then, given
    ``jax_worker``, the JAX package's members as ranks 0..n-1 of a pod of
    their own; every rank must exit 0 and print its ``_OK <rank>``
    marker."""
    sets = [(worker, extra, dict(os.environ, OMP_NUM_THREADS="1"))]
    if jax_worker is not None:
        sets.append((jax_worker, jax_extra, _jax_env()))
    for code, args, env in sets:
        port = _free_port()
        procs = [
            subprocess.Popen(
                [sys.executable, "-c", code, str(i), str(n), str(port), ROOT,
                 *args],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            )
            for i in range(n)
        ]
        outs = []
        try:
            for p in procs:
                out, _ = p.communicate(timeout=timeout)
                outs.append(out)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for i, (p, out) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {i} failed:\n{out[-3000:]}"
            assert f"_OK {i}" in out, out[-3000:]


def _records(tmp, tag: str, n: int) -> list:
    """Each rank's ``{tmp}/{tag}-{rank}.json``."""
    out = []
    for i in range(n):
        with open(pathlib.Path(tmp) / f"{tag}-{i}.json") as f:
            out.append(json.load(f))
    return out


_PROLOGUE = r'''
import sys

sys.path.insert(0, sys.argv[4])
import json

import numpy as np

from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.parallel.distributed import (
    global_mesh, host_allgather, init_distributed, shutdown_distributed,
)
from oryx_tpu_torch.parallel.mesh import MeshSpec

pid, nprocs, port, root, tmp = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
)
POD = {
    "oryx.compute.distributed.coordinator-address": f"127.0.0.1:{port}",
    "oryx.compute.distributed.num-processes": nprocs,
    "oryx.compute.distributed.process-id": pid,
}
'''

# the JAX package's member: the same argv, the same POD keys, its own
# modules (two virtual CPU devices per process, from _jax_env)
_JAX_PROLOGUE = _PROLOGUE.replace(
    "import json\n", "import json\n\nimport jax\n\n"
    "jax.config.update(\"jax_platforms\", \"cpu\")\n", 1
).replace(" shutdown_distributed,", "").replace("oryx_tpu_torch.", "oryx_tpu.")

# the pod window: each member writes the (timestamp, records) it was handed
_WINDOW_BODY = r'''
from PKG.api import BatchLayerUpdate
from PKG.bus.broker import get_broker
from PKG.layers.batch import BatchLayer

uri = f"file://{tmp}/bus"
cfg = load_config(overlay={
    "oryx.id": "podwin",
    "oryx.input-topic.broker": uri,
    "oryx.input-topic.message.topic": "OryxInput",
    "oryx.update-topic.broker": uri,
    "oryx.update-topic.message.topic": "OryxUpdate",
    "oryx.batch.streaming.generation-interval-sec": 3600,
    "oryx.batch.storage.data-dir": f"{tmp}/data",
    "oryx.batch.storage.model-dir": f"{tmp}/model",
    **POD,
})
assert init_distributed(cfg) is True


class Captures(BatchLayerUpdate):
    def __init__(self, *a):
        self.windows = []

    def run_update(self, ts, new_data, past_data, model_dir, producer):
        self.windows.append((ts, [m.message for m in new_data]))


up = Captures()
layer = BatchLayer(cfg, update=up)
if pid == 0:
    # the leader consumed records 0-1 in an earlier life: its group has a
    # durable commit at offset 2
    get_broker(uri).commit_offsets("OryxGroup-podwin-batch", "OryxInput", {0: 2})
layer.ensure_streams()
# the non-leader's fresh per-process group resolves start='committed' to
# its OWN log end (10): WITHOUT the pod-agreed start seek it would see an
# empty window while the leader processes records 2..9. Each member's
# timer fired at another instant; the leader's timestamp wins.
layer.run_generation(timestamp_ms=1_700_000_000_123 + pid)
ts, window = up.windows[0]
with open(f"{tmp}/window-{pid}.json", "w") as f:
    json.dump({"ts": ts, "window": window}, f)
'''

_POD_WINDOW_WORKER = _PROLOGUE + _WINDOW_BODY.replace("PKG", "oryx_tpu_torch") + r'''
assert ts == 1_700_000_000_123, ts
assert window == [f"r{i}" for i in range(2, 10)], f"pid {pid}: {window}"
lens = host_allgather(np.int64(len(window)))
assert lens.ravel().tolist() == [8, 8], lens
layer.close()
shutdown_distributed()
print(f"PODWINDOW_OK {pid}", flush=True)
'''
_JAX_POD_WINDOW_WORKER = _JAX_PROLOGUE + _WINDOW_BODY.replace(
    "PKG", "oryx_tpu") + 'print(f"PODWINDOW_OK {pid}", flush=True)\n'


def test_pod_window_agrees_both_edges(tmp_path):
    """Two gloo ranks over a shared file:// bus: the leader's group has a
    durable commit at offset 2, the non-leader starts fresh after 10
    records exist and its timer fires a millisecond later — both process
    exactly records 2..9 under the leader's timestamp (past 2**31 ms).
    The JAX package's two members, on a bus laid out the same way, hand
    each member the same records under the same timestamp."""
    from oryx_tpu_torch.bus.broker import get_broker, topics

    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
        uri = f"file://{tmp_path / pkg / 'bus'}"
        topics.maybe_create(uri, "OryxInput", partitions=1)
        topics.maybe_create(uri, "OryxUpdate", partitions=1)
        broker = get_broker(uri)
        for i in range(10):
            broker.send("OryxInput", None, f"r{i}")
    _run_ranks(_POD_WINDOW_WORKER, 2, str(tmp_path / "port"),
               jax_worker=_JAX_POD_WINDOW_WORKER,
               jax_extra=(str(tmp_path / "jax"),))
    port = _records(tmp_path / "port", "window", 2)
    assert port == _records(tmp_path / "jax", "window", 2)
    assert port == [{"ts": 1_700_000_000_123,
                     "window": [f"r{i}" for i in range(2, 10)]}] * 2


# the candidate search: each member writes, per run, the candidates it
# built (lambda, the processes and shape of its sub-mesh), each one's eval
# score, and the published winner's lambda
_SEARCH_BODY = r'''
from PKG.apps.als.batch import ALSUpdate
from PKG.bus.api import KeyMessage, TopicProducer
from PKG.bus.broker import get_broker
from PKG.parallel.submesh import current_candidate_mesh

base = {
    "oryx.id": "podsearch",
    "oryx.ml.eval.candidates": 2,
    "oryx.ml.eval.hyperparam-search": "grid",
    "oryx.ml.eval.test-fraction": 0.2,
    "oryx.als.hyperparams.features": 8,
    "oryx.als.hyperparams.iterations": 3,
    "oryx.als.hyperparams.alpha": 10.0,
    "oryx.als.hyperparams.lambda": [0.01, 500.0],
    "oryx.als.no-known-items": True,
    **POD,
}
assert init_distributed(load_config(overlay=base)) is True

# identical input on every member (the pod agrees the window in real runs)
rng = np.random.default_rng(17)
msgs = []
for j in range(1000):
    u = int(rng.integers(0, 40))
    i = (u % 3) * 10 + int(rng.integers(0, 10))
    msgs.append(KeyMessage(None, f"u{u},i{i},1,{j}"))

built = []
scores = {}


class Spy(ALSUpdate):
    def build_model(self, train, hyperparams):
        built.append((float(hyperparams["lambda"]), current_candidate_mesh()))
        return super().build_model(train, hyperparams)

    def _build_one(self, i, *a):
        score, path = super()._build_one(i, *a)
        scores[i] = score
        return score, path


def run(mesh, parallelism, tag):
    built.clear()
    scores.clear()
    over = dict(base)
    over["oryx.ml.eval.parallelism"] = parallelism
    broker = get_broker(f"mem://podsearch-{pid}-{tag}")
    broker.create_topic("U", partitions=1)
    upd = Spy(load_config(overlay=over), mesh=mesh, **KW)
    upd.run_update(2000, msgs, [], f"{tmp}/p{pid}-model-{tag}",
                   TopicProducer(broker, "U"))
    recs = broker.read("U", 0, 0, 100_000)
    model = [m for _, k, m in recs if k == "MODEL"]
    assert model, recs[:5]
    if pid == 0:
        with open(f"{tmp}/published-{tag}.json", "w") as f:
            json.dump([[k, m] for _, k, m in recs if k in ("MODEL", "UP")], f)
    winner = json.loads(model[0])["extensions"]["lambda"]
    with open(f"{tmp}/{tag}-{pid}.json", "w") as f:
        json.dump({
            "built": [[lam, owners(sub), shape(sub)] for lam, sub in built],
            "scores": {str(i): s for i, s in sorted(scores.items())},
            "winner": winner,
        }, f)
    return winner, model[0]
'''

_SEARCH_PROLOGUE = _PROLOGUE + _SEARCH_BODY.replace("PKG", "oryx_tpu_torch") + r'''
KW = {"device": "cpu"}


def owners(sub):
    return None if sub is None else sorted(set(sub.row_process))


def shape(sub):
    return None if sub is None else list(sub.devices.shape)
'''

_JAX_SEARCH_PROLOGUE = _JAX_PROLOGUE + _SEARCH_BODY.replace("PKG", "oryx_tpu") + r'''
KW = {}


def owners(sub):
    return None if sub is None else sorted(
        {d.process_index for d in sub.devices.ravel()})


def shape(sub):
    return None if sub is None else list(sub.devices.shape)
'''

# the eval scores of the two packages' candidates: both draw the same
# train/test split from the same seeds, but their factor inits come from
# different generators (numpy/torch against jax.random), so after three
# sweeps the AUCs agree to this much, not bit for bit
SCORE_TOL = 0.02


def _same_search(tmp, tag: str, n: int) -> list:
    """Assert that the port's and the JAX package's members of run ``tag``
    built the same candidates on the same groups, scored them alike and
    published the same winner; the port's records."""
    port = _records(tmp / "port", tag, n)
    ref = _records(tmp / "jax", tag, n)
    for pid, (a, b) in enumerate(zip(port, ref)):
        assert a["built"] == b["built"], (pid, a["built"], b["built"])
        assert a["winner"] == b["winner"], (pid, a["winner"], b["winner"])
        assert a["scores"].keys() == b["scores"].keys(), pid
        for i, s in a["scores"].items():
            assert abs(s - b["scores"][i]) <= SCORE_TOL, (pid, i, s, b["scores"][i])
    return port


_POD_PARALLEL_BODY = r'''
mesh = global_mesh(MeshSpec(data=2, model=2), CELLS)
par, art_par = run(mesh, 2, "par")
# each member built exactly ONE candidate — its process group's — on its
# own (1 data x 2 model) slice of the pod
assert len(built) == 1, built
lam, sub = built[0]
assert sub is not None and shape(sub) == [1, 2], shape(sub)
assert owners(sub) == [pid]
assert lam == (0.01 if pid == 0 else 500.0), (pid, lam)

ser, art_ser = run(mesh, 1, "ser")
# serial lockstep: every member builds every candidate on the full mesh
assert [l for l, _ in built] == [0.01, 500.0], built
assert all(m is None for _, m in built), built

# the winner is the same across modes and members — and process 1 holds
# the winning artifact only because _fetch_winner shipped it over: both
# members publish the same bytes
assert par == ser == "0.01", (par, ser)
'''

_POD_PARALLEL_WORKER = _SEARCH_PROLOGUE + 'CELLS = ["cpu", "cpu"]\n' + _POD_PARALLEL_BODY + r'''
import hashlib

assert sub.row_process == (pid,) and not sub.spans_processes
digests = host_allgather(np.frombuffer(hashlib.sha256(art_par.encode()).digest(),
                                       np.uint8))
assert (digests[0] == digests[1]).all()
shutdown_distributed()
print(f"PODPAR_OK {pid}", flush=True)
'''

_JAX_POD_PARALLEL_WORKER = _JAX_SEARCH_PROLOGUE + "CELLS = None\n" + _POD_PARALLEL_BODY.replace(
    "global_mesh(MeshSpec(data=2, model=2), CELLS)",
    "global_mesh(MeshSpec(data=2, model=2))",
) + 'print(f"PODPAR_OK {pid}", flush=True)\n'


def _published(records) -> tuple:
    """(MODEL messages, {(kind, id): vector}) of a publish's records."""
    ups = {}
    for k, m in records:
        if k == "UP":
            row = json.loads(m)
            ups[(row[0], row[1])] = row[2]
    return [m for k, m in records if k == "MODEL"], ups


def test_two_process_pod_parallel_candidates(tmp_path):
    """Two gloo ranks x 2 CPU cells: the pod searches its two candidates
    in parallel, one per process group on its own slice of the mesh, and
    publishes the serial lockstep search's winner (each candidate is
    seeded from the generation and its index, whichever member builds
    it); the member that did not build the winner publishes the building
    member's artifact byte for byte. The JAX package's two members, on the
    same messages, build the same candidate on the same group in each
    mode, score each within SCORE_TOL and publish the same winner. One
    process that seeds each candidate as a member does
    (``MLUpdate._pod_candidate_seed``) and builds them serially on the
    group's mesh shape publishes the same model: the same MODEL message
    and every factor row within 1e-6 (the UP rows carry 6 decimals)."""
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
    _run_ranks(_POD_PARALLEL_WORKER, 2, str(tmp_path / "port"), timeout=420,
               jax_worker=_JAX_POD_PARALLEL_WORKER,
               jax_extra=(str(tmp_path / "jax"),))
    par = _same_search(tmp_path, "par", 2)
    ser = _same_search(tmp_path, "ser", 2)
    # the group search gathers the scores its serial twin computes
    assert {i: s for r in par for i, s in r["scores"].items()} == ser[0]["scores"]

    import numpy as np

    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer
    from oryx_tpu_torch.bus.inproc import InProcBroker
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.rng import RandomManager
    from oryx_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    class SerialPodSearch(ALSUpdate):
        """The pod's search in one process: the generation seeded as a pod
        member seeds it (the pod config), each candidate as well."""

        def _build_one(self, i, *a):
            RandomManager.use_test_seed(self._pod_candidate_seed(2000, i))
            return super()._build_one(i, *a)

    rng = np.random.default_rng(17)
    msgs = []
    for j in range(1000):
        u = int(rng.integers(0, 40))
        i = (u % 3) * 10 + int(rng.integers(0, 10))
        msgs.append(KeyMessage(None, f"u{u},i{i},1,{j}"))
    broker = InProcBroker()
    broker.create_topic("U", partitions=1)
    upd = SerialPodSearch(load_config(overlay={
        "oryx.id": "podsearch", "oryx.ml.eval.candidates": 2,
        "oryx.ml.eval.parallelism": 1, "oryx.ml.eval.hyperparam-search": "grid",
        "oryx.ml.eval.test-fraction": 0.2, "oryx.als.hyperparams.features": 8,
        "oryx.als.hyperparams.iterations": 3, "oryx.als.hyperparams.alpha": 10.0,
        "oryx.als.hyperparams.lambda": [0.01, 500.0],
        "oryx.als.no-known-items": True,
        "oryx.compute.distributed.num-processes": 2,
    }), device="cpu", mesh=make_mesh(MeshSpec(1, 2), ["cpu", "cpu"]))
    upd.run_update(2000, msgs, [], str(tmp_path / "one-process"),
                   TopicProducer(broker, "U"))
    ref_models, ref_ups = _published(
        [(k, m) for _, k, m in broker.read("U", 0, 0, 100_000)])
    with open(tmp_path / "port" / "published-par.json") as f:
        pod_models, pod_ups = _published(json.load(f))
    assert pod_models == ref_models
    assert pod_ups.keys() == ref_ups.keys()
    for key, vec in ref_ups.items():
        np.testing.assert_allclose(pod_ups[key], vec, rtol=0, atol=1e-6)


_POD_UNEVEN_BODY = r'''
# 3 processes x 2 local cells; the model axis inside a process -> data 3
mesh = global_mesh(MeshSpec(data=3, model=2), CELLS)
winner, _ = run(mesh, 2, "uneven")
# groups over 3 processes at parallelism 2: [[0, 1], [2]] — candidate 0
# (lambda 0.01) trains on a sub-mesh SPANNING processes 0 and 1 (its sums
# and gathers cross the process boundary inside their own process group),
# candidate 1 on process 2 alone
assert len(built) == 1, built
lam, sub = built[0]
assert lam == (0.01 if pid in (0, 1) else 500.0), (pid, lam)
assert owners(sub) == ([0, 1] if pid in (0, 1) else [2]), owners(sub)
assert shape(sub) == ([2, 2] if pid in (0, 1) else [1, 2])
# the winner agreed pod-wide; process 2 got it over the broadcast
assert winner == "0.01", winner
'''

_POD_UNEVEN_WORKER = _SEARCH_PROLOGUE + 'CELLS = ["cpu", "cpu"]\n' + _POD_UNEVEN_BODY + r'''
assert sub.group is not None and sub.spans_processes == (pid in (0, 1))
shutdown_distributed()
print(f"PODUNEVEN_OK {pid}", flush=True)
'''

_JAX_POD_UNEVEN_WORKER = _JAX_SEARCH_PROLOGUE + "CELLS = None\n" + _POD_UNEVEN_BODY.replace(
    "global_mesh(MeshSpec(data=3, model=2), CELLS)",
    "global_mesh(MeshSpec(data=3, model=2))",
) + 'print(f"PODUNEVEN_OK {pid}", flush=True)\n'


def test_three_process_pod_uneven_groups(tmp_path):
    """Groups that SPAN processes: 3 pod members at parallelism 2 split
    [[0, 1], [2]]. Candidate 0's collectives cross the process boundary
    inside its group while group 1 trains alone; every member makes both
    process groups in the same order (a member that skipped one would hang
    the pod), and the trainer's Y init is not broadcast pod-wide inside a
    candidate sub-mesh. The JAX package's three members, on the same
    messages, form the same groups, score each candidate within SCORE_TOL
    and publish the same winner."""
    for pkg in ("port", "jax"):
        (tmp_path / pkg).mkdir()
    _run_ranks(_POD_UNEVEN_WORKER, 3, str(tmp_path / "port"), timeout=420,
               jax_worker=_JAX_POD_UNEVEN_WORKER,
               jax_extra=(str(tmp_path / "jax"),))
    _same_search(tmp_path, "uneven", 3)


_POD_COLLECTIVES_WORKER = _PROLOGUE + r'''
import torch

from oryx_tpu_torch.ops.als import aggregate_interactions, train_als_tp
from oryx_tpu_torch.ops.attention import attention, ring_attention

assert init_distributed(load_config(overlay=POD)) is True
mesh = global_mesh(MeshSpec(data=2, model=2), ["cpu", "cpu"])

# int64 travels whole: a millisecond timestamp, an offset past 2**31
big = np.asarray([1_700_000_000_123 + pid, 2**33 + 5], dtype=np.int64)
got = host_allgather(big)
assert got.dtype == np.int64
assert got.tolist() == [[1_700_000_000_123, 2**33 + 5],
                        [1_700_000_000_124, 2**33 + 5]], got

# the default seed path: each process's own urandom draw, replaced by
# process 0's over the mesh's group, so every process trains one model
rng = np.random.default_rng(11)
data = aggregate_interactions(
    rng.integers(0, 24, 400).astype(str), rng.integers(0, 32, 400).astype(str),
    rng.random(400).astype(np.float64) + 0.1, implicit=True)
m2 = train_als_tp(data, mesh, features=8, iterations=1, block=8)
digest = np.array([m2.x.sum(), m2.y.sum(), m2.x[0].sum()], dtype=np.float64)
all_digests = host_allgather(digest)
np.testing.assert_array_equal(all_digests[0], all_digests[1])

# the ring across the process boundary, causal
g = torch.Generator().manual_seed(0)
q, k, v = (torch.randn(16, 8, generator=g) for _ in range(3))
out = ring_attention(q, k, v, mesh, causal=True).full()
np.testing.assert_allclose(out.numpy(), attention(q, k, v, causal=True).numpy(),
                           rtol=2e-5, atol=2e-5)
np.savez(f"{tmp}/ring-{pid}.npz", q=q.numpy(), k=k.numpy(), v=v.numpy(),
         out=out.numpy())
shutdown_distributed()
print(f"PODCOLL_OK {pid}", flush=True)
'''


def test_two_process_pod_collectives(tmp_path):
    """Two gloo ranks: int64 values (a millisecond timestamp, an offset
    past 2**31) survive the host all-gather, the tensor-parallel trainer
    with no seed gives both processes bit-identical models (Y broadcast
    from process 0), and the causal ring crosses the processes within
    2e-5 of the exact attention: the port's, and the JAX package's on the
    same inputs."""
    _run_ranks(_POD_COLLECTIVES_WORKER, 2, str(tmp_path))

    import numpy as np

    from oryx_tpu.ops.attention import attention as jax_attention

    for pid in range(2):
        got = np.load(tmp_path / f"ring-{pid}.npz")
        want = np.asarray(jax_attention(got["q"], got["k"], got["v"], causal=True))
        np.testing.assert_allclose(got["out"], want, rtol=2e-5, atol=2e-5)


# ---- tests/test_pod_cli.py --------------------------------------------------

def _http(url, timeout=5):
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def test_pod_two_compute_plus_serving_e2e(tmp_path):
    """``python -m oryx_tpu_torch.cli pod --compute 2 --serving`` over a
    file:// bus on the CPU (``oryx.compute.platform = cpu``): both compute
    ranks join one gloo group through the CLI path, input flows through a
    generation to a MODEL on the update topic, the non-leader persists its
    windows in its own subdir, the serving child answers from the model,
    and SIGTERM tears the pod down cleanly."""
    bus = f"file://{tmp_path}/bus"
    port = choose_free_port()
    sets = [
        "oryx.id=pod",
        "oryx.compute.platform=cpu",
        f"oryx.input-topic.broker={bus}",
        f"oryx.update-topic.broker={bus}",
        f"oryx.batch.storage.data-dir={tmp_path}/data",
        f"oryx.batch.storage.model-dir={tmp_path}/model",
        f"oryx.monitoring.flight.dir={tmp_path}/flight",
        f"oryx.monitoring.quarantine.dir={tmp_path}/quarantine",
        "oryx.batch.streaming.generation-interval-sec=2",
        "oryx.batch.update-class=oryx_tpu_torch.apps.example.batch.ExampleBatchLayerUpdate",
        f"oryx.serving.api.port={port}",
        "oryx.serving.model-manager-class=oryx_tpu_torch.apps.example.serving.ExampleServingModelManager",
        'oryx.serving.application-resources=["oryx_tpu_torch.serving.resources.common","oryx_tpu_torch.serving.resources.example"]',
    ]
    flat = [x for kv in sets for x in ("--set", kv)]
    env = dict(os.environ, TMPDIR=str(tmp_path), OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "setup", *flat],
        cwd=ROOT, capture_output=True, timeout=60, env=env,
    )
    assert r.returncode == 0, r.stderr.decode()[-500:]

    out_path, err_path = tmp_path / "pod.out", tmp_path / "pod.err"
    # files, not pipes: three children's logs could fill a pipe buffer and
    # deadlock the pod against this test
    pod = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "pod",
         "--compute", "2", "--serving", *flat],
        cwd=ROOT, stdout=open(out_path, "wb"), stderr=open(err_path, "wb"),
        start_new_session=True, env=env,
    )
    try:
        deadline = time.time() + 90
        while True:
            if pod.poll() is not None:
                raise AssertionError(
                    f"pod died rc={pod.returncode}: "
                    + err_path.read_text(errors="replace")[-2000:])
            try:
                if _http(f"http://127.0.0.1:{port}/metrics")[0] == 200:
                    break
            except OSError:
                pass
            assert time.time() < deadline, "serving never came up"
            time.sleep(0.3)

        r = subprocess.run(
            [sys.executable, "-m", "oryx_tpu_torch.cli", "input", *flat],
            cwd=ROOT, input=b"the quick brown fox\nthe lazy dog\nthe end\n",
            capture_output=True, timeout=60, env=env,
        )
        assert r.returncode == 0, r.stderr.decode()[-500:]

        from oryx_tpu_torch.bus.broker import get_broker

        broker = get_broker(bus)
        deadline = time.time() + 120
        model_msgs = []
        while time.time() < deadline and not model_msgs:
            msgs = []
            for p in range(broker.num_partitions("OryxUpdate")):
                msgs += broker.read("OryxUpdate", p, 0, 1000)
            model_msgs = [m for m in msgs if m[1] == "MODEL"]
            time.sleep(0.5)
        assert model_msgs, "no MODEL published by the pod's batch tier"

        deadline = time.time() + 60
        ok = False
        while time.time() < deadline and not ok:
            status, body = _http(f"http://127.0.0.1:{port}/distinct")
            if status == 200 and json.loads(body).get("the", 0) >= 3:
                ok = True
            else:
                time.sleep(0.5)
        assert ok, "serving never served the pod-built model"
        # the non-leader keeps its windows in its own subdir (it publishes
        # through the null producer: tests/test_torch_layers.py)
        assert any((tmp_path / "data" / "proc-1").iterdir())

        pod.send_signal(signal.SIGTERM)
        pod.wait(timeout=30)
        err = err_path.read_text(errors="replace")
        assert "joined process group (gloo): process 0/2" in err, err[-2000:]
        assert "joined process group (gloo): process 1/2" in err, err[-2000:]
        assert pod.returncode == 0, (pod.returncode, err[-1000:])
    finally:
        if pod.poll() is None:
            os.killpg(pod.pid, signal.SIGKILL)
            pod.wait()


def test_pod_child_flags_keeps_pod_valued_flags():
    """The argv rebuild drops only the SUBCOMMAND token 'pod' and the
    pod-only flags — a legitimate flag value spelled 'pod' survives, with
    options before or after the positional."""
    argv = [
        "pod", "--conf", "pod", "--compute", "4", "--coordinator",
        "h:1", "--set", "oryx.id=pod", "--serving",
    ]
    assert cli._pod_child_flags(argv) == [
        "--conf", "pod", "--set", "oryx.id=pod",
    ]
    # '=' forms of pod flags are dropped whole
    assert cli._pod_child_flags(["pod", "--compute=8", "--conf", "x.conf"]) == [
        "--conf", "x.conf",
    ]
    assert cli._pod_child_flags(["--conf", "pod", "pod", "--compute", "2"]) == [
        "--conf", "pod",
    ]
    assert cli._pod_child_flags(["--conf=pod", "pod", "--serving"]) == ["--conf=pod"]
