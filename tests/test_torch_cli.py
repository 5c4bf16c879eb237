"""The port's operational CLI (``python -m oryx_tpu_torch.cli``), held to
tests/test_cli.py's contracts: topic setup, the stdin input pump, --set
overlays, a serving subprocess, loadtest over HTTP/1.1 and HTTP/2 and
across event loops, serving replicas sharing one port, the effective
config, the platform switch and --app; then the commands this slice adds
(import-pmml, flight, perf, tail, the pod launcher and the fleet's shard
refusal), each beside
the JAX package's CLI on the same input where both run: the same config
lines (class paths aside), the same published messages, the same perf
report. Exact throughout.
"""

from __future__ import annotations

import io
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

from e2e_common import http_request as _http
from oryx_tpu_torch import cli
from oryx_tpu_torch.bus.broker import get_broker, topics
from oryx_tpu_torch.bus.inproc import InProcBroker
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.ioutil import choose_free_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE = {
    "oryx.serving.model-manager-class":
        "oryx_tpu_torch.apps.example.serving.ExampleServingModelManager",
    "oryx.serving.application-resources": [
        "oryx_tpu_torch.serving.resources.common",
        "oryx_tpu_torch.serving.resources.example",
    ],
}


@pytest.fixture(autouse=True)
def _fresh():
    InProcBroker.reset_all()
    yield
    InProcBroker.reset_all()


def _sets(*pairs: str) -> list[str]:
    return [x for s in pairs for x in ("--set", s)]


def test_setup_creates_topics(capsys):
    rc = cli.main(_sets("oryx.input-topic.broker=mem://tcli1",
                        "oryx.update-topic.broker=mem://tcli1") + ["setup"])
    assert rc == 0
    assert topics.exists("mem://tcli1", "OryxInput")
    assert topics.exists("mem://tcli1", "OryxUpdate")
    assert get_broker("mem://tcli1").num_partitions("OryxInput") == 4
    out = capsys.readouterr().out
    assert "OryxInput" in out and "OryxUpdate" in out


def test_set_overlay_parses_json_types():
    cfg = cli._build_config(cli._parse_args(
        ["setup", "--set", "oryx.serving.api.port=123", "--set", "a.b=text"]))
    assert cfg.get_int("oryx.serving.api.port") == 123
    assert cfg.get_string("a.b") == "text"
    with pytest.raises(SystemExit):
        cli._build_config(cli._parse_args(["setup", "--set", "novalue"]))


def test_input_pumps_stdin(monkeypatch, capsys):
    flags = _sets("oryx.input-topic.broker=mem://tcli2",
                  "oryx.update-topic.broker=mem://tcli2")
    cli.main(["setup", *flags])
    monkeypatch.setattr(sys, "stdin", io.StringIO("line one\nline two\n\n"))
    assert cli.main(["input", *flags]) == 0
    broker = get_broker("mem://tcli2")
    msgs: set[str] = set()
    for p in range(broker.num_partitions("OryxInput")):
        msgs |= {m for _, _, m in broker.read("OryxInput", p, 0, 10)}
    assert msgs == {"line one", "line two"}
    assert "sent 2 lines to OryxInput" in capsys.readouterr().err


def test_input_lands_where_the_jax_cli_puts_it(tmp_path, monkeypatch):
    """`input` of both packages over one kafka:// topic each: the same
    lines at the same partitions and offsets under the same keys, though
    the port sends them in batches."""
    from oryx_tpu import cli as jax_cli
    from tests.torch_kafka_testbroker import LocalKafkaTestBroker

    lines = "".join(f"u{j % 9},i{j % 13},1,{1000 + j}\n" for j in range(300))
    logs = []
    for main in (jax_cli.main, cli.main):
        with LocalKafkaTestBroker() as srv:
            flags = _sets(f"oryx.input-topic.broker={srv.uri}",
                          f"oryx.update-topic.broker={srv.uri}")
            assert main(["setup", *flags]) == 0
            monkeypatch.setattr(sys, "stdin", io.StringIO(lines))
            assert main(["input", *flags]) == 0
            b = get_broker(srv.uri)
            logs.append([b.read("OryxInput", p, 0, 1000) for p in range(4)])
    assert logs[0] == logs[1]
    assert all(logs[0]) and sum(len(p) for p in logs[0]) == 300


def _wait_http(url, want=200, limit=60, proc=None):
    deadline = time.time() + limit
    status = body = None
    while time.time() < deadline:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"process exited {proc.returncode}")
        try:
            status, body = _http("GET", url)
            if status == want:
                return body
        except OSError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"{url} answered {status}")


def test_sigterm_during_start_closes_the_started_layer():
    """A SIGTERM that arrives while the layer is still starting is handled
    once start() has returned, so close() sees every thread start()
    brought up (closing earlier left late event loops running and the
    process waiting on them for good)."""
    events = []

    class Layer:
        def start(self):
            os.kill(os.getpid(), signal.SIGTERM)
            time.sleep(0.05)  # a handler not held back runs here
            events.append("started")

        def await_termination(self):
            events.append("await")

        def close(self):
            events.append("close")

    before = signal.getsignal(signal.SIGTERM)
    assert cli._run_until_interrupt(Layer()) == 0
    assert events == ["started", "close", "await", "close"]
    assert signal.getsignal(signal.SIGTERM) is before


def test_serving_subprocess_round_trip(tmp_path):
    port = choose_free_port()
    bus = f"file://{tmp_path}/bus"
    flags = _sets(f"oryx.input-topic.broker={bus}", f"oryx.update-topic.broker={bus}",
                  f"oryx.serving.api.port={port}",
                  f"oryx.monitoring.flight.dir={tmp_path / 'flight'}")
    assert cli.main(["setup", "--app", "example", *flags]) == 0
    get_broker(bus).send("OryxUpdate", "MODEL", json.dumps({"cat": 2}))
    proc = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "serving", "--app", "example",
         *flags], cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        body = _wait_http(f"http://127.0.0.1:{port}/distinct/cat", proc=proc)
        assert json.loads(body) == 2
    finally:
        proc.terminate()
        proc.wait(timeout=10)


def _example_layer(bus, **extra):
    from oryx_tpu_torch.serving.server import ServingLayer

    broker = get_broker(bus)
    for t in ("OryxInput", "OryxUpdate"):
        if not broker.topic_exists(t):
            broker.create_topic(t, 1)
    broker.send("OryxUpdate", "MODEL", json.dumps({"word": 7}))
    overlay = {"oryx.input-topic.broker": bus, "oryx.update-topic.broker": bus,
               "oryx.serving.api.port": 0, **EXAMPLE}
    overlay.update(extra)
    return ServingLayer(load_config(overlay=overlay))


def _loadtest(args) -> tuple[int, dict]:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["loadtest", *args])
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("variant", ["paced", "http2", "multiloop"])
def test_loadtest(variant, tmp_path):
    """Paced at 200 qps for 2 s (never above the target); HTTP/2 prior
    knowledge; unpaced against 4 event loops, which must all be reported
    and at least two serve."""
    extra = {"oryx.serving.api.loops": 4} if variant == "multiloop" else {}
    paths = tmp_path / "paths.txt"
    paths.write_text("/distinct/word\n/ready\n")
    with _example_layer(f"mem://tclilt-{variant}", **extra) as sl:
        time.sleep(0.3)
        args = ["--url", f"http://127.0.0.1:{sl.port}", "--paths", str(paths),
                "--duration", "2"]
        args += {"paced": ["--rate", "200", "--workers", "4"],
                 "http2": ["--http2", "--workers", "4"],
                 "multiloop": ["--workers", "8"]}[variant]
        rc, report = _loadtest(args)
    assert rc == 0
    assert report["errors"] == 0
    assert report["latency_ms"]["p50"] > 0
    if variant == "paced":
        assert report["requests"] > 100
        assert report["qps"] <= 260
    elif variant == "http2":
        assert report["requests"] > 20
    else:
        assert report["requests"] > 150, report
        assert report["server"]["loops"] == 4
        assert report["server"]["loops_serving"] >= 2, report["server"]


def _children(pid: int) -> list[int]:
    out = subprocess.run(["pgrep", "-P", str(pid)], capture_output=True,
                         text=True).stdout.split()
    return [int(x) for x in out]


def test_serving_replicas_share_port(tmp_path):
    """oryx.serving.api.processes = 2: the CLI supervises two serving
    replicas on ONE port via SO_REUSEPORT over a file:// broker, each
    naming itself on /healthz; a killed replica is restarted."""
    if not hasattr(socket, "SO_REUSEPORT"):
        pytest.skip("no SO_REUSEPORT on this platform")
    bus = f"file://{tmp_path}/bus"
    b = get_broker(bus)
    b.create_topic("OryxInput", 1)
    b.create_topic("OryxUpdate", 1)
    b.send("OryxUpdate", "MODEL", json.dumps({"replica": 7}))
    port = choose_free_port()
    conf = tmp_path / "oryx.conf"
    conf.write_text(f'''
oryx.id = replicas
oryx.input-topic.broker = "{bus}"
oryx.update-topic.broker = "{bus}"
oryx.serving.api.port = {port}
oryx.serving.api.processes = 2
oryx.monitoring.flight.dir = "{tmp_path / 'flight'}"
''')
    sup = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "serving", "--app", "example",
         "--conf", str(conf), "--set", "oryx.compute.platform=cpu"],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        assert json.loads(_wait_http(f"http://127.0.0.1:{port}/distinct/replica",
                                     proc=sup)) == 7
        kids = _children(sup.pid)
        assert len(kids) == 2, kids
        names = set()
        deadline = time.time() + 60
        while len(names) < 2 and time.time() < deadline:
            status, body = _http("GET", f"http://127.0.0.1:{port}/healthz")
            if status == 200:
                names.add(json.loads(body).get("replica"))
        assert names == {"serving-0", "serving-1"}
        os.kill(kids[0], signal.SIGKILL)
        deadline = time.time() + 120
        now: list[int] = []
        while time.time() < deadline:
            now = _children(sup.pid)
            if len(now) == 2 and kids[0] not in now:
                break
            time.sleep(0.3)
        assert len(now) == 2 and kids[0] not in now, now
        _wait_http(f"http://127.0.0.1:{port}/distinct/replica")
    finally:
        sup.terminate()
        try:
            sup.wait(timeout=30)
        except subprocess.TimeoutExpired:
            sup.kill()
    assert not any(_children(sup.pid))


def test_serving_replicas_refuse_what_cannot_share(tmp_path):
    """Replica mode needs a fixed port and a cross-process broker."""
    for sets, why in ((["oryx.serving.api.port=0"], "fixed port"),
                      ([f"oryx.serving.api.port={choose_free_port()}",
                        "oryx.input-topic.broker=mem://x",
                        "oryx.update-topic.broker=mem://x"], "cross-process")):
        with pytest.raises(SystemExit, match=why):
            cli.main(["serving", "--app", "example",
                      *_sets("oryx.serving.api.processes=2", *sets)])


def test_config_subcommand_flattens_effective_config(capsys):
    rc = cli.cmd_config(load_config(overlay={"oryx.id": "cfgtest",
                                             "oryx.serving.api.port": 1234}))
    assert rc == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert "oryx.id=cfgtest" in lines
    assert "oryx.serving.api.port=1234" in lines
    assert "oryx.monitoring.metrics=true" in lines  # booleans lowercase
    assert lines == sorted(lines)


@pytest.mark.parametrize("argv", [
    [],
    ["--app", "als", "--set", "oryx.serving.api.port=9090",
     "--set", "oryx.input-topic.broker=kafka://h1:9092,h2:9092"],
    ["--app", "example", "--set", "oryx.serving.api.user-name=u",
     "--set", "oryx.serving.api.password=hunter2", "--trace", "--loops", "3"],
    ["--app", "seq", "--full-rebuild", "--sync-mode", "full"],
], ids=["defaults", "als-kafka", "example-secret", "seq-sugar"])
def test_config_prints_the_jax_clis_lines(argv, capsys):
    """`config` of both packages prints the same lines for the same conf
    and --sets, apart from class paths that name the package; secrets are
    redacted in both."""
    from oryx_tpu import cli as jax_cli

    outs = []
    for main in (jax_cli.main, cli.main):
        assert main(["config", *argv]) == 0
        outs.append(capsys.readouterr().out.replace("oryx_tpu_torch.", "oryx_tpu."))
    assert outs[0] == outs[1]
    assert "hunter2" not in outs[1]
    if "example-secret" in repr(argv) or "--trace" in argv:
        assert "oryx.serving.api.password=*****" in outs[1].splitlines()


def test_platform_names_the_torch_device(monkeypatch):
    """oryx.compute.platform steers the device the layers resolve: cpu
    when the operator asks for it, the card (raising without one) on
    auto; a name torch does not know is refused; the CLI leaves the
    process's default as it found it."""
    import torch

    from oryx_tpu_torch import device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cli._apply_platform(load_config(overlay={"oryx.compute.platform": "cpu"}))
    try:
        assert device.resolve_device() == torch.device("cpu")
        assert device.resolve_device("cpu") == torch.device("cpu")
    finally:
        device.set_platform("auto")
    cli._apply_platform(load_config(overlay={"oryx.compute.platform": "auto"}))
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve_device()
    with pytest.raises(SystemExit, match="names no torch device"):
        cli._apply_platform(load_config(overlay={"oryx.compute.platform": "tpu"}))
    assert cli.main(["config", "--set", "oryx.compute.platform=cpu"]) == 0
    with pytest.raises(RuntimeError, match="CUDA"):
        device.resolve_device()


def test_app_flag_wires_registry_classes(capsys):
    assert cli.main(["config", "--app", "seq"]) == 0
    out = capsys.readouterr().out
    assert "oryx.batch.update-class=oryx_tpu_torch.apps.seq.batch.SeqUpdate" in out
    assert ("oryx.speed.model-manager-class="
            "oryx_tpu_torch.apps.seq.speed.SeqSpeedModelManager") in out
    assert ("oryx.serving.model-manager-class="
            "oryx_tpu_torch.apps.seq.serving.SeqServingModelManager") in out
    assert "oryx_tpu_torch.serving.resources.seq" in out


def test_app_flag_explicit_set_still_wins(capsys):
    assert cli.main(["config", "--app", "als",
                     "--set", "oryx.batch.update-class=custom.Update"]) == 0
    out = capsys.readouterr().out
    assert "oryx.batch.update-class=custom.Update" in out
    assert ("oryx.serving.model-manager-class="
            "oryx_tpu_torch.apps.als.serving.ALSServingModelManager") in out


def test_app_flag_unknown_app_fails_fast():
    with pytest.raises(SystemExit):
        cli.main(["config", "--app", "nosuchapp"])


def test_app_flag_survives_child_argv_rebuild():
    """Replica children keep --app and every value option; the subcommand
    token goes, even where it is also a value."""
    raw = ["--conf", "serving", "serving", "--app", "seq", "--loops", "2",
           "--set", "a=b", "--trace"]
    child = cli._child_flags(raw)
    assert child == ["--conf", "serving", "--app", "seq", "--loops", "2",
                     "--set", "a=b", "--trace"]


@pytest.mark.parametrize("command", ["pod"])
def test_fleet_and_pod_are_not_ported_yet(command, monkeypatch):
    """(Named when ``pod`` was refused.) ``cli pod --compute 2 --serving``
    spawns two ``batch`` children of the port's CLI joined at one
    rendezvous (process ids 0 and 1 of 2) and a single-process serving
    child, passing every other flag through; a compute child that exits
    tears the pod down (rc 1, every other child terminated)."""
    spawned = []

    class FakeChild:
        def __init__(self, cmd, env=None):
            self.cmd = cmd
            self.returncode = None
            self.polls = 0
            self.terminated = False
            spawned.append(self)

        def poll(self):
            self.polls += 1
            if ("process-id=1" in " ".join(self.cmd) and self.polls > 2
                    and self.returncode is None):
                self.returncode = 3  # compute member 1 dies
            return self.returncode

        def terminate(self):
            self.terminated = True
            if self.returncode is None:
                self.returncode = -signal.SIGTERM.value

        def wait(self, timeout=None):
            return self.returncode

        def kill(self):
            self.terminate()

    monkeypatch.setattr(subprocess, "Popen", FakeChild)
    monkeypatch.setattr(time, "sleep", lambda s: None)
    rc = cli.main([command, "--replicas", "3", "--compute", "2", "--serving",
                   "--set", "oryx.id=pod"])
    assert rc == 1
    roles = [c.cmd[3] for c in spawned]
    assert roles == ["batch", "batch", "serving"]
    for c in spawned:
        assert c.cmd[1:3] == ["-m", "oryx_tpu_torch.cli"]
        assert c.cmd[4:8] == ["--replicas", "3", "--set", "oryx.id=pod"]
    sets = [[c.cmd[i + 1] for i in range(len(c.cmd) - 1)
             if c.cmd[i] == "--set"] for c in spawned]
    coord = {s for ss in sets[:2] for s in ss
             if s.startswith("oryx.compute.distributed.coordinator-address=")}
    assert len(coord) == 1 and coord.pop().split("=")[1].startswith("127.0.0.1:")
    for pid in (0, 1):
        assert f"oryx.compute.distributed.process-id={pid}" in sets[pid]
        assert "oryx.compute.distributed.num-processes=2" in sets[pid]
    assert "oryx.compute.distributed.num-processes=1" in sets[2]
    assert spawned[0].terminated and spawned[2].terminated


def test_pod_refuses_a_partial_host_without_a_coordinator():
    """A host that runs only part of the pod must be told where process 0
    is; a local range past --compute is refused."""
    with pytest.raises(SystemExit, match="--coordinator is required"):
        cli.main(["pod", "--compute", "4", "--local-start", "2",
                  "--local-count", "2"])
    with pytest.raises(SystemExit, match="exceeds --compute"):
        cli.main(["pod", "--compute", "2", "--local-start", "1",
                  "--local-count", "2", "--coordinator", "h:1"])


def test_cli_fleet_refuses_shards(monkeypatch):
    """(Named when every shard count above 1 was refused.) ``cli fleet
    --shards 2`` reaches every replica's overlay as
    ``oryx.serving.api.sync.shard-count``, and ``--shards 0`` is refused
    with the serving layer's own message before any replica starts."""
    import oryx_tpu_torch.fleet as fleet_mod
    from oryx_tpu_torch.fleet.supervisor import replica_overlays

    seen = {}

    class _Supervisor:
        def __init__(self, config, argv=None, **kw):
            seen["overlays"] = replica_overlays(config)

        def start(self):
            raise KeyboardInterrupt  # stop before any process starts

        def request_stop(self):
            pass

        def stop(self):
            seen["stopped"] = True

    monkeypatch.setattr(fleet_mod, "FleetSupervisor", _Supervisor)
    cli.main(["fleet", "--replicas", "3", "--shards", "2"])
    assert seen["stopped"]
    assert [o["oryx.serving.api.sync.shard-count"]
            for o in seen["overlays"]] == [2, 2, 2]
    seen.clear()
    with pytest.raises(ValueError, match="shard-count must be >= 1"):
        cli.main(["fleet", "--replicas", "3", "--shards", "0"])
    assert not seen


def _kmeans_pmml(n: int = 4) -> str:
    import numpy as np

    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(3)
    art = ModelArtifact("kmeans", extensions={"k": str(n)}, tensors={
        "centers": rng.standard_normal((n, 3)).astype(np.float32)})
    art.content["counts"] = list(range(1, n + 1))
    return art.to_pmml_xml()


@pytest.mark.parametrize("max_size,key", [(16 << 20, "MODEL"), (64, "MODEL-REF")])
def test_import_pmml_publishes_like_the_jax_cli(max_size, key, tmp_path):
    """import-pmml publishes the parsed model inline as MODEL, or writes
    it to the model store and publishes MODEL-REF above the size cutoff;
    the JAX CLI publishes the same model for the same file."""
    from oryx_tpu import cli as jax_cli
    from oryx_tpu_torch.common.artifact import ModelArtifact

    pmml = tmp_path / "m.pmml"
    pmml.write_text(_kmeans_pmml(24))
    got = []
    from oryx_tpu.bus.broker import get_broker as jax_broker

    for name, main, broker in (("jax", jax_cli.main, jax_broker),
                               ("port", cli.main, get_broker)):
        bus = f"mem://tpmml-{name}-{key}"
        flags = _sets(f"oryx.input-topic.broker={bus}", f"oryx.update-topic.broker={bus}",
                      f"oryx.update-topic.message.max-size={max_size}",
                      f"oryx.batch.storage.model-dir={tmp_path / name}")
        assert main(["setup", *flags]) == 0
        assert main(["import-pmml", "--pmml", str(pmml), *flags]) == 0
        [(_, k, msg)] = broker(bus).read("OryxUpdate", 0, 0, 10)
        assert k == key
        art = (ModelArtifact.read(msg) if key == "MODEL-REF"
               else ModelArtifact.from_string(msg))
        got.append(art.to_string())
    assert got[0] == got[1]
    with pytest.raises(SystemExit, match="--pmml"):
        cli.main(["import-pmml"])


def test_flight_filters_by_kind(tmp_path, capsys):
    from oryx_tpu_torch.common.flightrec import FlightRecorder

    flight = tmp_path / "flight"
    rec = FlightRecorder()
    rec.configure(load_config(overlay={"oryx.monitoring.flight.dir": str(flight)}))
    rec.record(kind="process-start", role="serving")
    rec.record(kind="generation", generation=5)
    rec.record(kind="generation", generation=6)
    flags = _sets(f"oryx.monitoring.flight.dir={flight}")
    assert cli.main(["flight", *flags]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["kind"] for x in lines] == [
        "process-start", "generation", "generation"]
    assert cli.main(["flight", "--kind", "generation", *flags]) == 0
    cap = capsys.readouterr()
    assert [json.loads(x)["generation"] for x in cap.out.strip().splitlines()] == [5, 6]
    assert "2 event(s)" in cap.err and "(3 total)" in cap.err
    assert cli.main(["flight", "--kind", "no-such-kind", *flags]) == 2


def test_flight_kind_filters_the_fleets_kinds(tmp_path, capsys):
    """tests/test_qualitystats.py::test_cli_flight_kind_filter against the
    port's CLI, over every kind the fleet writes: each filters alone, two
    filter together in ring order, an unknown kind fails loudly."""
    from oryx_tpu_torch.common.flightrec import EVENT_KINDS, FlightRecorder

    fleet_kinds = [
        "ejection", "readmission", "replica-death", "canary-start",
        "canary-hold", "canary-promote", "canary-rollback", "autoscale",
        "crash-loop",
    ]
    assert set(fleet_kinds) <= set(EVENT_KINDS)
    rec = FlightRecorder()
    rec.dir = str(tmp_path)
    for k in fleet_kinds:
        rec.record(kind=k, replica="r0")
    rec.record(kind="generation", generation=5)
    rec.record(kind="quality-alarm", generation=5, live_recall=0.1)
    flags = _sets(f"oryx.monitoring.flight.dir={tmp_path}")
    for k in fleet_kinds:
        assert cli.main(["flight", "--kind", k, *flags]) == 0
        out = capsys.readouterr().out.strip().splitlines()
        assert [json.loads(x)["kind"] for x in out] == [k]
    assert cli.main(["flight", "--kind", "quality-alarm", "--kind",
                     "ejection", *flags]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(x)["kind"] for x in out] == ["ejection", "quality-alarm"]
    assert cli.main(["flight", "--kind", "no-such-kind", *flags]) == 2


def test_perf_report_matches_the_jax_cli(capsys):
    """The perf report of a live replica's /metrics, rendered by both
    packages from the same text: the same lines."""
    from oryx_tpu import cli as jax_cli

    with _example_layer("mem://tcliperf") as sl:
        for _ in range(20):
            _http("GET", f"http://127.0.0.1:{sl.port}/distinct/word")
        assert cli.main(["perf", "--url", f"127.0.0.1:{sl.port}"]) == 0
        report = capsys.readouterr().out
        status, text = _http("GET", f"http://127.0.0.1:{sl.port}/metrics")
    assert status == 200
    assert report.startswith("latency budget (oryx_request_phase_seconds)")
    assert "device idle gaps" in report and "xla compiles" in report
    assert cli.render_perf_report(text) == jax_cli.render_perf_report(text)
    page = (
        "# TYPE oryx_request_phase_seconds histogram\n"
        'oryx_request_phase_seconds_bucket{phase="device",le="0.01"} 3\n'
        'oryx_request_phase_seconds_bucket{phase="device",le="+Inf"} 4\n'
        'oryx_request_phase_seconds_sum{phase="device"} 0.5\n'
        'oryx_request_phase_seconds_count{phase="device"} 4\n'
        "# TYPE oryx_device_idle_gap_seconds histogram\n"
        'oryx_device_idle_gap_seconds_sum{cause="host"} 1.25\n'
        'oryx_device_idle_gap_seconds_count{cause="host"} 2\n'
        "# TYPE oryx_xla_compiles_total counter\n"
        'oryx_xla_compiles_total{kind="topk"} 1\n'
        "# EOF\n"
    )
    assert cli.render_perf_report(page) == jax_cli.render_perf_report(page)
    assert cli.main(["perf", "--url", f"127.0.0.1:{choose_free_port()}"]) == 1


def test_tail_prints_both_topics(tmp_path):
    bus = f"file://{tmp_path}/bus"
    flags = _sets(f"oryx.input-topic.broker={bus}", f"oryx.update-topic.broker={bus}")
    assert cli.main(["setup", *flags]) == 0
    broker = get_broker(bus)
    broker.send("OryxInput", None, "before")  # tail starts at the end
    proc = subprocess.Popen(
        [sys.executable, "-m", "oryx_tpu_torch.cli", "tail", *flags],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        time.sleep(3)
        broker.send("OryxUpdate", "MODEL-REF", "/m/1")
        broker.send("OryxUpdate", "UP", '["X","u1",[1.0]]')
        broker.send("OryxInput", "k", "u1,i1,1,5")
        time.sleep(2)
    finally:
        proc.send_signal(signal.SIGINT)
        out, _ = proc.communicate(timeout=30)
    assert proc.returncode == 0
    lines = out.strip().splitlines()
    assert "OryxUpdate\tMODEL-REF\t/m/1" in lines
    assert 'OryxUpdate\tUP\t["X","u1",[1.0]]' in lines
    assert "OryxInput\tk\tu1,i1,1,5" in lines
    assert not any("before" in x for x in lines)
