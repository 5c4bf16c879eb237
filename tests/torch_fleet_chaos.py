"""The fleet's process-level chaos scenarios against the port: the
``fleet-kill``, ``flight-on-kill`` and ``fleet-canary`` scenarios of
tools/chaos.py, rewritten over oryx_tpu_torch (tools/chaos.py drives the
JAX package). Each runs two real ``python -m oryx_tpu_torch.cli serving``
replicas on the CPU (``oryx.compute.platform = cpu``) behind an in-process
fleet front and returns the list of broken contracts (empty = held).
Each scenario appends the stop of every supervisor and front it starts to
``live`` as soon as it exists, so a caller can end them early.
"""

from __future__ import annotations

import json
import os
import time

SCENARIOS: dict[str, tuple[str, "callable"]] = {}


def scenario(name: str, doc: str):
    def deco(fn):
        SCENARIOS[name] = (doc, fn)
        return fn

    return deco


def _child_env(tmp: str) -> dict:
    """The replicas' environment: their artifact relay cache (under the
    temp dir) stays inside this scenario's directory."""
    return dict(os.environ, TMPDIR=tmp)


def _fleet_model_message(gen: int):
    """A small publishable ALS artifact (fresh factors per generation so
    the storm is real model churn, not republished bytes)."""
    import numpy as np

    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(gen)
    n_users, n_items, f = 32, 64, 4
    art = ModelArtifact(
        "als",
        extensions={
            "features": str(f), "lambda": "0.001", "alpha": "1.0",
            "implicit": "true", "logStrength": "false",
        },
        tensors={
            "X": rng.standard_normal((n_users, f), dtype=np.float32),
            "Y": rng.standard_normal((n_items, f), dtype=np.float32),
        },
    )
    art.set_extension("XIDs", [f"u{j}" for j in range(n_users)])
    art.set_extension("YIDs", [f"i{j}" for j in range(n_items)])
    return art.to_string()


@scenario("fleet-kill",
          "SIGKILL one serving replica mid update-storm behind the fleet "
          "front; the front must keep answering with zero non-shed 5xx, "
          "eject the corpse, and the survivor's model staleness must stay "
          "under the configured bound")
def fleet_kill(tmp: str, live: list) -> list[str]:
    import http.client
    import subprocess
    import threading

    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.executil import (
        config_overlay_from_sets,
        free_port_run,
    )
    from oryx_tpu_torch.common.freshness import publish_stamp
    from oryx_tpu_torch.fleet import FleetFront, FleetSupervisor

    bus = f"file://{os.path.join(tmp, 'bus')}"
    topics.maybe_create(bus, "OryxInput", 1)
    topics.maybe_create(bus, "OryxUpdate", 1)
    broker = get_broker(bus)

    def publish_model(gen: int) -> None:
        broker.send("OryxUpdate", "MODEL", _fleet_model_message(gen))
        broker.send("OryxUpdate", "TRACE", publish_stamp(generation=gen))

    publish_model(1)

    staleness_bound = 120.0
    base_port = free_port_run(2)
    sets = [
        "oryx.id=chaos-fleet",
        f"oryx.input-topic.broker={bus}",
        f"oryx.update-topic.broker={bus}",
        "oryx.serving.model-manager-class="
        "oryx_tpu_torch.apps.als.serving.ALSServingModelManager",
        'oryx.serving.application-resources='
        '["oryx_tpu_torch.serving.resources.common",'
        '"oryx_tpu_torch.serving.resources.als"]',
        # replicas open the card unless told otherwise: here, the CPU
        "oryx.compute.platform=cpu",
        "oryx.serving.api.read-only=true",
        "oryx.serving.api.loops=1",
        f"oryx.serving.api.max-staleness-sec={staleness_bound}",
        "oryx.fleet.replicas=2",
        f"oryx.fleet.base-port={base_port}",
        f"oryx.fleet.data-dir={os.path.join(tmp, 'fleet')}",
        # the kill must STICK for the scenario's window: no auto-restart
        "oryx.fleet.supervisor.restart=false",
        # fast ejection so the 5-second storm window sees it
        "oryx.fleet.front.probe-interval-sec=0.2",
        "oryx.fleet.front.eject-after=1",
    ]

    cfg = load_config(overlay=config_overlay_from_sets(sets))
    argv = [x for s in sets for x in ("--set", s)]
    problems: list[str] = []
    sup = FleetSupervisor(
        cfg, argv=argv, env=_child_env(tmp),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    live.append(sup.stop)
    front = None
    stop = threading.Event()
    counts = {"ok": 0, "shed": 0, "non_shed_5xx": 0, "other": 0,
              "client_error": 0, "ok_after_kill": 0}
    killed = threading.Event()
    lock = threading.Lock()

    def client(front_port: int) -> None:
        conn = None
        j = 0
        while not stop.is_set():
            if conn is None:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", front_port, timeout=30
                )
            try:
                conn.request("GET", f"/recommend/u{j % 32}?howMany=3")
                r = conn.getresponse()
                retry_after = r.getheader("Retry-After")
                r.read()
                with lock:
                    if r.status == 200:
                        counts["ok"] += 1
                        if killed.is_set():
                            counts["ok_after_kill"] += 1
                    elif r.status == 503 and retry_after:
                        counts["shed"] += 1  # deliberate, not a failure
                    elif r.status >= 500:
                        counts["non_shed_5xx"] += 1
                    else:
                        counts["other"] += 1
            except Exception:
                # the FRONT itself refused/was unreachable — the fleet
                # contract broke (replica failures must be absorbed)
                with lock:
                    counts["client_error"] += 1
                try:
                    conn.close()
                except Exception:
                    pass
                conn = None
            j += 1

    def storm() -> None:
        gen = 2
        while not stop.is_set():
            publish_model(gen)
            gen += 1
            stop.wait(0.2)

    try:
        sup.start()
        sup.wait_listening(90)
        # both replicas model-ready before the storm starts
        for _, host, port in sup.backends():
            deadline = time.time() + 60
            while True:
                c = http.client.HTTPConnection(host, port, timeout=5)
                c.request("GET", "/ready")
                r = c.getresponse()
                r.read()
                c.close()
                if r.status == 200:
                    break
                if time.time() > deadline:
                    raise RuntimeError(f"replica :{port} never became ready")
                time.sleep(0.3)
        front = FleetFront(cfg, backends=sup.backends(), port=0)
        live.append(front.close)
        front.start()
        threads = [
            threading.Thread(target=client, args=(front.port,))
            for _ in range(2)
        ] + [threading.Thread(target=storm)]
        for t in threads:
            t.start()
        time.sleep(1.0)
        sup.kill(0)  # SIGKILL mid-storm
        killed.set()
        time.sleep(4.0)
        stop.set()
        for t in threads:
            t.join(timeout=30)

        if counts["non_shed_5xx"]:
            problems.append(
                f"{counts['non_shed_5xx']} non-shed 5xx reached the front's "
                f"clients (counts={counts})"
            )
        if counts["client_error"]:
            problems.append(
                f"{counts['client_error']} client-level errors talking to "
                f"the front (counts={counts})"
            )
        if counts["ok_after_kill"] < 10:
            problems.append(
                f"only {counts['ok_after_kill']} successes after the kill "
                "— the survivor never took the traffic"
            )
        dead = next(r for r in front.replicas if r.id == "r0")
        alive = next(r for r in front.replicas if r.id == "r1")
        if dead.routable:
            problems.append("killed replica r0 was never ejected")
        if not alive.routable:
            problems.append("survivor r1 lost routability")
        # survivor freshness: it kept consuming the storm, so its model
        # age must sit under the degraded bound (and /healthz stays 200)
        c = http.client.HTTPConnection("127.0.0.1", sup.ports()[1], timeout=5)
        c.request("GET", "/healthz")
        r = c.getresponse()
        body = json.loads(r.read())
        c.close()
        stale = body.get("staleness_seconds")
        if r.status != 200:
            problems.append(
                f"survivor /healthz is {r.status} ({body.get('degraded')})"
            )
        if not isinstance(stale, (int, float)) or stale >= staleness_bound:
            problems.append(
                f"survivor staleness {stale!r} not under the "
                f"{staleness_bound:.0f}s bound"
            )
    finally:
        stop.set()
        if front is not None:
            front.close()
        sup.stop()
    return problems


@scenario("flight-on-kill",
          "SIGKILL a replica mid update-storm behind the fleet front; the "
          "supervisor must harvest a flight artifact holding the corpse's "
          "last lifecycle events (generation adoptions), and the front's "
          "ejection flight event must carry the same trace-joinable "
          "replica id")
def flight_on_kill(tmp: str, live: list) -> list[str]:
    import http.client
    import subprocess

    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common import flightrec
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.executil import (
        config_overlay_from_sets,
        free_port_run,
    )
    from oryx_tpu_torch.common.freshness import publish_stamp
    from oryx_tpu_torch.fleet import FleetFront, FleetSupervisor

    bus = f"file://{os.path.join(tmp, 'bus')}"
    topics.maybe_create(bus, "OryxInput", 1)
    topics.maybe_create(bus, "OryxUpdate", 1)
    broker = get_broker(bus)

    def publish_model(gen: int) -> None:
        broker.send("OryxUpdate", "MODEL", _fleet_model_message(gen))
        broker.send("OryxUpdate", "TRACE", publish_stamp(generation=gen))

    publish_model(1)

    base_port = free_port_run(2)
    front_flight = os.path.join(tmp, "front-flight")
    sets = [
        "oryx.id=chaos-flight",
        f"oryx.input-topic.broker={bus}",
        f"oryx.update-topic.broker={bus}",
        "oryx.serving.model-manager-class="
        "oryx_tpu_torch.apps.als.serving.ALSServingModelManager",
        'oryx.serving.application-resources='
        '["oryx_tpu_torch.serving.resources.common",'
        '"oryx_tpu_torch.serving.resources.als"]',
        # replicas open the card unless told otherwise: here, the CPU
        "oryx.compute.platform=cpu",
        "oryx.serving.api.read-only=true",
        "oryx.serving.api.loops=1",
        "oryx.fleet.replicas=2",
        f"oryx.fleet.base-port={base_port}",
        f"oryx.fleet.data-dir={os.path.join(tmp, 'fleet')}",
        # the kill must stick: this scenario asserts the HARVEST, which
        # poll() performs whether or not it then restarts
        "oryx.fleet.supervisor.restart=false",
        "oryx.fleet.front.probe-interval-sec=0.2",
        "oryx.fleet.front.eject-after=1",
        # the front process's own flight ring (ejection events land here)
        f"oryx.monitoring.flight.dir={front_flight}",
    ]
    cfg = load_config(overlay=config_overlay_from_sets(sets))
    argv = [x for s in sets for x in ("--set", s)]
    problems: list[str] = []
    sup = FleetSupervisor(
        cfg, argv=argv, env=_child_env(tmp),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    live.append(sup.stop)
    front = None
    try:
        sup.start()
        sup.wait_listening(90)
        # both replicas model-ready (they consumed MODEL + its stamp, so
        # the corpse's flight ring holds a generation event to find)
        for _, host, port in sup.backends():
            deadline = time.time() + 60
            while True:
                c = http.client.HTTPConnection(host, port, timeout=5)
                c.request("GET", "/ready")
                r = c.getresponse()
                r.read()
                c.close()
                if r.status == 200:
                    break
                if time.time() > deadline:
                    raise RuntimeError(f"replica :{port} never became ready")
                time.sleep(0.3)
        front = FleetFront(cfg, backends=sup.backends(), port=0)
        live.append(front.close)
        front.start()
        # a short storm so the corpse dies with FRESH generation events
        for gen in range(2, 6):
            publish_model(gen)
            time.sleep(0.2)
        sup.kill(0)  # SIGKILL mid-storm
        # supervisor observes the death and harvests the corpse's ring
        deadline = time.time() + 30
        while not sup.harvested:
            sup.poll()
            if time.time() > deadline:
                break
            time.sleep(0.2)
        if not sup.harvested:
            problems.append("supervisor never harvested a flight artifact")
        else:
            doc = json.load(open(sup.harvested[-1], encoding="utf-8"))
            events = doc.get("events") or []
            if doc.get("replica") != "r0":
                problems.append(
                    f"harvest names replica {doc.get('replica')!r}, want r0"
                )
            if not any(
                e.get("kind") == "generation" and e.get("replica") == "r0"
                for e in events
            ):
                problems.append(
                    "harvested events lack the corpse's generation "
                    f"adoptions (kinds: {sorted({e.get('kind') for e in events})})"
                )
        # the front must eject the corpse AND record a flight event whose
        # replica id joins the harvest
        deadline = time.time() + 30
        dead = next(r for r in front.replicas if r.id == "r0")
        while dead.routable and time.time() < deadline:
            time.sleep(0.2)
        if dead.routable:
            problems.append("killed replica r0 was never ejected")
        ejections = [
            e for e in flightrec.read_events(front_flight)
            if e.get("kind") == "ejection"
        ]
        if not any(e.get("replica") == "r0" for e in ejections):
            problems.append(
                f"front flight ring lacks an ejection event for r0: "
                f"{ejections}"
            )
    finally:
        if front is not None:
            front.close()
        sup.stop()
    return problems


def _quality_model_message(gen: int, corrupted: bool = False) -> str:
    """A publishable ALS artifact for the degraded-model scenario. The
    corrupted form is adversarial to int8 per-row quantization: one
    huge noise coordinate per Y row blows up the row scale so every
    signal coordinate quantizes to 0 — quantized selection degenerates
    to ties while the exact scores (user vectors are 0 in the noise
    dimension) are untouched, so the served candidates stop containing
    the true top items and MEASURED live recall collapses. A real-world
    stand-in for any generation whose geometry breaks the serving
    approximation."""
    import numpy as np

    from oryx_tpu_torch.common.artifact import ModelArtifact

    rng = np.random.default_rng(gen)
    n_users, n_items, f = 64, 512, 16
    x = rng.standard_normal((n_users, f)).astype(np.float32)
    x[:, 0] = 0.0  # exact scores never read the noise dimension
    y = rng.standard_normal((n_items, f)).astype(np.float32)
    if corrupted:
        y[:, 0] = 1000.0 * rng.choice([-1.0, 1.0], size=n_items)
    else:
        y[:, 0] = 0.0
    art = ModelArtifact(
        "als",
        extensions={
            "features": str(f), "lambda": "0.001", "alpha": "1.0",
            "implicit": "true", "logStrength": "false",
        },
        tensors={"X": x, "Y": y},
    )
    art.set_extension("XIDs", [f"u{j}" for j in range(n_users)])
    art.set_extension("YIDs", [f"i{j}" for j in range(n_items)])
    return art.to_string()


@scenario("fleet-canary",
          "degraded-model at fleet scale: a noise-corrupted generation is "
          "published behind a canary-enabled fleet — it must adopt on the "
          "canary replica ONLY (hold replicas park it), the quality gate "
          "must refuse promotion and auto-roll the canary back to the "
          "previous generation as a pure pointer swap from the pinned "
          "artifact cache (zero re-download bytes), the front's clients "
          "must see zero non-shed 5xx throughout, and the merged flight "
          "rings must tell the story in order: canary-start -> "
          "quality-alarm -> canary-rollback")
def fleet_canary(tmp: str, live: list) -> list[str]:
    import http.client
    import subprocess
    import threading

    from oryx_tpu_torch.bus.broker import get_broker, topics
    from oryx_tpu_torch.common import flightrec
    from oryx_tpu_torch.common.artifact import publish_model_ref
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.executil import (
        config_overlay_from_sets,
        free_port_run,
    )
    from oryx_tpu_torch.common.freshness import publish_stamp
    from oryx_tpu_torch.fleet import FleetController, FleetFront, FleetSupervisor

    bus = f"file://{os.path.join(tmp, 'bus')}"
    topics.maybe_create(bus, "OryxInput", 1)
    topics.maybe_create(bus, "OryxUpdate", 1)
    broker = get_broker(bus)

    class _Prod:
        """publish_model_ref's producer shape over the raw broker."""

        def send(self, key: str, message: str) -> None:
            broker.send("OryxUpdate", key, message)

    def publish(gen: int, corrupted: bool) -> None:
        # MODEL-CHUNK train + MODEL-REF (not an inline MODEL): the
        # zero-re-download rollback claim is only measurable when model
        # bytes flow through the artifact relay's counted cache
        publish_model_ref(
            _Prod(), _quality_model_message(gen, corrupted),
            os.path.join(tmp, "models", f"gen-{gen}"),
            max_message_size=65536,
        )
        broker.send(
            "OryxUpdate", "TRACE",
            publish_stamp(generation=gen, quality={"auc": 0.9}),
        )

    publish(1, corrupted=False)

    base_port = free_port_run(2)
    front_flight = os.path.join(tmp, "front-flight")
    data_dir = os.path.join(tmp, "fleet")
    sets = [
        "oryx.id=chaos-canary",
        f"oryx.input-topic.broker={bus}",
        f"oryx.update-topic.broker={bus}",
        "oryx.serving.model-manager-class="
        "oryx_tpu_torch.apps.als.serving.ALSServingModelManager",
        'oryx.serving.application-resources='
        '["oryx_tpu_torch.serving.resources.common",'
        '"oryx_tpu_torch.serving.resources.als"]',
        # replicas open the card unless told otherwise: here, the CPU
        "oryx.compute.platform=cpu",
        "oryx.serving.api.read-only=true",
        "oryx.serving.api.loops=1",
        # quantized scoring is what the corrupted geometry breaks; shadow
        # sampling at 1.0 measures it on every request
        "oryx.serving.api.score-mode=quantized",
        "oryx.monitoring.quality.sample-rate=1.0",
        "oryx.monitoring.quality.window-sec=60",
        "oryx.monitoring.quality.alarm-burn-rate=5",
        "oryx.monitoring.slo.quality.objective=0.95",
        "oryx.monitoring.slo.quality.recall-floor=0.9",
        "oryx.monitoring.slo.fast-window-sec=60",
        "oryx.fleet.replicas=2",
        f"oryx.fleet.base-port={base_port}",
        f"oryx.fleet.data-dir={data_dir}",
        "oryx.fleet.supervisor.restart=false",
        "oryx.fleet.front.probe-interval-sec=0.2",
        "oryx.fleet.front.eject-after=3",
        "oryx.fleet.canary.enabled=true",
        "oryx.fleet.canary.traffic-fraction=0.5",
        "oryx.fleet.canary.min-samples=8",
        # the verdict must be the QUALITY gate's: the slow first requests
        # of CPU replicas must not let the latency leg fire first
        "oryx.fleet.canary.max-latency-burn=1e9",
        "oryx.fleet.canary.hold-timeout-sec=120",
        f"oryx.monitoring.flight.dir={front_flight}",
    ]
    cfg = load_config(overlay=config_overlay_from_sets(sets))
    argv = [x for s in sets for x in ("--set", s)]
    problems: list[str] = []
    sup = FleetSupervisor(
        cfg, argv=argv, env=_child_env(tmp),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    live.append(sup.stop)
    front = None
    stop = threading.Event()
    driving = threading.Event()
    driving.set()
    counts = {"ok": 0, "shed": 0, "non_shed_5xx": 0, "other": 0,
              "client_error": 0}
    lock = threading.Lock()

    def client(front_port: int) -> None:
        conn = None
        j = 0
        while not stop.is_set():
            if not driving.is_set():
                # paused: the scenario holds traffic while the corrupted
                # generation adopts, so the quality story provably starts
                # AFTER the canary split does
                time.sleep(0.05)
                continue
            if conn is None:
                conn = http.client.HTTPConnection(
                    "127.0.0.1", front_port, timeout=30
                )
            try:
                conn.request("GET", f"/recommend/u{j % 64}?howMany=10")
                r = conn.getresponse()
                retry_after = r.getheader("Retry-After")
                r.read()
                with lock:
                    if r.status == 200:
                        counts["ok"] += 1
                    elif r.status == 503 and retry_after:
                        counts["shed"] += 1
                    elif r.status >= 500:
                        counts["non_shed_5xx"] += 1
                    else:
                        counts["other"] += 1
            except Exception:
                with lock:
                    counts["client_error"] += 1
                try:
                    conn.close()
                except Exception:
                    pass
                conn = None
            j += 1

    def _scrape(host: str, port: int, path: str) -> tuple[int, str]:
        c = http.client.HTTPConnection(host, port, timeout=10)
        try:
            c.request("GET", path)
            r = c.getresponse()
            return r.status, r.read().decode("utf-8", "replace")
        finally:
            c.close()

    def scrape_json(port: int, path: str) -> dict:
        _, body = _scrape("127.0.0.1", port, path)
        return json.loads(body)

    def dist_bytes(port: int) -> float:
        """Sum of oryx_fleet_distribution_bytes across modes on one
        replica — the rollback must not move it by a single byte."""
        import re

        _, text = _scrape("127.0.0.1", port, "/metrics")
        total = 0.0
        for line in text.splitlines():
            m = re.match(r"oryx_fleet_distribution_bytes\{[^}]*\} (\S+)", line)
            if m:
                total += float(m.group(1))
        return total

    canary_port, hold_port = sup.ports()
    threads: list[threading.Thread] = []
    try:
        sup.start()
        sup.wait_listening(90)
        for _, host, port in sup.backends():
            deadline = time.time() + 60
            while True:
                status, _ = _scrape(host, port, "/ready")
                if status == 200:
                    break
                if time.time() > deadline:
                    raise RuntimeError(f"replica :{port} never became ready")
                time.sleep(0.3)
        front = FleetFront(cfg, backends=sup.backends(), port=0)
        live.append(front.close)
        front.start()
        # the controller is built but NOT started: the scenario drives
        # tick() itself so the bytes-before-rollback scrape can never
        # race the tick that performs the rollback
        controller = FleetController(cfg, sup, front)

        # phase 0: arm the hold replica — its unarmed gate must pin to
        # the incumbent generation before the bad one is published, or
        # bootstrap adopt-everything would swallow generation 2 fleet-wide
        deadline = time.time() + 30
        while True:
            controller.tick()
            hold = next(r for r in front.replicas if r.id == "r1")
            if (hold.model_gate or {}).get("watermark") == 1:
                break
            if time.time() > deadline:
                problems.append(
                    f"hold replica r1 never armed at generation 1 "
                    f"(model_gate={hold.model_gate})"
                )
                return problems
            time.sleep(0.2)

        threads = [
            threading.Thread(target=client, args=(front.port,))
            for _ in range(2)
        ]
        for t in threads:
            t.start()
        time.sleep(1.0)  # a little incumbent traffic: r1's recall baseline

        # phase 1: the corrupted generation — canary adopts, holds park.
        # Traffic pauses until the controller opens the canary split, so
        # every generation-2 quality sample postdates the canary-start
        # event (the story's ordering is then causal, not a race).
        driving.clear()
        publish(2, corrupted=True)
        saw_start = False
        deadline = time.time() + 60
        while time.time() < deadline and not saw_start:
            controller.tick()
            saw_start = any(
                e.get("kind") == "canary-start"
                for e in flightrec.read_events(front_flight)
            )
            if not saw_start:
                time.sleep(0.2)
        driving.set()

        # the judge refuses promotion and rolls back
        bytes_before = None
        rolled_back = False
        deadline = time.time() + 90
        while time.time() < deadline:
            # scrape BEFORE the tick that may roll back: the last value
            # captured here is the canary's byte counter with generation
            # 2 fully adopted, immediately prior to the pointer swap
            bytes_before = dist_bytes(canary_port)
            controller.tick()
            events = flightrec.read_events(front_flight)
            if any(e.get("kind") == "canary-rollback" for e in events):
                rolled_back = True
                break
            time.sleep(0.2)
        stop.set()
        for t in threads:
            t.join(timeout=30)

        if not saw_start:
            problems.append("no canary-start flight event was recorded")
        if not rolled_back:
            problems.append(
                "the controller never rolled the corrupted generation back"
            )
            return problems

        # containment: generation 2 adopted on the canary only — the hold
        # replica parked it (still pending, never loaded) and serves 1
        hold_hz = scrape_json(hold_port, "/healthz")
        if hold_hz.get("model_generation") != 1:
            problems.append(
                f"hold replica serves generation "
                f"{hold_hz.get('model_generation')} — the corrupted "
                "generation escaped the canary"
            )
        hold_gate = hold_hz.get("model_gate") or {}
        if hold_gate.get("pending_generation") != 2:
            problems.append(
                f"hold replica's gate should still park generation 2 "
                f"(model_gate={hold_gate})"
            )
        # rollback re-pinned generation 1 on the canary, vetoed 2
        canary_hz = scrape_json(canary_port, "/healthz")
        if canary_hz.get("model_generation") != 1:
            problems.append(
                f"canary serves generation "
                f"{canary_hz.get('model_generation')} after rollback, want 1"
            )
        canary_gate = canary_hz.get("model_gate") or {}
        if 2 not in (canary_gate.get("vetoed") or []):
            problems.append(
                f"rolled-back generation 2 not vetoed: {canary_gate}"
            )
        # the pointer-swap claim: rollback resolved generation 1 from the
        # pinned relay cache — the canary's distribution-bytes counter
        # must not have moved across the rollback tick
        bytes_after = dist_bytes(canary_port)
        if bytes_before is None or bytes_after != bytes_before:
            problems.append(
                f"rollback re-downloaded model bytes: "
                f"oryx_fleet_distribution_bytes {bytes_before} -> "
                f"{bytes_after}, want unchanged"
            )
        # promotion was refused, not just delayed
        events = flightrec.read_events(front_flight)
        if any(e.get("kind") == "canary-promote" for e in events):
            problems.append(
                "a canary-promote event was recorded for the corrupted "
                "generation"
            )
        rollbacks = [e for e in events if e.get("kind") == "canary-rollback"]
        if rollbacks and rollbacks[0].get("generation") != 2:
            problems.append(
                f"canary-rollback names generation "
                f"{rollbacks[0].get('generation')}, want 2"
            )
        # the front's clients never saw a non-shed failure
        if counts["non_shed_5xx"]:
            problems.append(
                f"{counts['non_shed_5xx']} non-shed 5xx reached the front's "
                f"clients (counts={counts})"
            )
        if counts["client_error"]:
            problems.append(
                f"{counts['client_error']} client-level errors talking to "
                f"the front (counts={counts})"
            )
        # the merged flight rings tell the story in order: the canary
        # replica's own ring holds the quality-alarm, the front's holds
        # the controller's start/rollback decisions
        canary_ring = flightrec.read_events(
            os.path.join(data_dir, "r0", "flight")
        )
        alarms = [
            e for e in canary_ring
            if e.get("kind") == "quality-alarm" and e.get("generation") == 2
        ]
        starts = [e for e in events if e.get("kind") == "canary-start"]
        if not alarms:
            problems.append(
                "the canary replica recorded no quality-alarm flight event "
                "for generation 2"
            )
        elif starts and rollbacks:
            t_start = starts[0]["ts_ms"]
            t_alarm = alarms[0]["ts_ms"]
            t_roll = rollbacks[0]["ts_ms"]
            if not (t_start <= t_alarm <= t_roll):
                problems.append(
                    "flight story out of order: canary-start@"
                    f"{t_start} quality-alarm@{t_alarm} canary-rollback@"
                    f"{t_roll}"
                )
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        if front is not None:
            front.close()
        sup.stop()
    return problems
