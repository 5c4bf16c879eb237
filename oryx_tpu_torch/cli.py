"""Operational CLI — the oryx-run.sh + deploy/Main.java tier (the port's
copy of oryx_tpu/cli.py):

  python -m oryx_tpu_torch.cli batch   --conf oryx.conf   run the batch layer
  python -m oryx_tpu_torch.cli speed   --conf oryx.conf   run the speed layer
  python -m oryx_tpu_torch.cli serving --conf oryx.conf   run the serving layer
  python -m oryx_tpu_torch.cli setup   --conf oryx.conf   create the two topics
  python -m oryx_tpu_torch.cli tail    --conf oryx.conf   tail input+update topics
  python -m oryx_tpu_torch.cli input   --conf oryx.conf   stdin lines -> input topic
  python -m oryx_tpu_torch.cli fleet   --conf oryx.conf   N serving replicas + front
  python -m oryx_tpu_torch.cli config | import-pmml | flight | perf | loadtest

The three layers run on the CUDA card (each raises without one) unless
``oryx.compute.platform`` names another torch device: ``cpu`` runs the
layer on the CPU because the operator asked for it. ``--set key=value``
overrides a config key (repeatable); ``--app <name>`` (als | kmeans | rdf
| example | seq) overlays the packaged app's classes and serving resources
(apps/spi.py) underneath any explicit ``--set``. With
``oryx.serving.api.processes = N > 1`` the serving command supervises N
replica processes sharing one port through SO_REUSEPORT, each opening the
card itself; ``fleet`` runs N replicas on distinct ports behind the fleet
front (fleet/), each opening the card itself too. The JAX package's
``pod`` command is not ported yet (ROADMAP queue 1 item 11) and exits
with a message.
"""

from __future__ import annotations

import argparse
import json
import logging
import pathlib
import signal
import sys
import time

from oryx_tpu_torch.common.config import Config, load_config

_NOT_PORTED = {
    "pod": "ROADMAP queue 1 item 11",
}


def _parse_args(argv):
    p = argparse.ArgumentParser(prog="oryx_tpu_torch", description=__doc__)
    p.add_argument(
        "command",
        choices=[
            "batch", "speed", "serving", "setup", "tail", "input",
            "import-pmml", "loadtest", "config", "pod", "fleet", "flight",
            "perf",
        ],
    )
    p.add_argument(
        "--app", default=None, metavar="NAME",
        help="packaged app to run (registry lookup, apps/spi.py): als | "
        "kmeans | rdf | example | seq. Overlays the app's batch/speed/"
        "serving classes and serving resources underneath any explicit --set",
    )
    p.add_argument(
        "--replicas", type=int, default=None,
        help="fleet: serving replica processes to supervise on this host "
        "(overrides oryx.fleet.replicas)",
    )
    p.add_argument(
        "--front-port", type=int, default=None,
        help="fleet: listening port of the L7 fleet front (overrides "
        "oryx.fleet.front.port)",
    )
    p.add_argument(
        "--policy", choices=["round-robin", "hash"], default=None,
        help="fleet: front placement policy (overrides "
        "oryx.fleet.front.policy; hash = consistent-hash-by-user)",
    )
    p.add_argument(
        "--shards", type=int, default=None,
        help="fleet: device-view shards per replica (overrides "
        "oryx.fleet.shards); only 1 until sharded views are ported",
    )
    p.add_argument("--conf", help="user config file (HOCON-like key paths)")
    p.add_argument(
        "--url",
        help="loadtest/perf: base URL of a running serving layer "
        "(default http://localhost:<oryx.serving.api.port>)",
    )
    p.add_argument(
        "--paths",
        help="loadtest: file of request paths to replay round-robin, one "
        "per line (default: stdin; lines like /recommend/u1?howMany=10)",
    )
    p.add_argument(
        "--rate", type=float, default=0.0,
        help="loadtest: target requests/sec, 0 = as fast as possible",
    )
    p.add_argument(
        "--duration", type=float, default=30.0,
        help="loadtest: seconds to run (default 30)",
    )
    p.add_argument(
        "--workers", type=int, default=32,
        help="loadtest: concurrent client connections (default 32)",
    )
    p.add_argument(
        "--http2", action="store_true",
        help="loadtest: speak HTTP/2 (prior knowledge on cleartext, ALPN "
        "over TLS) instead of HTTP/1.1",
    )
    p.add_argument(
        "--loops", type=int, default=None,
        help="serving: async-frontend event-loop threads, each with its "
        "own SO_REUSEPORT listener sharing ONE model (overrides "
        "oryx.serving.api.loops; 0 = one per CPU core)",
    )
    p.add_argument(
        "--sync-mode", choices=["delta", "full", "blocking"], default=None,
        help="serving: how device/host scoring views track live model "
        "updates (overrides oryx.serving.api.sync.mode)",
    )
    p.add_argument(
        "--sync-headroom", type=float, default=None,
        help="serving: device-matrix row headroom fraction over the "
        "current store size (overrides "
        "oryx.serving.api.sync.capacity-headroom)",
    )
    p.add_argument(
        "--full-rebuild", action="store_true",
        help="batch: disable incremental generations for this run "
        "(oryx.batch.storage.incremental.enabled=false)",
    )
    p.add_argument(
        "--trace", action="store_true",
        help="enable request/generation span tracing "
        "(oryx.monitoring.tracing.enabled=true); inspect recorded spans "
        "at GET /debug/traces on the serving layer",
    )
    p.add_argument(
        "--pmml",
        help="PMML file to import (import-pmml): published to the update "
        "topic as a MODEL so running speed/serving layers pick it up",
    )
    p.add_argument(
        "--kind", action="append", default=None, metavar="EVENT_KIND",
        help="flight: only print events of these kinds (repeatable)",
    )
    p.add_argument(
        "--set",
        action="append",
        default=[],
        metavar="KEY=VALUE",
        help="config override, repeatable (e.g. --set oryx.serving.api.port=8080)",
    )
    args, unknown = p.parse_known_args(argv)
    if args.command in _NOT_PORTED:
        raise SystemExit(
            f"{args.command}: not ported yet to oryx_tpu_torch "
            f"({_NOT_PORTED[args.command]}); run it with python -m oryx_tpu.cli"
        )
    if unknown:
        p.error(f"unrecognized arguments: {' '.join(unknown)}")
    return args


def _build_config(args) -> Config:
    from oryx_tpu_torch.common.executil import config_overlay_from_sets

    for kv in args.set:
        if "=" not in kv:
            raise SystemExit(f"--set needs KEY=VALUE, got: {kv}")
    return load_config(args.conf, overlay=config_overlay_from_sets(args.set))


def _topic_pairs(config: Config) -> list[tuple[str, str, int]]:
    return [
        (
            config.get_string(f"oryx.{t}-topic.broker"),
            config.get_string(f"oryx.{t}-topic.message.topic"),
            config.get_int(f"oryx.{t}-topic.message.partitions", 1),
        )
        for t in ("input", "update")
    ]


def cmd_setup(config: Config) -> int:
    """Create input/update topics (oryx-run.sh kafka-setup)."""
    from oryx_tpu_torch.bus.broker import topics

    for uri, topic, partitions in _topic_pairs(config):
        topics.maybe_create(uri, topic, partitions)
        print(f"ready: {uri} {topic} ({partitions} partitions)")
    return 0


def cmd_tail(config: Config) -> int:
    """Follow both topics, printing topic<TAB>key<TAB>message
    (oryx-run.sh kafka-tail)."""
    from oryx_tpu_torch.bus.broker import get_broker

    pairs = _topic_pairs(config)
    brokers = {uri: get_broker(uri) for uri, _, _ in pairs}
    positions: dict[tuple[str, str, int], int] = {}
    for uri, topic, _ in pairs:
        for part, end in enumerate(brokers[uri].end_offsets(topic)):
            positions[(uri, topic, part)] = end
    stop = []
    signal.signal(signal.SIGINT, lambda *_: stop.append(True))
    while not stop:
        idle = True
        for (uri, topic, part), off in list(positions.items()):
            recs = brokers[uri].read(topic, part, off, 100)
            for o, key, msg in recs:
                print(f"{topic}\t{key}\t{msg}", flush=True)
                positions[(uri, topic, part)] = o + 1
                idle = False
        if idle:
            time.sleep(0.2)
    return 0


_INPUT_BATCH = 10_000  # stdin lines a produce request carries


def cmd_input(config: Config) -> int:
    """Pump stdin lines into the input topic, keyed by line hash
    (oryx-run.sh kafka-input; keying as AbstractOryxResource.sendInput).
    crc32, not the builtin hash: the builtin is salted per process and
    would shuffle partition assignment between runs. Lines go out in
    batches of _INPUT_BATCH, which land in the partitions and the order
    that one send per line gives."""
    import zlib

    from oryx_tpu_torch.bus.broker import get_broker

    uri, topic, _ = _topic_pairs(config)[0]
    broker = get_broker(uri)
    n = 0
    pending: list[tuple[str, str]] = []
    t0 = time.perf_counter()
    for line in sys.stdin:
        line = line.rstrip("\n")
        if line:
            pending.append((str(zlib.crc32(line.encode("utf-8"))), line))
            if len(pending) >= _INPUT_BATCH:
                broker.send_batch(topic, pending)
                n += len(pending)
                pending = []
    if pending:
        broker.send_batch(topic, pending)
        n += len(pending)
    dt = time.perf_counter() - t0
    print(f"sent {n} lines to {topic} in {dt:.3f} s", file=sys.stderr)
    return 0


def cmd_import_pmml(config: Config, pmml_path: str | None = None) -> int:
    """Migrate a reference-published PMML model: parse it into a native
    artifact and publish it as a MODEL update (the message running
    speed/serving layers already understand)."""
    from oryx_tpu_torch.bus.broker import get_broker
    from oryx_tpu_torch.common.pmml import pmml_to_artifact

    if not pmml_path:
        raise SystemExit("import-pmml requires --pmml <file>")
    with open(pmml_path, encoding="utf-8") as f:
        art = pmml_to_artifact(f.read())
    uri, topic, _ = _topic_pairs(config)[1]
    broker = get_broker(uri)
    serialized = art.to_string()
    max_size = config.get_int("oryx.update-topic.message.max-size", 16 * 1024 * 1024)
    if len(serialized.encode("utf-8")) <= max_size:
        broker.send(topic, "MODEL", serialized)
    else:
        # same inline-vs-reference cutover as MLUpdate.publish_model
        # (MLUpdate.java:212-231): oversized models go to the model store
        # and only the path rides the topic
        from oryx_tpu_torch.common.ioutil import strip_scheme

        model_dir = strip_scheme(config.get_string("oryx.batch.storage.model-dir"))
        dest = pathlib.Path(model_dir) / f"imported-{int(time.time() * 1000)}"
        art.write(dest)
        broker.send(topic, "MODEL-REF", str(dest))
    print(f"imported {art.app} model from {pmml_path} -> {topic}", file=sys.stderr)
    return 0


def _apply_platform(config: Config) -> bool:
    """Make ``oryx.compute.platform`` the device the layers resolve by
    default: "auto" is the CUDA card; any other value names a torch device
    ("cpu", "cuda:1"), which the operator asked for. Never imports JAX.
    True when it set one (main() puts the default back on exit)."""
    platform = config.get_string("oryx.compute.platform", "auto")
    if platform in (None, "", "auto"):
        return False
    from oryx_tpu_torch import device

    try:
        device.set_platform(platform)
    except ValueError as e:
        raise SystemExit(str(e))
    return True


def _run_until_interrupt(layer) -> int:
    stop = signal.getsignal(signal.SIGTERM)
    signal.signal(signal.SIGTERM, lambda *_: layer.close())
    try:
        layer.start()
        layer.await_termination()
    except KeyboardInterrupt:
        pass
    finally:
        layer.close()
        signal.signal(signal.SIGTERM, stop)
    return 0


def cmd_config(config: Config) -> int:
    """Print the EFFECTIVE config (defaults + user file + overrides) as
    flattened key=value lines — the reference's ConfigToProperties surface
    (deploy/bin/oryx-run.sh:90 pipes it into shell scripts). Globally
    sorted so diffs between deployments are line diffs."""
    from oryx_tpu_torch.common.config import _SECRET_RE

    for path, v in sorted(config.flatten().items()):
        if _SECRET_RE.search(path) and v is not None:
            v = "*****"  # same redaction as Config.pretty
        elif isinstance(v, list):
            v = ",".join(str(x) for x in v)
        elif v is None:
            v = ""
        elif isinstance(v, bool):
            v = str(v).lower()
        print(f"{path}={v}")
    return 0


def cmd_flight(config: Config, kinds: list[str] | None = None) -> int:
    """Print the configured flight-recorder ring as JSONL, oldest first —
    the offline face of GET /debug/flight: works on a dead process's dir,
    so an operator reads a crash-looping replica's last words with

        python -m oryx_tpu_torch.cli flight \\
            --set oryx.monitoring.flight.dir=/tmp/oryx_tpu/flight

    ``--kind`` (repeatable) filters to just those event kinds. Unknown
    kinds fail loudly instead of silently printing nothing."""
    from oryx_tpu_torch.common.flightrec import EVENT_KINDS, read_events

    if kinds:
        unknown = sorted(set(kinds) - set(EVENT_KINDS))
        if unknown:
            print(
                f"unknown flight event kind(s): {', '.join(unknown)} "
                f"(known: {', '.join(sorted(EVENT_KINDS))})",
                file=sys.stderr,
            )
            return 2
    flight_dir = config.get_string(
        "oryx.monitoring.flight.dir", "file:/tmp/oryx_tpu/flight"
    )
    events = read_events(flight_dir)
    total = len(events)
    if kinds:
        wanted = set(kinds)
        events = [ev for ev in events if ev.get("kind") in wanted]
    for ev in events:
        print(json.dumps(ev))
    tail = f" ({total} total)" if kinds else ""
    print(f"# {len(events)} event(s) in {flight_dir}{tail}", file=sys.stderr)
    return 0


# Families the `perf` report reads (common/perfattr.py registers them,
# under the JAX package's names: the compile families count the CUDA
# kernel library's first load here).
_PHASE_FAMILY = "oryx_request_phase_seconds"
_IDLE_FAMILY = "oryx_device_idle_gap_seconds"
_COMPILE_HIST = "oryx_xla_compile_seconds"
_COMPILE_TOTAL = "oryx_xla_compiles_total"


def _parse_metric_sample(
    line: str,
) -> tuple[str, dict[str, str], float] | None:
    """One exposition sample line -> (name, labels, value); None for
    unparseable lines. Exemplars (`... # {...}`) are dropped."""
    brace = line.find("{")
    space = line.find(" ")
    if brace != -1 and (space == -1 or brace < space):
        end = line.find("}", brace)
        if end < 0:
            return None
        name = line[:brace]
        labels: dict[str, str] = {}
        for part in line[brace + 1 : end].split(","):
            k, eq, v = part.partition("=")
            if eq:
                labels[k.strip()] = v.strip().strip('"')
        rest = line[end + 1 :]
    elif space > 0:
        name, labels, rest = line[:space], {}, line[space:]
    else:
        return None
    toks = rest.split("#", 1)[0].split()
    if not toks:
        return None
    try:
        return name, labels, float(toks[0])
    except ValueError:
        return None


def _bucket_quantile(
    buckets: list[tuple[float, float]], q: float
) -> float | None:
    """Nearest-rank quantile estimate from cumulative histogram buckets
    (sorted by upper bound): the upper bound of the bucket holding the
    rank. +Inf means the quantile is beyond the largest finite bound."""
    if not buckets:
        return None
    total = buckets[-1][1]
    if total <= 0:
        return None
    target = q * total
    for bound, cum in buckets:
        if cum >= target:
            return bound
    return buckets[-1][0]


def _fmt_bound_ms(bound: float | None, buckets: list[tuple[float, float]]) -> str:
    if bound is None:
        return "-"
    if bound == float("inf"):
        finite = [b for b, _ in buckets if b != float("inf")]
        return f">{finite[-1] * 1000:.3g}ms" if finite else "inf"
    return f"{bound * 1000:.3g}ms"


def render_perf_report(text: str) -> str:
    """Pure renderer: /metrics exposition text -> the ``perf`` report
    (testable without a live replica). Phase p50/p99 are
    bucket-upper-bound estimates, phase share is share of summed phase
    seconds, idle-gap causes rank by total attributed seconds."""
    from oryx_tpu_torch.fleet.observe import parse_exposition

    families, _ = parse_exposition(text)

    def samples(family: str) -> list[tuple[str, dict[str, str], float]]:
        f = families.get(family)
        if f is None:
            return []
        out = []
        for line in f.samples.get("", []):
            parsed = _parse_metric_sample(line)
            if parsed is not None:
                out.append(parsed)
        return out

    lines: list[str] = []

    # -- request phase budget ---------------------------------------------
    buckets: dict[str, list[tuple[float, float]]] = {}
    sums: dict[str, float] = {}
    counts: dict[str, float] = {}
    for name, labels, value in samples(_PHASE_FAMILY):
        phase = labels.get("phase", "")
        if name == _PHASE_FAMILY + "_bucket":
            le = labels.get("le", "+Inf")
            bound = float("inf") if le in ("+Inf", "inf") else float(le)
            buckets.setdefault(phase, []).append((bound, value))
        elif name == _PHASE_FAMILY + "_sum":
            sums[phase] = value
        elif name == _PHASE_FAMILY + "_count":
            counts[phase] = value
    lines.append(f"latency budget ({_PHASE_FAMILY})")
    total_s = sum(sums.values())
    if counts:
        lines.append(
            f"  {'phase':<16}{'count':>8}{'p50':>10}{'p99':>10}{'share':>8}"
        )
        for phase in sorted(
            counts, key=lambda p: sums.get(p, 0.0), reverse=True
        ):
            bs = sorted(buckets.get(phase, []))
            share = sums.get(phase, 0.0) / total_s if total_s else 0.0
            lines.append(
                f"  {phase:<16}{int(counts[phase]):>8}"
                f"{_fmt_bound_ms(_bucket_quantile(bs, 0.50), bs):>10}"
                f"{_fmt_bound_ms(_bucket_quantile(bs, 0.99), bs):>10}"
                f"{share:>7.1%}"
            )
    else:
        lines.append("  (no phase samples yet)")

    # -- device idle gaps --------------------------------------------------
    gap_sums: dict[str, float] = {}
    gap_counts: dict[str, float] = {}
    for name, labels, value in samples(_IDLE_FAMILY):
        cause = labels.get("cause", "")
        if name == _IDLE_FAMILY + "_sum":
            gap_sums[cause] = value
        elif name == _IDLE_FAMILY + "_count":
            gap_counts[cause] = value
    lines.append("")
    lines.append(f"device idle gaps ({_IDLE_FAMILY})")
    gap_total = sum(gap_sums.values())
    if gap_sums:
        lines.append(f"  {'cause':<18}{'gaps':>8}{'total':>12}{'share':>8}")
        for cause in sorted(gap_sums, key=gap_sums.__getitem__, reverse=True):
            share = gap_sums[cause] / gap_total if gap_total else 0.0
            lines.append(
                f"  {cause:<18}{int(gap_counts.get(cause, 0)):>8}"
                f"{gap_sums[cause]:>11.3f}s{share:>7.1%}"
            )
    else:
        lines.append("  (no idle-gap samples yet)")

    # -- compiles (the kernel library's loads) -----------------------------
    comp_n: dict[str, float] = {}
    comp_s: dict[str, float] = {}
    for name, labels, value in samples(_COMPILE_TOTAL):
        if name == _COMPILE_TOTAL:
            comp_n[labels.get("kind", "")] = value
    for name, labels, value in samples(_COMPILE_HIST):
        if name == _COMPILE_HIST + "_sum":
            comp_s[labels.get("kind", "")] = value
    lines.append("")
    lines.append(f"xla compiles ({_COMPILE_TOTAL})")
    if comp_n:
        lines.append(f"  {'kind':<12}{'compiles':>10}{'total':>12}{'mean':>10}")
        for kind in sorted(comp_n):
            n, s = comp_n[kind], comp_s.get(kind, 0.0)
            mean = f"{s / n * 1000:.3g}ms" if n else "-"
            lines.append(
                f"  {kind:<12}{int(n):>10}{s:>11.3f}s{mean:>10}"
            )
    else:
        lines.append("  (no compiles recorded yet)")

    return "\n".join(lines) + "\n"


def cmd_perf(config: Config, url: str | None = None) -> int:
    """Live latency budget of one replica, read from its ``/metrics``:
    phase p50/p99 shares, top idle-gap causes, compile counts:

        python -m oryx_tpu_torch.cli perf --url http://replica-3:8080
    """
    import urllib.request

    base = url or (
        f"http://localhost:{config.get_int('oryx.serving.api.port', 8080)}"
    )
    if "://" not in base:
        base = "http://" + base  # bare host:port
    target = base.rstrip("/") + "/metrics"
    try:
        with urllib.request.urlopen(target, timeout=10) as resp:
            text = resp.read().decode("utf-8", "replace")
    except Exception as e:  # noqa: BLE001 - a report fetch fails as a row
        print(
            f"fetch {target} failed: {type(e).__name__}: {e}",
            file=sys.stderr,
        )
        return 1
    print(render_perf_report(text), end="")
    return 0


def cmd_batch(config: Config) -> int:
    from oryx_tpu_torch.layers import BatchLayer

    return _run_until_interrupt(BatchLayer(config))


def cmd_speed(config: Config) -> int:
    from oryx_tpu_torch.layers import SpeedLayer

    return _run_until_interrupt(SpeedLayer(config))


def cmd_serving(config: Config, argv: list[str] | None = None) -> int:
    import os

    from oryx_tpu_torch.serving.server import ServingLayer

    n_procs = config.get_int("oryx.serving.api.processes", 1)
    if n_procs > 1 and not os.environ.get("ORYX_SERVING_REPLICA"):
        return _supervise_serving_replicas(config, n_procs, argv or [])
    return _run_until_interrupt(ServingLayer(config))


def _supervise_serving_replicas(config: Config, n_procs: int, argv: list[str]) -> int:
    """Run N full serving replicas sharing one port via SO_REUSEPORT — the
    kernel load-balances connections, each replica replays the update topic
    into its own model, and per-process GIL ceilings multiply out.

    Requires a fixed port and a cross-process broker (file:// or kafka://;
    mem:// is per-process). Replicas that die are restarted; SIGTERM/INT
    fans out. Each replica opens the card itself (its own CUDA context and
    its own copy of the model's view there); this process opens none, so
    the children start from a clean process, never a fork of a CUDA one.
    Replica i is named ``serving-<i>`` on /healthz and in its flight events
    unless the config names the replica."""
    import os
    import socket as _socket
    import subprocess
    import time as _time

    if config.get_int("oryx.serving.api.port", 0) == 0:
        raise SystemExit("oryx.serving.api.processes > 1 requires a fixed port")
    for key in ("oryx.update-topic.broker", "oryx.input-topic.broker"):
        if config.get_string(key, "").startswith("mem://"):
            raise SystemExit(
                f"serving replicas need a cross-process broker; {key} is mem://"
            )
    if not hasattr(_socket, "SO_REUSEPORT"):
        raise SystemExit("serving replicas require SO_REUSEPORT on this platform")

    named = config.get_string("oryx.fleet.replica.id", None)
    env = dict(os.environ, ORYX_SERVING_REPLICA="1")
    cmd = [sys.executable, "-m", "oryx_tpu_torch.cli", "serving", *argv]
    procs: list[subprocess.Popen] = []
    stopping = False
    log_ = logging.getLogger(__name__)

    spawn_at: dict[int, float] = {}  # pid -> spawn timestamp

    def spawn(i: int) -> subprocess.Popen | None:
        if stopping:
            return None
        extra = [] if named else ["--set", f"oryx.fleet.replica.id=serving-{i}"]
        p = subprocess.Popen(cmd + extra, env=env)
        spawn_at[p.pid] = _time.monotonic()
        return p

    def shutdown(*_):
        nonlocal stopping
        stopping = True

    old = signal.signal(signal.SIGTERM, shutdown)
    rc_out = 0
    try:
        for i in range(n_procs):
            p = spawn(i)
            if p is not None:
                procs.append(p)
        log_.info(
            "serving supervisor: %d replicas on port %d",
            n_procs,
            config.get_int("oryx.serving.api.port", 0),
        )
        consec_fast_fails = 0
        backoff = 1.0
        while not stopping:
            for i, p in enumerate(procs):
                rc = p.poll()
                if rc is not None and not stopping:
                    # a replica that dies within seconds of spawn is a
                    # crash loop (bad config, port conflict): back off,
                    # and give up after repeated immediate failures so
                    # the operator/init system sees a nonzero exit
                    consec_fast_fails += 1
                    if consec_fast_fails >= 3 * n_procs:
                        log_.error(
                            "serving replicas crash-looping (rc=%s); giving up",
                            rc,
                        )
                        stopping = True
                        rc_out = 1
                        break
                    log_.warning(
                        "serving replica died (rc=%s); restarting in %.0fs",
                        rc, backoff,
                    )
                    _time.sleep(backoff)
                    backoff = min(backoff * 2, 30.0)
                    np_ = spawn(i)
                    if np_ is not None:
                        procs[i] = np_
            now = _time.monotonic()
            if not stopping and all(
                p.poll() is None and now - spawn_at.get(p.pid, now) >= 10.0
                for p in procs
            ):
                # counters clear only once every replica has SURVIVED a
                # while — "alive at the instant of the check" describes
                # a freshly respawned crash-looper too
                consec_fast_fails = 0
                backoff = 1.0
            _time.sleep(1.0)
    except KeyboardInterrupt:
        shutdown()
    finally:
        for p in procs:  # fan out termination even to late spawns
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                p.kill()
        signal.signal(signal.SIGTERM, old)
    return rc_out


# every value-taking option of the parser: the child-argv rebuilder below
# must know which flags bind the next bare token so the SUBCOMMAND token
# (the first UNBOUND bare token) is identified correctly
_VALUE_OPTS = {
    "--conf", "--url", "--paths", "--rate", "--duration", "--workers", "--pmml", "--set", "--loops", "--sync-mode",
    "--sync-headroom", "--app", "--kind",
    "--replicas", "--front-port", "--policy", "--shards",
}


def _child_flags(
    raw_argv: list[str],
    drop_value_opts: set[str] = frozenset(),
    drop_bare_flags: frozenset[str] = frozenset(),
) -> list[str]:
    """Rebuild a child command line from a supervisor invocation: drop the
    SUBCOMMAND token and the supervisor-only flags with their values.
    The subcommand is the first bare token NOT bound as the value of a
    value-taking option — argparse accepts options before the positional,
    so `--conf serving serving` must keep --conf's value 'serving' and
    drop the second bare token."""
    out: list[str] = []
    seen_subcommand = False
    i = 0
    while i < len(raw_argv):
        tok = raw_argv[i]
        name = tok.split("=", 1)[0]
        if name in drop_value_opts:
            # separate-token form consumes its value too; '=' form is one
            i += 2 if tok == name else 1
            continue
        if tok in drop_bare_flags:
            i += 1
            continue
        if tok.startswith("-"):
            out.append(tok)
            if tok == name and name in _VALUE_OPTS and i + 1 < len(raw_argv):
                out.append(raw_argv[i + 1])  # bound value: never subcommand
                i += 2
                continue
            i += 1
            continue
        if not seen_subcommand:  # first UNBOUND bare token: the subcommand
            seen_subcommand = True
            i += 1
            continue
        out.append(tok)
        i += 1
    return out


def _fleet_child_flags(raw_argv: list[str]) -> list[str]:
    return _child_flags(
        raw_argv, {"--replicas", "--front-port", "--policy", "--shards"}
    )


def cmd_fleet(config: Config, args, raw_argv: list[str]) -> int:
    """One-host serving fleet: N replica serving processes on distinct
    ports (fleet/supervisor.py) behind the L7 front (fleet/front.py) —
    round-robin or consistent-hash placement, health-driven ejection,
    retry-on-shed, and the controller's canary rollout and autoscaling
    (fleet/control.py):

        python -m oryx_tpu_torch.cli fleet --conf oryx.conf --replicas 2 \\
            --front-port 8090 --policy hash

    Every replica opens the CUDA card itself (``oryx.compute.platform =
    cpu`` in the config or a ``--set`` puts them on the CPU); this process
    opens no device. SIGTERM/SIGINT stop the front first (stop taking
    traffic), then fan out to the replicas. Dead replicas are restarted
    with backoff; a crash-looping fleet exits nonzero. A shard count above
    1 is refused as the serving layer refuses it."""
    from oryx_tpu_torch.apps.als.serving import SyncConfig
    from oryx_tpu_torch.fleet import FleetController, FleetFront, FleetSupervisor

    overlay = {}
    if args.replicas is not None:
        overlay["oryx.fleet.replicas"] = args.replicas
    if args.front_port is not None:
        overlay["oryx.fleet.front.port"] = args.front_port
    if args.policy is not None:
        overlay["oryx.fleet.front.policy"] = args.policy
    if args.shards is not None:
        overlay["oryx.fleet.shards"] = args.shards
    if overlay:
        config = config.overlay(overlay)
    # the replicas' own sync validation, run once here: a sharded fleet
    # fails before any replica starts
    SyncConfig.from_config(config.overlay({
        "oryx.serving.api.sync.shard-count":
            config.get_int("oryx.fleet.shards", 1),
    }))
    sup = FleetSupervisor(config, argv=_fleet_child_flags(raw_argv))
    front = None
    controller = None
    prev_term = signal.signal(signal.SIGTERM, lambda *_: sup.request_stop())
    rc = 0
    try:
        sup.start()
        sup.wait_listening(timeout=120)
        front = FleetFront(config, backends=sup.backends())
        front.start()
        # the closed control loop over both: canary rollout + promotion
        # gating when oryx.fleet.canary.enabled, SLO-burn autoscaling
        # when oryx.fleet.autoscale.enabled (a no-op thread otherwise —
        # it still mirrors crash-loop give-ups into /fleet/status)
        controller = FleetController(config, sup, front)
        controller.start()
        print(
            f"fleet: {len(sup.ports())} replicas on ports "
            f"{sup.ports()[0]}..{sup.ports()[-1]}, front :{front.port} "
            f"({front.policy})",
            flush=True,
        )
        rc = sup.run()
    except KeyboardInterrupt:
        pass
    finally:
        if controller is not None:
            controller.close()  # no new rollout/scale decisions mid-teardown
        if front is not None:
            front.close()  # stop taking traffic before killing backends
        sup.stop()
        signal.signal(signal.SIGTERM, prev_term)
    return rc


class _H2LoadConn:
    """Minimal HTTP/2 prior-knowledge (or ALPN-TLS) client for
    `loadtest --http2`: one in-flight stream at a time — the same
    closed-loop-per-worker semantics as the HTTP/1.1 path — reusing the
    serving tier's own HPACK codec (serving/hpack.py)."""

    def __init__(self, host: str, port: int, tls_ctx=None):
        import socket as _socket
        import struct as _struct

        from oryx_tpu_torch.serving.hpack import Decoder, encode

        self._struct = _struct
        s = _socket.create_connection((host, port), timeout=60)
        s.setsockopt(_socket.IPPROTO_TCP, _socket.TCP_NODELAY, 1)
        if tls_ctx is not None:
            s = tls_ctx.wrap_socket(s, server_hostname=host)
            if s.selected_alpn_protocol() != "h2":
                s.close()
                raise ConnectionError(
                    "server did not negotiate h2 over TLS (ALPN: "
                    f"{s.selected_alpn_protocol()!r}) — drop --http2 or "
                    "point at an h2-capable endpoint"
                )
        self._s = s
        self._f = s.makefile("rb", buffering=1 << 16)
        self._dec = Decoder()
        self._encode = encode
        self._authority = f"{host}:{port}".encode()
        self._scheme = b"https" if tls_ctx is not None else b"http"
        self._sid = -1
        s.sendall(b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n")
        self._frame(0x4, 0, 0)  # empty SETTINGS

    def _frame(self, ftype: int, flags: int, sid: int, payload: bytes = b"") -> None:
        self._s.sendall(
            self._struct.pack(">I", len(payload))[1:]
            + bytes([ftype, flags])
            + self._struct.pack(">I", sid)
            + payload
        )

    def _read_frame(self):
        head = self._f.read(9)
        if len(head) < 9:
            raise ConnectionError("connection closed")
        ln = int.from_bytes(head[:3], "big")
        payload = self._f.read(ln)
        if len(payload) < ln:
            raise ConnectionError("truncated frame")
        return head[3], head[4], int.from_bytes(head[5:9], "big") & 0x7FFFFFFF, payload

    def get(self, path: str) -> int:
        self._sid += 2
        sid = self._sid
        block = self._encode(
            [
                (b":method", b"GET"),
                (b":scheme", self._scheme),
                (b":path", path.encode()),
                (b":authority", self._authority),
            ]
        )
        self._frame(0x1, 0x5, sid, block)  # END_STREAM | END_HEADERS
        status = 0
        while True:
            ftype, flags, fsid, payload = self._read_frame()
            if ftype == 0x4:  # SETTINGS
                if not flags & 0x1:
                    self._frame(0x4, 0x1, 0)
            elif ftype == 0x1:  # HEADERS
                end_stream = bool(flags & 0x1)  # CONTINUATION never carries it
                while not flags & 0x4:  # collect CONTINUATIONs
                    ct, flags, csid, cp = self._read_frame()
                    if ct != 0x9 or csid != fsid:
                        raise ConnectionError("bad CONTINUATION")
                    payload += cp
                # decode EVERY block in wire order (dynamic-table sync),
                # not just our stream's
                hdrs = dict(self._dec.decode(payload))
                if fsid == sid:
                    status = int(hdrs.get(b":status", b"0"))
                    if end_stream:
                        return status
            elif ftype == 0x0:  # DATA
                end_stream = bool(flags & 0x1)
                if payload:
                    # replenish BOTH windows: the connection's (or long
                    # runs stall at 64KB cumulative) and the stream's (or
                    # any single response > 64KB deadlocks the server
                    # mid-body against the default initial window)
                    inc = self._struct.pack(">I", len(payload))
                    self._frame(0x8, 0, 0, inc)
                    if not end_stream:
                        self._frame(0x8, 0, fsid, inc)
                if fsid == sid and end_stream:
                    return status
            elif ftype == 0x7:  # GOAWAY
                raise ConnectionError("server sent GOAWAY")
            elif ftype == 0x3 and fsid == sid:  # RST_STREAM
                raise ConnectionError("stream reset")
            elif ftype == 0x6 and not flags & 0x1:  # PING
                self._frame(0x6, 0x1, 0, payload)

    def close(self) -> None:
        try:
            self._s.close()
        except OSError:
            pass


def _scrape_serving_metrics(host: str, port: int, tls: bool, prefix: str):
    """Best-effort post-run /metrics scrape: how many frontend event
    loops actually served traffic and the batcher's achieved mean batch
    size. None when the endpoint is unreachable/disabled/authed — the
    loadtest report simply omits the server block then."""
    import http.client
    import re

    try:
        conn = (
            http.client.HTTPSConnection(host, port, timeout=5)
            if tls
            else http.client.HTTPConnection(host, port, timeout=5)
        )
        conn.request("GET", (prefix or "") + "/metrics")
        r = conn.getresponse()
        text = r.read().decode("utf-8", "replace")
        conn.close()
        if r.status != 200:
            return None
    except Exception:
        return None
    loops: dict[str, float] = {}
    mean_batch = None
    for line in text.splitlines():
        m = re.match(r'oryx_http_loop_requests\{loop="(\d+)"\} (\S+)', line)
        if m:
            loops[m.group(1)] = float(m.group(2))
        elif line.startswith("oryx_topk_mean_batch "):
            mean_batch = float(line.split()[1])
    out = {}
    if loops:
        out["loops"] = len(loops)
        out["loops_serving"] = sum(1 for v in loops.values() if v > 0)
        out["loop_requests"] = {k: int(v) for k, v in sorted(loops.items())}
    if mean_batch is not None:
        out["mean_device_batch"] = round(mean_batch, 2)
    return out or None


def cmd_loadtest(config: Config, args) -> int:
    """Replay request paths against a running serving layer at a target
    rate and report throughput + latency percentiles — the operational
    face of the reference's test-tree traffic tools (TrafficUtil +
    LoadBenchmark, app/oryx-app-serving/src/test/.../als/LoadBenchmark.java:
    50-100). Open-loop pacing when --rate is set: request start times are
    scheduled, so queueing delay shows up as latency instead of silently
    shrinking offered load (closed-loop clients do the latter)."""
    import http.client
    import threading
    from urllib.parse import urlsplit

    base = args.url or f"http://localhost:{config.get_int('oryx.serving.api.port', 8080)}"
    if "//" not in base:
        base = "http://" + base  # bare host:port
    split = urlsplit(base)
    if split.scheme not in ("http", "https"):
        raise SystemExit(f"loadtest: unsupported URL scheme {split.scheme!r}")
    tls = split.scheme == "https"
    host = split.hostname or "localhost"
    port = split.port or (443 if tls else 80)
    prefix = split.path.rstrip("/")
    if args.paths:
        lines = [ln.strip() for ln in open(args.paths) if ln.strip()]
    else:
        lines = [ln.strip() for ln in sys.stdin if ln.strip()]
    if not lines:
        raise SystemExit("loadtest: no request paths given")

    n_workers = max(1, args.workers)
    lat_ms: list[list[float]] = [[] for _ in range(n_workers)]
    errors = [0] * n_workers
    t_start = time.perf_counter()
    stop_at = t_start + args.duration
    # open-loop schedule: worker w fires request j at its (j*n+w)/rate slot
    rate = args.rate

    class _H1Conn:
        def __init__(self):
            self._c = (
                http.client.HTTPSConnection(host, port, timeout=60)
                if tls
                else http.client.HTTPConnection(host, port, timeout=60)
            )

        def get(self, path: str) -> int:
            self._c.request("GET", path)
            r = self._c.getresponse()
            r.read()
            return r.status

        def close(self) -> None:
            self._c.close()

    def connect():
        if getattr(args, "http2", False):
            ctx = None
            if tls:
                import ssl

                ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
                ctx.check_hostname = False
                ctx.verify_mode = ssl.CERT_NONE
                ctx.set_alpn_protocols(["h2"])
            return _H2LoadConn(host, port, ctx)
        return _H1Conn()

    def worker(w: int) -> None:
        # the h2 client connects eagerly in __init__ (preface+SETTINGS);
        # a refused connect must count as an error and retry, not kill
        # the worker with {"requests": 0, "errors": 0} as the epitaph
        conn = None
        j = 0
        while True:
            now = time.perf_counter()
            if now >= stop_at:
                break
            if conn is None:
                try:
                    conn = connect()
                except Exception:
                    errors[w] += 1
                    time.sleep(0.1)
                    continue
            due = now
            if rate > 0:
                due = t_start + (j * n_workers + w) / rate
                if due >= stop_at:
                    break
                if due > now:
                    time.sleep(due - now)
            path = prefix + lines[(j * n_workers + w) % len(lines)]
            # latency counts from the SCHEDULED slot: when the server (or
            # this worker) falls behind, the slip shows up in the
            # percentiles instead of silently shrinking offered load
            t0 = min(due, time.perf_counter()) if rate > 0 else time.perf_counter()
            try:
                if conn.get(path) == 200:
                    lat_ms[w].append((time.perf_counter() - t0) * 1000)
                else:
                    errors[w] += 1
            except Exception:
                errors[w] += 1
                conn.close()
                conn = None  # reconnect (with error accounting) next loop
            j += 1
        if conn is not None:
            conn.close()

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.perf_counter() - t_start
    lats = sorted(x for ws in lat_ms for x in ws)
    n_ok, n_err = len(lats), sum(errors)
    if not lats:
        print(json.dumps({"requests": 0, "errors": n_err, "seconds": round(dt, 2)}))
        return 1
    pct = lambda p: round(lats[min(len(lats) - 1, int(p / 100 * len(lats)))], 2)
    report = {
        "requests": n_ok,
        "errors": n_err,
        "seconds": round(dt, 2),
        "qps": round(n_ok / dt, 1),
        "latency_ms": {
            "p50": pct(50), "p90": pct(90), "p99": pct(99),
            "max": round(lats[-1], 2),
        },
        "target_rate": rate or "unlimited",
        "workers": n_workers,
    }
    # server-side view of the same run: loop fan-out coverage + achieved
    # device batch size, so a frontend-scaling regression (one loop doing
    # all the work, batches collapsing to 1) is visible in the report
    server_stats = _scrape_serving_metrics(host, port, tls, prefix)
    if server_stats is not None:
        report["server"] = server_stats
    print(json.dumps(report))
    return 0


def main(argv=None) -> int:
    args = _parse_args(argv if argv is not None else sys.argv[1:])
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    if args.app is not None:
        # app-registry lookup (apps/spi.py): PREPEND the app's class/
        # resource wiring so any explicit --set still wins, and keep the
        # --app flag itself in argv so replica children rebuild the same
        # wiring (_child_flags passes value opts through)
        from oryx_tpu_torch.apps.spi import app_overlay

        try:
            overlay = app_overlay(args.app)
        except ValueError as e:
            raise SystemExit(str(e))
        args.set[:0] = [f"{k}={json.dumps(v)}" for k, v in overlay.items()]
    if args.loops is not None:
        # plain config sugar: rides args.set so replica children inherit it
        args.set.append(f"oryx.serving.api.loops={args.loops}")
    if args.trace:
        args.set.append("oryx.monitoring.tracing.enabled=true")
    if args.full_rebuild:
        args.set.append("oryx.batch.storage.incremental.enabled=false")
    if args.sync_mode is not None:
        args.set.append(f"oryx.serving.api.sync.mode={args.sync_mode}")
    if args.sync_headroom is not None:
        args.set.append(
            f"oryx.serving.api.sync.capacity-headroom={args.sync_headroom}"
        )
    config = _build_config(args)
    platform_set = _apply_platform(config)
    try:
        seed = config.get("oryx.test.seed", None)
        if seed is not None:
            # deterministic-run switch (reference RandomManager sysprop)
            from oryx_tpu_torch.common.rng import RandomManager

            RandomManager.use_test_seed(int(seed))
        if args.command == "config":
            return cmd_config(config)
        if args.command == "import-pmml":
            return cmd_import_pmml(config, args.pmml)
        if args.command == "loadtest":
            return cmd_loadtest(config, args)
        if args.command == "serving":
            # replica children re-run this exact command line minus the
            # subcommand token (argparse accepts options BEFORE the
            # positional)
            raw = list(argv if argv is not None else sys.argv[1:])
            return cmd_serving(config, _child_flags(raw))
        if args.command == "fleet":
            raw = list(argv if argv is not None else sys.argv[1:])
            return cmd_fleet(config, args, raw)
        if args.command == "flight":
            return cmd_flight(config, args.kind)
        if args.command == "perf":
            return cmd_perf(config, args.url)
        return {
            "batch": cmd_batch,
            "speed": cmd_speed,
            "setup": cmd_setup,
            "tail": cmd_tail,
            "input": cmd_input,
        }[args.command](config)
    finally:
        if platform_set:
            from oryx_tpu_torch import device

            device.set_platform("auto")


if __name__ == "__main__":
    sys.exit(main())
