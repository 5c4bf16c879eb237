"""Resources every app shares: /ready, /healthz, /ingest, /metrics,
/console, /debug/traces, /debug/flight, /debug/profile (the port's copy of
oryx_tpu/serving/resources/common.py).

Mirrors the reference's Ready.java:33-46 (GET/HEAD 200-or-503 on model
load fraction) and Ingest.java (bulk lines -> input topic, gzip-aware via
the server's request decoding), plus the observability endpoints the
reference never had: Prometheus /metrics, a /healthz liveness probe
(distinct from /ready readiness), the /debug/traces span lens
(common/tracing.py), the flight recorder's /debug/flight bundle
(common/flightrec.py) and the /debug/profile capture window
(common/perfstats.py, with a torch.profiler trace), and the model gate's
control plane, POST /control/model/approve and /control/model/rollback
(common/modelgate.py).
"""

from __future__ import annotations

import json
import time

from oryx_tpu_torch.common.metrics import get_registry
from oryx_tpu_torch.common.tracing import chrome_trace, get_tracer, span_forest
from oryx_tpu_torch.serving.app import OryxServingException, RawResponse, Request, ServingApp


def _ingest_text(req: Request) -> str:
    """Body text for /ingest: plain text (frontends already undo
    Content-Encoding: gzip), or every file part of a multipart/form-data
    upload — parity with the reference's AbstractOryxResource
    maybeBuffer/maybeDecompress upload handling, which accepts browser
    form posts of (optionally gzipped) data files."""
    ctype = req.headers.get("content-type", "")
    if not ctype.lower().startswith("multipart/form-data"):
        return req.body_text()
    import gzip
    from email import policy
    from email.parser import BytesParser

    # reuse the stdlib MIME parser by re-wrapping the body with its header
    raw = (f"Content-Type: {ctype}\r\n\r\n").encode("latin-1") + req.body
    msg = BytesParser(policy=policy.default).parsebytes(raw)
    parts = []
    for part in msg.iter_parts():
        name = (part.get_filename() or "").lower()
        if not name:
            # ordinary form fields (hidden tokens, submit values) are not
            # data: only FILE parts ingest, like the reference's FileItem
            # handling
            continue
        payload = part.get_payload(decode=True)
        if payload is None:
            continue
        if name.endswith(".gz") or payload[:2] == b"\x1f\x8b":
            import zlib

            try:
                payload = gzip.decompress(payload)
            except (OSError, EOFError, zlib.error):
                # OSError: bad magic; EOFError: truncated; zlib.error:
                # corrupt deflate stream
                raise OryxServingException(400, f"bad gzip upload: {name}")
        parts.append(payload.decode("utf-8", errors="replace"))
    if not parts:
        raise OryxServingException(400, "no file parts in multipart upload")
    return "\n".join(parts)


def send_input_lines(
    app: ServingApp, text: str, what: str = "data points", required: bool = True
) -> int:
    """Bulk lines -> input topic; 400 when nothing usable was given (unless
    required=False — the wordcount /add treats an empty flush as a no-op).
    The one implementation behind /ingest, /add, and /train."""
    n = 0
    for line in text.splitlines():
        line = line.strip()
        if line:
            app.send_input(line)
            n += 1
    if n == 0 and required:
        raise OryxServingException(400, f"no {what} given")
    return n


def register(app: ServingApp) -> None:
    @app.route("GET", "/ready", nonblocking=True)
    def ready(a: ServingApp, req: Request):
        a.get_serving_model()  # raises 503 if not ready
        return 200, {"ready": True}

    @app.route("HEAD", "/ready", nonblocking=True)
    def ready_head(a: ServingApp, req: Request):
        a.get_serving_model()
        return 200, None

    @app.route("GET", "/healthz", nonblocking=True)
    def healthz(a: ServingApp, req: Request):
        """Health probe reporting uptime, event-loop fan-out, and the
        generation id of the model being served (from the update topic's
        publish stamps). GET doubles as the DEGRADED-readiness surface:
        503 + reasons when the served model is past its staleness bound
        (oryx.serving.api.max-staleness-sec) — a condition a log line
        can't route to a load balancer.
        HEAD stays pure liveness (200 whenever the frontend dispatches),
        so probes choose their semantics by method."""
        from oryx_tpu_torch.common.freshness import model_freshness

        degraded = a.degraded_reasons()
        body = {
            "status": "degraded" if degraded else "up",
            "degraded": degraded,
            "uptime_seconds": round(time.monotonic() - a.started_at, 3),
            "loops": a.loop_count,
            "model_generation": model_freshness().generation,
        }
        # fleet surface: name this process (the front's ejection log and
        # oryx_fleet_replica_* labels come straight from here) and carry
        # the per-replica freshness/perf numbers the front aggregates
        if a.replica_id:
            body["replica"] = a.replica_id
        if a.listen_port:
            body["port"] = a.listen_port
        shard_count = a.config.get_int("oryx.serving.api.sync.shard-count", 1)
        if shard_count > 1:
            # shard topology surface: the fleet front compares this with
            # its expected shards per replica and treats a mis-sharded
            # replica as degraded
            body["shards"] = shard_count
        age = a.staleness_age()
        if age is not None:
            body["staleness_seconds"] = round(age, 3)
        if a.update_lag_fn is not None:
            try:
                body["update_lag"] = int(a.update_lag_fn())
            except Exception:  # noqa: BLE001 - a probe never 500s on lag
                pass
        try:
            import math

            from oryx_tpu_torch.common.perfstats import get_perfstats

            mfu = get_perfstats().mfu("serving")
            if not math.isnan(mfu):
                body["mfu"] = round(mfu, 6)
            # rolling-window dispatch occupancy (1.0 here by construction:
            # views hold live rows and no query row is padded)
            occ, n_disp = get_perfstats().window_occupancy("serving")
            if occ is not None:
                body["occupancy"] = {
                    "mean": round(occ, 4), "dispatches": n_disp,
                }
        except Exception:  # noqa: BLE001 - perf accounting is optional
            pass
        try:
            from oryx_tpu_torch.common.qualitystats import get_qualitystats

            # live quality scorecard: windowed shadow-rescore recall,
            # sample/drop accounting, the served generation's stamped
            # eval metrics, and drift vs its training profile
            body["quality"] = get_qualitystats().healthz_section()
        except Exception:  # noqa: BLE001 - a probe never 500s on quality
            pass
        try:
            from oryx_tpu_torch.common import slo

            # SLO source reads that raised in THIS process (slo -> last
            # error), so broken burn math is visible
            errs = slo.sample_errors()
            if errs:
                body["slo_errors"] = errs
            # per-SLO fast/slow burn rates
            burn = slo.burn_snapshot()
            if burn:
                body["slo_burn"] = burn
        except Exception:  # noqa: BLE001 - a probe never 500s on slo state
            pass
        try:
            from oryx_tpu_torch.common.modelgate import get_model_gate

            # staged-adoption state (mode, watermark, held generation,
            # adoption history): whether a canary adopted the new
            # generation and a hold replica still pins the incumbent
            gate = get_model_gate()
            if gate.active:
                body["model_gate"] = gate.healthz_section()
        except Exception:  # noqa: BLE001 - a probe never 500s on gate state
            pass
        try:
            from oryx_tpu_torch.common.perfattr import get_perfattr

            # live latency budget: per-phase p50/p99/share over the
            # rolling window plus ranked idle-gap causes
            body["latency_budget"] = get_perfattr().healthz_section()
        except Exception:  # noqa: BLE001 - a probe never 500s on perfattr
            pass
        # up->degraded edge: the first degraded probe snapshots the
        # flight recorder's black box off-thread (app.py note_health_state)
        a.note_health_state(bool(degraded), degraded)
        return (503 if degraded else 200), body

    @app.route("HEAD", "/healthz", nonblocking=True)
    def healthz_head(a: ServingApp, req: Request):
        return 200, None

    # model-gate control plane: an operator (or a fleet controller) drives
    # these. Deliberately exempt from the app's read-only mode: they
    # mutate which already-published model serves, never application
    # data. NOT nonblocking: an adoption loads the model and builds its
    # device view in the handler (about a second at 1M x 50), so the
    # async frontend runs them on its worker pool, off the event loop.
    @app.route("POST", "/control/model/approve")
    def model_approve(a: ServingApp, req: Request):
        """Raise the gate's approved watermark to the given generation; a
        held generation at/under it is adopted before the response
        returns. 409 while the gate is off."""
        from oryx_tpu_torch.common.modelgate import ModelGateError, get_model_gate

        try:
            doc = json.loads(req.body_text() or "{}")
            generation = int(doc["generation"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            raise OryxServingException(
                400, 'body must be JSON {"generation": <int>}'
            )
        try:
            return 200, get_model_gate().approve(generation)
        except ModelGateError as e:
            raise OryxServingException(409, str(e))

    @app.route("POST", "/control/model/rollback")
    def model_rollback(a: ServingApp, req: Request):
        """Re-apply the previously adopted generation (pointer swap from
        the pinned relay cache) and veto the current one. 409 while the
        gate is off or holds no previous generation."""
        from oryx_tpu_torch.common.modelgate import ModelGateError, get_model_gate

        try:
            doc = json.loads(req.body_text() or "{}")
        except json.JSONDecodeError:
            doc = {}
        reason = doc.get("reason") if isinstance(doc, dict) else None
        try:
            return 200, get_model_gate().rollback(
                reason=str(reason) if reason else None
            )
        except ModelGateError as e:
            raise OryxServingException(409, str(e))

    @app.route("POST", "/ingest")
    def ingest(a: ServingApp, req: Request):
        n = send_input_lines(a, _ingest_text(req), "ingest body")
        return 200, {"ingested": n}

    # NOT nonblocking: serializing a full ring (thousands of spans) on an
    # event loop would stall that loop's other connections
    @app.route("GET", "/debug/traces")
    def debug_traces(a: ServingApp, req: Request):
        """Recent finished spans from the process ring buffer as a span
        forest (default) or Chrome trace-event JSON (?format=chrome —
        opens directly in Perfetto).
        ?limit=N keeps only the newest N spans. Empty until
        oryx.monitoring.tracing.enabled = true."""
        tr = get_tracer()
        spans = tr.snapshot()
        try:
            limit = int(req.q1("limit", "0") or 0)
        except ValueError:
            raise OryxServingException(400, "bad limit")
        if limit > 0:
            spans = spans[-limit:]
        if req.q1("format") == "chrome":
            body = json.dumps(chrome_trace(spans), default=str)
        else:
            body = json.dumps(
                {
                    "enabled": tr.enabled,
                    "capacity": tr.capacity,
                    "spans": len(spans),
                    "traces": span_forest(spans),
                },
                default=str,
            )
        return RawResponse(200, body.encode("utf-8"), "application/json")

    # NOT nonblocking: bundling renders the whole metrics page and writes
    # the artifact to disk — worker-thread work, never an event loop's
    @app.route("GET", "/debug/flight")
    def debug_flight(a: ServingApp, req: Request):
        """On-demand flight-recorder snapshot (common/flightrec.py): the
        recent lifecycle-event ring, finished tracing spans, the
        perfstats dispatch ring, a /metrics snapshot, and the config
        fingerprint as ONE downloadable artifact — the same bundle a
        healthz up→degraded transition writes automatically. 403 when the
        recorder is disabled (oryx.monitoring.flight.enabled = false)."""
        from oryx_tpu_torch.common.flightrec import get_flightrec

        rec = get_flightrec()
        if not rec.enabled:
            raise OryxServingException(
                403, "flight recorder disabled (oryx.monitoring.flight.enabled)"
            )
        bundle, path = rec.snapshot("debug-endpoint")
        if path:
            req.response_headers.append((
                "Content-Disposition",
                f'attachment; filename="{path.rsplit("/", 1)[-1]}"',
            ))
        return RawResponse(
            200, json.dumps(bundle, default=str).encode("utf-8"),
            "application/json",
        )

    # NOT nonblocking: the handler sleeps for the capture window — that
    # must park a worker thread, never an event loop
    @app.route("GET", "/debug/profile")
    def debug_profile(a: ServingApp, req: Request):
        """On-demand performance capture: blocks for ?seconds=N (clamped
        to oryx.monitoring.profile.max-seconds) recording every device
        dispatch's cost (common/perfstats.py) — plus finished tracing
        spans, and a torch.profiler trace of the host and the card into
        oryx.monitoring.profile.dir when configured — and returns the
        window as a downloadable Perfetto-loadable Chrome trace-event
        artifact with an `oryx` summary block (per-kind FLOPs, bytes,
        occupancy, window MFU, the torch trace's path). 403 until
        oryx.monitoring.profile.enabled = true; 409 while another capture
        holds the (process-global) profiler."""
        from oryx_tpu_torch.common.perfstats import get_perfstats

        ps = get_perfstats()
        if not ps.profile_enabled:
            raise OryxServingException(
                403, "profiling disabled (set oryx.monitoring.profile.enabled)"
            )
        try:
            seconds = float(req.q1("seconds", "1") or 1.0)
        except ValueError:
            raise OryxServingException(400, "bad seconds")
        seconds = max(0.0, min(seconds, ps.profile_max_seconds))
        try:
            artifact = ps.capture_profile(seconds)
        except RuntimeError as e:
            raise OryxServingException(409, str(e))
        req.response_headers.append((
            "Content-Disposition",
            f'attachment; filename="oryx-profile-{int(time.time())}.json"',
        ))
        return RawResponse(
            200, json.dumps(artifact).encode("utf-8"), "application/json"
        )

    if app.config.get_bool("oryx.monitoring.metrics", True):

        from oryx_tpu_torch.serving.batcher import TopKBatcher

        # live callback gauges: scrapes read the batcher's counters (and
        # the card-down state after a wedge) without per-scrape mutation
        TopKBatcher.shared().register_gauges()

        @app.route("GET", "/metrics")
        def metrics(a: ServingApp, req: Request):
            """Prometheus text exposition; a scraper that negotiates
            `Accept: application/openmetrics-text` gets the OpenMetrics
            dialect instead, which is the ONLY format exemplars
            (metric→trace joins, docs/observability.md) may legally ride
            — emitting them into classic text would fail legacy
            parsers on the whole scrape."""
            wants_om = "application/openmetrics-text" in req.headers.get(
                "accept", ""
            )
            text = get_registry().render_prometheus(openmetrics=wants_om)
            ctype = (
                "application/openmetrics-text; version=1.0.0; charset=utf-8"
                if wants_om else "text/plain; version=0.0.4"
            )
            return RawResponse(200, text.encode("utf-8"), ctype)

    @app.route("GET", "/console")
    def console(a: ServingApp, req: Request):
        """Human status page (the reference serves an HTML console per app,
        e.g. .../als/Console.java): model state, app-specific sections
        registered via app.console_sections, and the route table."""
        import html as _html

        model = a.model_manager.get_model()
        frac = model.fraction_loaded() if model is not None else 0.0
        manager = _html.escape(type(a.model_manager).__name__)
        ctx = a.context_path  # links must stay inside the mount

        def table(pairs) -> str:
            return "<table>" + "".join(
                f"<tr><td>{_html.escape(str(k))}</td>"
                f"<td>{_html.escape(str(v))}</td></tr>"
                for k, v in pairs
            ) + "</table>"

        sections = []
        for title, fn in a.console_sections:
            try:
                pairs = fn(a)
            except OryxServingException:
                pairs = [("status", "model not yet available")]
            except Exception as e:  # noqa: BLE001 - console must render
                pairs = [("error", f"{type(e).__name__}: {e}")]
            sections.append(f"<h2>{_html.escape(title)}</h2>{table(pairs)}")

        rows = "".join(
            f"<tr><td>{_html.escape(r.method)}</td>"
            f"<td><code>{_html.escape(r.pattern.pattern)}</code></td></tr>"
            for r in sorted(a.routes, key=lambda r: (r.pattern.pattern, r.method))
        )
        html = (
            "<!doctype html><html><head><title>Oryx Serving</title>"
            "<style>body{font-family:sans-serif;margin:2em}table{border-collapse:"
            "collapse}td,th{border:1px solid #ccc;padding:4px 8px}</style></head>"
            f"<body><h1>Oryx serving console</h1>"
            f"<p>Model manager: <b>{manager}</b></p>"
            f"<p>Model loaded: <b>{frac:.0%}</b>"
            f"{' (serving)' if frac >= a.min_fraction else ' (warming up)'}</p>"
            f"<p><a href='{ctx}/metrics'>metrics</a> &middot; "
            f"<a href='{ctx}/ready'>ready</a></p>"
            f"{''.join(sections)}"
            f"<h2>Endpoints</h2><table><tr><th>method</th><th>path</th></tr>"
            f"{rows}</table></body></html>"
        )
        return RawResponse(200, html.encode("utf-8"), "text/html; charset=utf-8")
