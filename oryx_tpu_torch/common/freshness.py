"""Model freshness: publish -> swapped-in-for-serving lag over the bus (the
port's copy of oryx_tpu/common/freshness.py).

The second question a lambda architecture must answer (the first —
per-request latency attribution — is common/tracing.py): *how stale is the
model being served?* The reference offers nothing here; the only signal is
a log line when a model loads. The batch layer stamps every model publish
with a framework-level ``TRACE`` message on the update topic (published
immediately AFTER its MODEL/MODEL-REF so app-visible record order is
unchanged; ``publish_stamp`` writes it), and every
consumer of the update topic (``_dispatch_update`` in api.py) intercepts
the stamp — app model managers never see it.

From the stamp the consuming process exports:

- ``oryx_update_to_serve_seconds`` (histogram): publish-time to
  swapped-in-time lag. On restart the listener replays the topic from
  earliest, so replayed loads observe large values — intentionally: a
  restarted server IS serving a stale model until it catches up.
- ``oryx_model_staleness_seconds`` (gauge): live age of the currently
  served model's publish stamp — the "how stale right now" pager metric.
- ``oryx_model_generation`` (gauge): generation id (the batch layer's
  publish timestamp in ms) of the model currently loaded; also surfaced
  by ``/healthz``.

The stamp carries the batch generation's ``traceparent`` when tracing is
enabled, so the serving tier's ``model.load`` span joins the generation's
trace — one tree from training to swap-in.
"""

from __future__ import annotations

import json
import logging
import threading
import time

from oryx_tpu_torch.common import tracing
from oryx_tpu_torch.common.metrics import get_registry

log = logging.getLogger(__name__)

# Update-topic key of publish stamps (framework-level, like MODEL-CHUNK).
STAMP_KEY = "TRACE"

# Publish->serve lag spans milliseconds (same-host file bus) to hours
# (replay through a 6h-generation history after restart).
FRESHNESS_BUCKETS = (
    0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0, 60.0, 300.0, 900.0,
    3600.0, 21600.0, 86400.0,
)


def publish_stamp(
    generation: int | None = None, quality: dict | None = None
) -> str:
    """Serialize a publish-time stamp. Carries the publisher's current
    span context (the batch generation's span) when tracing is on, and
    the generation's eval scorecard (``quality``: metric name -> value,
    e.g. ``{"auc": 0.87}``) so every consuming tier can report what the
    batch harness measured for the model it is serving."""
    stamp: dict = {"published_ms": int(time.time() * 1000)}
    if generation is not None:
        stamp["generation"] = generation
    if quality:
        stamp["quality"] = {
            str(k): float(v)
            for k, v in quality.items()
            if isinstance(v, (int, float)) and v == v
        }
    ctx = tracing.current_span()
    if ctx is not None:
        stamp["traceparent"] = tracing.format_traceparent(
            ctx.trace_id, ctx.span_id
        )
    return json.dumps(stamp)


class ModelFreshness:
    """Per-process freshness tracker fed by _dispatch_update.

    Message order on the (single-partition) update topic is MODEL then its
    TRACE stamp, so ``note_loaded`` fires first (handler succeeded) and the
    stamp that follows claims it — ``note_stamp`` observes the lag only
    when an unclaimed successful load precedes it, so a stamp whose MODEL
    failed to load records nothing.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._load_pending = False   # a MODEL/MODEL-REF loaded, stamp not yet seen
        self._load_mono = 0.0        # when that load completed (monotonic)
        # parked-load handshake: a MODEL-REF whose artifact lags its chunks
        # is parked for re-dispatch (api.py), so its stamp arrives BEFORE
        # the load completes — the stamp is held here, KEYED to the parked
        # message, and claimed only by that model's late load (a different
        # model loading in between must not claim it)
        self._parked = False
        self._parked_msg: str | None = None
        self._held_stamp: dict | None = None
        self._held_for: str | None = None
        self.generation: int | None = None
        self.published_ms: float | None = None
        self.loaded_ms: float | None = None
        # the served generation's eval scorecard from its publish stamp
        # (metric name -> value), None until a quality-stamped model loads
        self.quality: dict | None = None
        reg = get_registry()
        self._g_quality = reg.gauge(
            "oryx_generation_quality",
            "Eval metrics the batch harness measured for the model "
            "generation currently being served (from the publish stamp's "
            "quality scorecard), by metric name (e.g. auc, "
            "hit_rate_at_10)",
            labeled=True,
        )
        self._h_lag = reg.histogram(
            "oryx_update_to_serve_seconds",
            "Lag from model publish on the update topic to swapped in for "
            "serving here (replayed loads after restart observe their full "
            "age)",
            buckets=FRESHNESS_BUCKETS,
        )
        reg.gauge(
            "oryx_model_staleness_seconds",
            "Age of the currently served model's publish stamp (0 until a "
            "stamped model has loaded)",
        ).set_function(self._staleness)
        reg.gauge(
            "oryx_model_generation",
            "Generation id (batch publish timestamp ms) of the model "
            "currently loaded (0 until known)",
        ).set_function(self._generation_value)

    # -- hooks (called by oryx_tpu_torch.api._dispatch_update) ------------

    def note_loaded(self, key: str | None, message: str | None = None) -> None:
        """A MODEL/MODEL-REF handler completed successfully. Normally its
        stamp follows and claims this load; a PARKED model loads after its
        stamp already arrived, so THAT model's held stamp (matched by
        message) is claimed here instead — a different model loading in
        the meantime takes the normal pending path and leaves the held
        stamp for the parked model's re-dispatch."""
        with self._lock:
            held = self._held_stamp
            if held is not None and (
                self._held_for is None
                or message is None
                or message == self._held_for
            ):
                self._held_stamp = None
                self._held_for = None
                self._parked = False
                load_mono = time.monotonic()
            else:
                self._load_pending = True
                self._load_mono = time.monotonic()
                return
        self._observe(held, load_mono)

    def note_load_failed(
        self, parked: bool = False, message: str | None = None
    ) -> None:
        """A MODEL/MODEL-REF dispatch did not complete. Given up: clear any
        unclaimed load so the failed model's stamp cannot claim an older
        one. Parked (artifact lagging its chunks): remember which message
        parked, so the stamp about to arrive is HELD for that model's late
        re-dispatched load instead of dropped — otherwise every
        chunk-lagged publish would be invisible to the freshness
        metrics."""
        with self._lock:
            self._load_pending = False
            self._parked = parked
            self._parked_msg = message if parked else None
            if not parked:
                self._held_stamp = None
                self._held_for = None

    def note_stamp(self, message: str) -> None:
        """A TRACE publish stamp arrived (always right after its model on
        the single-partition update topic)."""
        stamp = json.loads(message)
        published_ms = stamp.get("published_ms")
        if not isinstance(published_ms, (int, float)):
            raise ValueError(f"bad publish stamp: {message!r}")
        with self._lock:
            claimed = self._load_pending
            self._load_pending = False
            load_mono = self._load_mono
            if not claimed and self._parked:
                # the stamped model is parked awaiting its artifact: hold
                # the stamp for that model's late load (a newer stamp
                # supersedes an unclaimed one)
                self._held_stamp = stamp
                self._held_for = self._parked_msg
                return
        if not claimed:
            # the stamped model never loaded here (handler gave up):
            # recording a "served" lag for it would be a lie
            log.debug("publish stamp with no preceding model load; ignoring")
            return
        self._observe(stamp, load_mono)

    def _observe(self, stamp: dict, load_mono: float) -> None:
        """Record one publish->serve observation and advance the
        currently-served generation state."""
        now_ms = time.time() * 1000.0
        published_ms = float(stamp["published_ms"])
        lag_s = max(0.0, (now_ms - published_ms) / 1000.0)
        self._h_lag.observe(lag_s)
        gen = stamp.get("generation")
        quality = stamp.get("quality")
        quality = {
            str(k): float(v)
            for k, v in quality.items()
            if isinstance(v, (int, float))
        } if isinstance(quality, dict) else None
        with self._lock:
            self.generation = int(gen) if isinstance(gen, (int, float)) else None
            self.published_ms = published_ms
            self.loaded_ms = now_ms
            self.quality = quality
        # the scorecard gauge describes exactly the generation being
        # served: drop the previous generation's series first, so a
        # card-less generation doesn't silently keep exporting its
        # predecessor's numbers
        self._g_quality.clear_values()
        if quality:
            for metric, value in quality.items():
                self._g_quality.set(value, metric=metric)
        # generation boundary for the live-quality sample windows: the
        # shadow recall/score windows describe the OLD generation's
        # answers and must not be attributed to this one
        from oryx_tpu_torch.common.qualitystats import get_qualitystats

        get_qualitystats().note_generation(self.generation)
        tr = tracing.get_tracer()
        if tr.enabled:
            parent = tracing.parse_traceparent(stamp.get("traceparent"))
            span = tr.start(
                "model.load", parent=parent, start=load_mono,
                generation=gen or 0, lag_s=round(lag_s, 3),
            )
            tr.finish(span)
        from oryx_tpu_torch.common.flightrec import get_flightrec

        # generation adoptions are the heartbeat of a replica's flight
        # ring: a corpse harvested mid update-storm shows exactly which
        # generation it last swapped in, and when
        get_flightrec().record(
            kind="generation", generation=gen, lag_s=round(lag_s, 3),
        )

    # -- gauge callbacks ---------------------------------------------------

    def _staleness(self) -> float:
        p = self.published_ms
        if p is None:
            return 0.0
        return max(0.0, time.time() * 1000.0 - p) / 1000.0

    def _generation_value(self) -> float:
        g = self.generation
        return float(g) if isinstance(g, (int, float)) else 0.0


_instance: ModelFreshness | None = None
_instance_lock = threading.Lock()


def model_freshness() -> ModelFreshness:
    global _instance
    with _instance_lock:
        if _instance is None:
            _instance = ModelFreshness()
        return _instance
