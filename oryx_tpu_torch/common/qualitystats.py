"""Live model-quality observability: shadow rescore sampling, drift
detection, and the per-process half of the per-generation scorecards (the
port's copy of oryx_tpu/common/qualitystats.py).

Bench stages and the nightly recall gate (ml/quality.py) measure
synthetic corpora; this module measures the model being served, on the
traffic it serves (the JAX package's bench found its assumed-0.95 LSH
recall measured 0.49 only by sampling its own responses):

- **Shadow rescore sampling**: a config-gated fraction
  (``oryx.monitoring.quality.sample-rate``) of served top-k responses is
  re-scored EXACTLY off the hot path — the request thread only flips a
  coin and enqueues a reference into a bounded queue; a dedicated drain
  thread replays each sample through this module's own exact f32 host
  scorer (``_exact_topk``: the JAX package's ``serving/batcher.host_topk``
  and ``select_topk``) and compares. That scorer is a reference
  measurement, the JAX package's design: it never answers a request (the
  port has no host serving path; a wedged card answers 503) and nothing
  under ``serving/`` calls it. Overflow drops the sample, never the
  request (``oryx_quality_sample_drops_total``). Results export as the
  windowed ``oryx_live_recall_at_k{score_mode}`` gauge plus the
  ``oryx_live_score_margin`` histogram (relative score given up by the
  approximation, trace exemplars attached) — quantized/approx/LSH recall
  becomes a runtime fact instead of a bench claim.

- **Input & prediction drift**: batch generations persist a compact
  ``TrainingProfile`` (item-popularity sketch, event rate, new-item
  fraction, score distribution) inside the model artifact; the serving
  and speed tiers compare live windowed sketches against the served
  generation's profile into ``oryx_input_drift{signal}`` /
  ``oryx_prediction_drift{signal}`` gauges. The speed tier sees the raw
  event stream (input drift); serving sees its own served scores through
  the sampler (prediction drift).

- **Quality SLO + alarms**: each shadow sample is good/bad against
  ``oryx.monitoring.slo.quality.recall-floor``; the cumulative counters
  feed the ``quality`` SLO burn rate (``common/slo.py``). When the fast
  burn crosses ``oryx.monitoring.quality.alarm-burn-rate`` while the
  live window sits below the floor, a ``quality-alarm`` flight event is
  recorded with the serving generation id — the exact signal a canary
  gate consumes. Drift past ``oryx.monitoring.quality.drift.alarm-
  threshold`` records a ``drift-alarm`` event the same way.

The sampler's cost model: one exact rescore is an O(N·F) host matmul —
at 1M×50f that is ~200 MB of reads per sample, so the budget lives in
``sample-rate`` (default 1%) and the bounded queue, never in request
latency; a saturated shadow queue drops samples instead of slowing
requests.
"""

from __future__ import annotations

import hashlib
import json
import logging
import math
import queue
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field

import numpy as np

from oryx_tpu_torch.common.metrics import get_registry, linear_buckets

log = logging.getLogger(__name__)

# Item-popularity sketch width: 64 hash buckets is enough to see a
# category-level shift (total-variation distance) at ~8 bytes/bucket in
# the artifact, and small enough that the per-event hashing cost is the
# blake2b call, not cache misses.
SKETCH_BUCKETS = 64

# Live windows are deques of (monotonic-time, payload); bounded so a
# misconfigured window-sec cannot grow them without limit.
_MAX_WINDOW_SAMPLES = 4096

# The recall the live gauge reports at: recall@min(10, served page).
LIVE_RECALL_K = 10

# Relative score margin histogram: 0 (approximation gave up nothing)
# through 0.24+ in 0.01 steps — linear because the interesting end is 0.
MARGIN_BUCKETS = linear_buckets(0.0, 0.01, 25)


def sketch_bucket(item_id: str) -> int:
    """Stable hash bucket of an item id (blake2b, process-independent —
    the profile is computed in the batch process and compared in
    serving/speed processes, so the builtin salted hash() would never
    match)."""
    h = hashlib.blake2b(item_id.encode("utf-8"), digest_size=4).digest()
    return int.from_bytes(h, "big") % SKETCH_BUCKETS


def sketch_of(item_ids, weights=None) -> np.ndarray:
    """Normalized popularity sketch (sums to 1.0; zeros when empty)."""
    counts = np.zeros(SKETCH_BUCKETS, dtype=np.float64)
    for j, ident in enumerate(item_ids):
        w = 1.0 if weights is None else float(weights[j])
        counts[sketch_bucket(str(ident))] += abs(w)
    total = counts.sum()
    return counts / total if total > 0 else counts


@dataclass
class TrainingProfile:
    """Compact what-the-model-was-trained-on summary, persisted as the
    ``qualityProfile`` model-artifact extension. All fields are
    denominator-safe: a missing signal is None, never a guessed 0."""

    item_sketch: list[float] = field(default_factory=list)
    events_per_sec: float | None = None
    new_item_fraction: float | None = None
    score_mean: float | None = None
    score_std: float | None = None
    n_events: int = 0

    def to_json(self) -> str:
        return json.dumps({
            "item_sketch": [round(float(v), 6) for v in self.item_sketch],
            "events_per_sec": self.events_per_sec,
            "new_item_fraction": self.new_item_fraction,
            "score_mean": self.score_mean,
            "score_std": self.score_std,
            "n_events": int(self.n_events),
        })

    @staticmethod
    def from_json(text: str) -> "TrainingProfile":
        doc = json.loads(text)
        if not isinstance(doc, dict):
            raise ValueError("qualityProfile is not a JSON object")

        def num(k):
            v = doc.get(k)
            return float(v) if isinstance(v, (int, float)) else None

        sketch = doc.get("item_sketch") or []
        return TrainingProfile(
            item_sketch=[float(v) for v in sketch],
            events_per_sec=num("events_per_sec"),
            new_item_fraction=num("new_item_fraction"),
            score_mean=num("score_mean"),
            score_std=num("score_std"),
            n_events=int(doc.get("n_events") or 0),
        )


def build_training_profile(
    item_ids,
    item_counts=None,
    *,
    timestamps_ms=None,
    prev_item_ids=None,
    scores=None,
) -> TrainingProfile:
    """Build the profile a batch generation stamps into its artifact.

    ``item_ids`` + optional per-id ``item_counts`` describe the window's
    item-interaction distribution (aggregated pairs are fine — the
    sketch is a popularity shape, not an exact count). ``timestamps_ms``
    (raw window event timestamps) give the event rate;
    ``prev_item_ids`` (previous generation's catalog) gives the new-item
    fraction; ``scores`` is a sample of the trained model's predicted
    scores for the prediction-drift baseline."""
    sketch = sketch_of(item_ids, item_counts)
    rate = None
    n_events = len(item_ids)
    if timestamps_ms is not None and len(timestamps_ms) > 1:
        ts = np.asarray(timestamps_ms, dtype=np.int64)
        ts = ts[ts > 0]
        if ts.size > 1:
            span_s = float(ts.max() - ts.min()) / 1000.0
            n_events = int(ts.size)
            if span_s > 0:
                rate = n_events / span_s
    new_frac = None
    if prev_item_ids is not None:
        prev = set(prev_item_ids)
        if prev:
            ids = list(item_ids)
            if ids:
                new_frac = sum(1 for i in ids if str(i) not in prev) / len(ids)
        else:
            new_frac = 0.0
    s_mean = s_std = None
    if scores is not None and len(scores) > 0:
        s = np.asarray(scores, dtype=np.float64)
        s = s[np.isfinite(s)]
        if s.size:
            s_mean = float(s.mean())
            s_std = float(s.std())
    return TrainingProfile(
        item_sketch=[float(v) for v in sketch],
        events_per_sec=rate,
        new_item_fraction=new_frac,
        score_mean=s_mean,
        score_std=s_std,
        n_events=n_events,
    )


def _exact_topk(vec, k: int, mat: np.ndarray, cosine: bool = False):
    """Exact f32 top-k of one query over ``mat`` on the host, ranked
    descending: the product, the cosine scaling with its zero-norm clamp,
    argpartition, then a sort of the k survivors (the JAX package's
    ``host_topk`` and ``select_topk``, so both packages' shadow references
    rank alike)."""
    scores = mat @ np.asarray(vec, dtype=np.float32)
    if cosine:
        scores = scores / np.maximum(np.linalg.norm(mat, axis=1), 1e-12)
    k = min(k, scores.shape[0])
    top = np.argpartition(-scores, k - 1)[:k]
    top = top[np.argsort(-scores[top])]
    return scores[top], top


@dataclass
class _Sample:
    """One shadow-rescore work item: everything the drain thread needs
    to replay the request exactly, by reference (the snapshot_fn hands
    back the row-aligned host matrix + ids the request was served from,
    or takes a fresh store snapshot for the LSH host path)."""

    vec: np.ndarray
    served_ids: list
    served_scores: list
    how_many: int
    exclude: frozenset
    cosine: bool
    score_mode: str
    trace_id: str | None
    snapshot_fn: object  # () -> (host f32 matrix, ids, valid_rows)


_INPUT_SIGNALS = ("item-popularity", "event-rate", "new-item-fraction")
_PREDICTION_SIGNALS = ("score-mean", "score-spread")


class QualityStats:
    """Process-global live-quality tracker (``get_qualitystats()``); a
    fresh instance is also constructable for tests and the nightly
    harness."""

    def __init__(self):
        self.enabled = True
        self.sample_rate = 0.0
        self.window_s = 300.0
        self.max_queue = 256
        self.recall_floor = 0.9
        self.alarm_burn_rate = 14.0
        self.drift_alarm = 0.5
        self._lock = threading.Lock()
        # unbounded Queue with the bound enforced at enqueue (qsize
        # probe): reconfiguring max-queue then never orphans in-flight
        # samples in a replaced queue object
        self._queue: queue.Queue[_Sample] = queue.Queue()
        self._stop = threading.Event()
        # writes serialized under _lock; the pre-lock aliveness probe in
        # _ensure_thread is a deliberate lock-free fast path
        self._thread: threading.Thread | None = None  # guarded-by: _lock (writes)
        self._enqueued = 0  # guarded-by: _lock (accepted-sample count)
        self._processed = 0  # guarded-by: _lock (drained-sample count)
        # (t, recall, margin) per score_mode label
        self._recall_window: dict[str, deque] = {}  # guarded-by: _lock
        # live prediction-score window: (t, mean-served-score)
        self._score_window: deque = deque(maxlen=_MAX_WINDOW_SAMPLES)  # guarded-by: _lock
        # live input window: (t, bucket-count sketch, n_events, n_new)
        self._input_window: deque = deque(maxlen=_MAX_WINDOW_SAMPLES)  # guarded-by: _lock
        self._known_items: set[str] = set()  # guarded-by: _lock (new-item tracking)
        self.profile: TrainingProfile | None = None
        # test/chaos hook: while set, the drain thread parks — the only
        # way to deterministically exercise the overflow-drop contract
        # (the real drain races ahead of any realistic request burst)
        self.drain_gate = threading.Event()
        self._metrics = None

    # -- configuration -----------------------------------------------------

    def configure(self, config) -> None:
        """Adopt the oryx.monitoring.quality.* keys and pre-register the
        metric families (zero baselines from process start, like the
        robustness metrics)."""
        self.enabled = config.get_bool("oryx.monitoring.quality.enabled", True)
        self.sample_rate = max(
            0.0, config.get_float("oryx.monitoring.quality.sample-rate", 0.01)
        )
        self.window_s = max(
            1.0, config.get_float("oryx.monitoring.quality.window-sec", 300.0)
        )
        self.max_queue = max(
            1, config.get_int("oryx.monitoring.quality.max-queue", 256)
        )
        self.recall_floor = config.get_float(
            "oryx.monitoring.slo.quality.recall-floor", 0.9
        )
        self.alarm_burn_rate = config.get_float(
            "oryx.monitoring.quality.alarm-burn-rate", 14.0
        )
        self.drift_alarm = config.get_float(
            "oryx.monitoring.quality.drift.alarm-threshold", 0.5
        )
        self.ensure_metrics()
        # the quality SLO burns over this sampler's good/bad counters
        from oryx_tpu_torch.common import slo

        if self.enabled and self.sample_rate > 0:
            slo.ensure_quality_slo(config)

    def ensure_metrics(self) -> None:
        """Register the live-quality families (idempotent)."""
        if self._metrics is not None:
            return
        reg = get_registry()
        g_recall = reg.gauge(
            "oryx_live_recall_at_k",
            "Windowed mean recall@k of shadow-rescored served responses "
            "against the exact host rescore, by serving score mode "
            "(NaN until a sample lands in the window) — the runtime "
            "counterpart of bench's measured-recall fields",
            labeled=True,
        )
        h_margin = reg.histogram(
            "oryx_live_score_margin",
            "Relative score the serving approximation gave up per shadow "
            "sample: (exact top-score - served top-score) / |exact "
            "top-score| (0 = the approximation found the true winner); "
            "buckets carry trace exemplars while tracing is on",
            buckets=MARGIN_BUCKETS,
        )
        c_samples = reg.counter(
            "oryx_quality_samples_total",
            "Served responses shadow-rescored by the live quality "
            "sampler, by serving score mode",
            labeled=True,
        )
        c_bad = reg.counter(
            "oryx_quality_bad_samples_total",
            "Shadow samples whose measured recall fell below "
            "oryx.monitoring.slo.quality.recall-floor — the bad half of "
            "the quality SLO's burn-rate fraction",
            labeled=True,
        )
        c_drops = reg.counter(
            "oryx_quality_sample_drops_total",
            "Shadow samples dropped because the bounded rescore queue "
            "was full — the request was served normally; only the "
            "quality measurement was skipped",
        )
        g_in = reg.gauge(
            "oryx_input_drift",
            "Live input stream vs the served generation's training "
            "profile, by signal: item-popularity (total-variation "
            "distance of hash sketches, 0..1), event-rate (relative "
            "change), new-item-fraction (absolute fraction of events on "
            "items the generation never trained on). NaN until both a "
            "profile and a live window exist",
            labeled=True,
        )
        g_pred = reg.gauge(
            "oryx_prediction_drift",
            "Live served-score distribution vs the served generation's "
            "training profile, by signal: score-mean (relative shift), "
            "score-spread (relative std change). NaN until both a "
            "profile and sampled predictions exist",
            labeled=True,
        )
        for signal in _INPUT_SIGNALS:
            g_in.set_function(
                self._drift_reader(self.input_drift, signal), signal=signal
            )
        for signal in _PREDICTION_SIGNALS:
            g_pred.set_function(
                self._drift_reader(self.prediction_drift, signal),
                signal=signal,
            )
        self._metrics = (g_recall, h_margin, c_samples, c_bad, c_drops)

    @staticmethod
    def _drift_reader(fn, signal: str):
        return lambda: fn(signal)

    # -- shadow sampling (request side) ------------------------------------

    def maybe_sample(
        self,
        vec,
        served_pairs,
        *,
        how_many: int,
        exclude=frozenset(),
        cosine: bool = False,
        score_mode: str = "exact",
        trace_id: str | None = None,
        snapshot_fn=None,
    ) -> bool:
        """Request-side hook, called AFTER the response is final (post
        pool / host-path caller thread, never the batcher dispatcher).
        The hot-path cost is one RNG draw and a put_nowait; everything
        else happens on the drain thread. Returns True when enqueued."""
        if not self.enabled or self.sample_rate <= 0 or snapshot_fn is None:
            return False
        if not served_pairs:
            return False
        if self.sample_rate < 1.0 and random.random() >= self.sample_rate:
            return False
        sample = _Sample(
            vec=np.array(vec, dtype=np.float32, copy=True),
            served_ids=[p[0] for p in served_pairs],
            served_scores=[float(p[1]) for p in served_pairs],
            how_many=int(how_many),
            exclude=frozenset(exclude),
            cosine=bool(cosine),
            score_mode=str(score_mode),
            trace_id=trace_id,
            snapshot_fn=snapshot_fn,
        )
        if self._queue.qsize() >= self.max_queue:
            # overflow drops the SAMPLE, never the request: the queue
            # bound is the proof sampling stays off the dispatch path
            self.ensure_metrics()
            self._metrics[4].inc()
            return False
        self._queue.put_nowait(sample)
        with self._lock:
            self._enqueued += 1
        self._ensure_thread()
        return True

    def _ensure_thread(self) -> None:
        t = self._thread
        if t is not None and t.is_alive():
            return
        with self._lock:
            t = self._thread
            if t is None or not t.is_alive():
                t = threading.Thread(
                    target=self._drain_loop,
                    name="oryx-quality-sampler",
                    daemon=True,
                )
                self._thread = t
                t.start()

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until every accepted sample has been fully processed
        (tests, chaos, bench — never the request path). Dropped samples
        never count as accepted, so a paused drain + overflow still
        flushes once unblocked."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                done = self._processed >= self._enqueued
            if done and not self.drain_gate.is_set():
                return True
            time.sleep(0.01)
        return False

    # -- shadow sampling (drain side) --------------------------------------

    def close(self) -> None:
        """Stop the drain thread (private instances in tests/harnesses;
        the process singleton just lives as long as the process)."""
        self._stop.set()

    def _drain_loop(self) -> None:  # oryxlint: offloop (dedicated shadow-rescore thread)
        while not self._stop.is_set():
            try:
                sample = self._queue.get(timeout=1.0)
            except queue.Empty:
                continue
            while self.drain_gate.is_set() and not self._stop.is_set():
                time.sleep(0.005)
            try:
                self._process(sample)
            except Exception:  # noqa: BLE001 - the sampler never breaks serving
                log.exception("shadow rescore sample failed")
            finally:
                with self._lock:
                    self._processed += 1

    def _process(self, sample: _Sample) -> None:
        recall, margin = self.score_sample(sample)
        if recall is None:
            return
        self.ensure_metrics()
        g_recall, h_margin, c_samples, c_bad, _ = self._metrics
        c_samples.inc(score_mode=sample.score_mode)
        bad = recall < self.recall_floor
        if bad:
            c_bad.inc(score_mode=sample.score_mode)
        h_margin.observe(margin, trace_id=sample.trace_id)
        now = time.monotonic()
        with self._lock:
            win = self._recall_window.setdefault(
                sample.score_mode, deque(maxlen=_MAX_WINDOW_SAMPLES)
            )
            win.append((now, recall))
            if sample.served_scores:
                self._score_window.append(
                    (now, float(np.mean(sample.served_scores)))
                )
        # gauge callbacks are bound per observed score mode (labels are
        # data-driven; binding is idempotent per mode)
        g_recall.set_function(
            self._recall_reader(sample.score_mode),
            score_mode=sample.score_mode,
        )
        self.evaluate_alarms()
        # prediction drift only fills HERE (a serving-only process never
        # sees note_input_events), so its alarm must also fire here
        self.evaluate_drift_alarms()

    def score_sample(self, sample: _Sample):
        """The one shadow-rescore computation (shared with the nightly
        harness): exact host top-k over the full matrix, same exclusion
        trim as serving, recall@min(k, served page) + relative score
        margin. Returns (None, None) when the sample can't be scored."""
        try:
            mat, ids, n = sample.snapshot_fn()
        except Exception:  # noqa: BLE001 - a racing model swap loses one sample
            return None, None
        if mat is None or n == 0:
            return None, None
        mat = np.asarray(mat, dtype=np.float32)[:n]
        k_fetch = min(n, sample.how_many + len(sample.exclude) + 8)
        vals, idx = _exact_topk(sample.vec, k_fetch, mat, sample.cosine)
        exact_pairs = []
        for v, j in zip(np.asarray(vals), np.asarray(idx)):
            ident = ids[int(j)]
            if ident in sample.exclude:
                continue
            exact_pairs.append((ident, float(v)))
            if len(exact_pairs) == sample.how_many:
                break
        if not exact_pairs:
            return None, None
        k = min(LIVE_RECALL_K, sample.how_many,
                len(sample.served_ids), len(exact_pairs))
        if k == 0:
            return None, None
        exact_ids = [i for i, _ in exact_pairs[:k]]
        recall = len(set(sample.served_ids[:k]) & set(exact_ids)) / k
        exact_top = exact_pairs[0][1]
        served_top = sample.served_scores[0] if sample.served_scores else 0.0
        denom = max(abs(exact_top), 1e-9)
        margin = max(0.0, (exact_top - served_top) / denom)
        return float(recall), float(margin)

    def _recall_reader(self, score_mode: str):
        return lambda: self.live_recall(score_mode)

    def _window_bad_fraction(self) -> float | None:
        """Fraction of window samples below the recall floor (None on an
        empty window) — the alarm path's fresh numerator; the SLO ring
        stores at most one sample per 50ms and a fast drain can outrun
        it."""
        cutoff = time.monotonic() - self.window_s
        bad = total = 0
        with self._lock:
            for win in self._recall_window.values():
                for t, r in win:
                    if t >= cutoff:
                        total += 1
                        if r < self.recall_floor:
                            bad += 1
        return (bad / total) if total else None

    def live_recall(self, score_mode: str | None = None) -> float:
        """Windowed mean recall (NaN when no sample landed in the
        window). score_mode=None pools every mode — the console/healthz
        headline."""
        cutoff = time.monotonic() - self.window_s
        vals: list[float] = []
        with self._lock:
            wins = (
                list(self._recall_window.values())
                if score_mode is None
                else [self._recall_window.get(score_mode, deque())]
            )
            for win in wins:
                vals.extend(r for t, r in win if t >= cutoff)
        return float(np.mean(vals)) if vals else float("nan")

    def samples_processed(self) -> int:
        with self._lock:
            return self._processed

    # -- drift -------------------------------------------------------------

    def note_generation(self, generation=None) -> None:
        """A new model generation was adopted for serving (freshness
        tracker hook): the recall/served-score windows describe the
        PREVIOUS generation's answers, and pooling them forward would
        let a quality-alarm fire under a healthy rollback generation
        while naming IT as degraded — the windows are generation-scoped,
        the cumulative SLO counters deliberately are not."""
        with self._lock:
            self._recall_window.clear()
            self._score_window.clear()

    def set_training_profile(self, profile: TrainingProfile) -> None:
        """Adopt the served generation's profile (called when a MODEL
        artifact carrying a qualityProfile extension loads). The live
        new-item tracking resets to the generation's catalog view."""
        self.profile = profile
        with self._lock:
            self._input_window.clear()

    def note_catalog(self, item_ids) -> None:
        """Items the served generation knows — the denominator of the
        live new-item fraction."""
        with self._lock:
            self._known_items = set(str(i) for i in item_ids)

    def note_input_events(self, item_ids, timestamps_ms=None) -> None:
        """Speed/serving-side hook: fold one micro-batch of raw input
        events into the live input window. Cost is one blake2b per event
        — micro-batch granularity, never per-request."""
        if not self.enabled:
            return
        ids = [str(i) for i in item_ids]
        if not ids:
            return
        counts = np.zeros(SKETCH_BUCKETS, dtype=np.float64)
        for ident in ids:
            counts[sketch_bucket(ident)] += 1.0
        with self._lock:
            known = self._known_items
            n_new = sum(1 for i in ids if i not in known) if known else 0
            self._input_window.append(
                (time.monotonic(), counts, len(ids), n_new)
            )
        self.evaluate_drift_alarms()

    def _live_input(self):
        """(pooled sketch counts, events, new) inside the window."""
        cutoff = time.monotonic() - self.window_s
        counts = np.zeros(SKETCH_BUCKETS, dtype=np.float64)
        n_events = n_new = 0
        oldest = None
        with self._lock:
            for t, c, n, new in self._input_window:
                if t < cutoff:
                    continue
                counts += c
                n_events += n
                n_new += new
                oldest = t if oldest is None else min(oldest, t)
        span = (time.monotonic() - oldest) if oldest is not None else 0.0
        return counts, n_events, n_new, span

    def input_drift(self, signal: str) -> float:
        """Live-vs-profile distance for one input signal; NaN without
        both sides."""
        p = self.profile
        if p is None:
            return float("nan")
        counts, n_events, n_new, span = self._live_input()
        if n_events == 0:
            return float("nan")
        if signal == "item-popularity":
            if not p.item_sketch:
                return float("nan")
            live = counts / counts.sum()
            prof = np.asarray(p.item_sketch, dtype=np.float64)
            if prof.sum() <= 0:
                return float("nan")
            # total-variation distance: 0 = identical shape, 1 = disjoint
            return float(0.5 * np.abs(live - prof / prof.sum()).sum())
        if signal == "event-rate":
            if p.events_per_sec is None or p.events_per_sec <= 0 or span <= 0:
                return float("nan")
            live_rate = n_events / span
            return float(
                abs(live_rate - p.events_per_sec) / p.events_per_sec
            )
        if signal == "new-item-fraction":
            with self._lock:
                if not self._known_items:
                    return float("nan")
            return float(n_new / n_events)
        return float("nan")

    def prediction_drift(self, signal: str) -> float:
        p = self.profile
        if p is None:
            return float("nan")
        cutoff = time.monotonic() - self.window_s
        with self._lock:
            scores = [s for t, s in self._score_window if t >= cutoff]
        if not scores:
            return float("nan")
        live_mean = float(np.mean(scores))
        live_std = float(np.std(scores))
        if signal == "score-mean":
            if p.score_mean is None:
                return float("nan")
            denom = max(abs(p.score_mean), p.score_std or 0.0, 1e-9)
            return abs(live_mean - p.score_mean) / denom
        if signal == "score-spread":
            if p.score_std is None or p.score_std <= 0:
                return float("nan")
            return abs(live_std - p.score_std) / p.score_std
        return float("nan")

    # -- alarms ------------------------------------------------------------

    def evaluate_alarms(self) -> bool:
        """Fire a ``quality-alarm`` flight event when the quality SLO's
        fast burn rate crosses the alarm threshold while the live recall
        window sits below the floor — the burn-rate/flight machinery a
        degraded generation must trip. Called per drained sample (and by
        tests); rate-limited by the flight recorder's episode window."""
        from oryx_tpu_torch.common import slo

        t = slo.tracker("quality")
        if t is None:
            return False
        burn = t.burn_rate(t.fast_s)
        # the scrape-driven ring is bounded to one sample per 50ms, so a
        # burst the drain scores faster than that can sit between ring
        # samples; derive the burn from the sampler's own window too
        # (identical objective/budget semantics, fresher numerator) and
        # alarm on the larger
        budget = 1.0 - t.objective
        frac = self._window_bad_fraction()
        if budget > 0 and frac is not None:
            burn = max(burn, frac / budget)
        recall = self.live_recall()
        if burn < self.alarm_burn_rate or math.isnan(recall):
            return False
        if recall >= self.recall_floor:
            return False
        from oryx_tpu_torch.common.flightrec import get_flightrec
        from oryx_tpu_torch.common.freshness import model_freshness

        return get_flightrec().record(
            kind="quality-alarm",
            episode_s=30.0,
            generation=model_freshness().generation,
            live_recall=round(recall, 4),
            recall_floor=self.recall_floor,
            burn_rate=round(burn, 2),
        )

    def evaluate_drift_alarms(self) -> bool:
        """Fire a ``drift-alarm`` flight event when any drift signal
        crosses the configured threshold (episode-limited)."""
        worst_signal, worst = None, 0.0
        for signal in _INPUT_SIGNALS:
            v = self.input_drift(signal)
            if not math.isnan(v) and v > worst:
                worst_signal, worst = f"input:{signal}", v
        for signal in _PREDICTION_SIGNALS:
            v = self.prediction_drift(signal)
            if not math.isnan(v) and v > worst:
                worst_signal, worst = f"prediction:{signal}", v
        if worst_signal is None or worst < self.drift_alarm:
            return False
        from oryx_tpu_torch.common.flightrec import get_flightrec
        from oryx_tpu_torch.common.freshness import model_freshness

        return get_flightrec().record(
            kind="drift-alarm",
            episode_s=30.0,
            generation=model_freshness().generation,
            signal=worst_signal,
            value=round(worst, 4),
            threshold=self.drift_alarm,
        )

    # -- surfaces ----------------------------------------------------------

    def healthz_section(self) -> dict:
        """The /healthz ``quality`` body section (and, probed from it,
        each replica's scorecard in /fleet/status). Cheap enough for the
        nonblocking healthz handler: window reads under one lock, all
        values JSON-finite."""
        from oryx_tpu_torch.common.freshness import model_freshness

        def fin(v):
            return (
                round(v, 4)
                if isinstance(v, (int, float)) and math.isfinite(v)
                else None
            )

        self.ensure_metrics()
        out: dict = {
            "live_recall_at_10": fin(self.live_recall()),
            "samples": self.samples_processed(),
            "dropped": int(self._metrics[4].value()),
            "sample_rate": self.sample_rate,
        }
        mf = model_freshness()
        if getattr(mf, "quality", None):
            out["generation_quality"] = {
                str(k): fin(v) for k, v in mf.quality.items()
            }
        drift_in = {
            s: fin(self.input_drift(s)) for s in _INPUT_SIGNALS
        }
        drift_pred = {
            s: fin(self.prediction_drift(s)) for s in _PREDICTION_SIGNALS
        }
        if any(v is not None for v in drift_in.values()):
            out["input_drift"] = drift_in
        if any(v is not None for v in drift_pred.values()):
            out["prediction_drift"] = drift_pred
        return out


# -- process-global instance --------------------------------------------------

_default = QualityStats()


def get_qualitystats() -> QualityStats:
    return _default


def configure_qualitystats(config) -> QualityStats:
    _default.configure(config)
    return _default
