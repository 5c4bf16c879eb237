"""Self-describing model artifact: JSON metadata plus optional npz tensor
payloads (the port's copy of oryx_tpu/common/artifact.py: ``ModelArtifact``,
the publisher side ``publish_model_ref`` and the consumer side, the
bus-chunked MODEL-REF relay ``ArtifactRelay``).

It reads what the JAX package's ``ModelArtifact.write`` / ``to_string``
produce, and ``to_pmml_xml`` writes the same PMML document, so the
artifact is the weight interchange between the two packages. The relay's
cache directories (``<root>/<sha256(ref)[:24]>`` holding the artifact and
its ``relay.json`` sha marker) have the JAX package's layout, so a cache
one package materialized is adopted by the other. Layout on disk (a
directory):
    <dir>/model.json      {"app":..., "extensions":{...}, "content":{...}}
    <dir>/tensors.npz     optional named ndarray payloads
"""

from __future__ import annotations

import base64
import io
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np

from oryx_tpu_torch.common.ioutil import mkdirs, strip_scheme

MODEL_FILENAME = "model.json"
TENSORS_FILENAME = "tensors.npz"


class ModelArtifact:
    def __init__(
        self,
        app: str,
        extensions: Mapping[str, str] | None = None,
        content: Mapping[str, Any] | None = None,
        tensors: Mapping[str, np.ndarray] | None = None,
    ):
        self.app = app
        self.extensions: dict[str, str] = dict(extensions or {})
        self.content: dict[str, Any] = dict(content or {})
        self.tensors: dict[str, np.ndarray] = dict(tensors or {})

    # -- extensions as generic KV channel (AppPMMLUtils.getExtensionValue) --

    def get_extension(self, name: str, default: Any = None) -> Any:
        return self.extensions.get(name, default)

    def set_extension(self, name: str, value: Any) -> None:
        self.extensions[name] = value if isinstance(value, str) else json.dumps(value)

    def get_extension_list(self, name: str) -> list:
        v = self.extensions.get(name)
        if v is None:
            return []
        return json.loads(v) if isinstance(v, str) else list(v)

    # -- disk I/O (PMMLUtils.write/read) ------------------------------------

    def write(self, path: str | Path) -> Path:
        d = mkdirs(strip_scheme(str(path)))
        with open(d / MODEL_FILENAME, "w", encoding="utf-8") as f:
            json.dump(
                {"app": self.app, "extensions": self.extensions, "content": self.content},
                f,
            )
        if self.tensors:
            np.savez_compressed(d / TENSORS_FILENAME, **self.tensors)
        return d

    @staticmethod
    def read(path: str | Path) -> "ModelArtifact":
        d = Path(strip_scheme(str(path)))
        if d.is_file():
            d = d.parent
        with open(d / MODEL_FILENAME, "r", encoding="utf-8") as f:
            meta = json.load(f)
        tensors: dict[str, np.ndarray] = {}
        tp = d / TENSORS_FILENAME
        if tp.exists():
            with np.load(tp) as z:
                tensors = {k: z[k] for k in z.files}
        return ModelArtifact(meta["app"], meta.get("extensions"), meta.get("content"), tensors)

    # -- inline string form (PMMLUtils.toString/fromString) -----------------

    def to_string(self) -> str:
        doc: dict[str, Any] = {
            "app": self.app,
            "extensions": self.extensions,
            "content": self.content,
        }
        if self.tensors:
            buf = io.BytesIO()
            np.savez_compressed(buf, **self.tensors)
            doc["tensors_b64"] = base64.b64encode(buf.getvalue()).decode("ascii")
        return json.dumps(doc, separators=(",", ":"))

    @staticmethod
    def from_string(s: str) -> "ModelArtifact":
        doc = json.loads(s)
        tensors: dict[str, np.ndarray] = {}
        if "tensors_b64" in doc:
            with np.load(io.BytesIO(base64.b64decode(doc["tensors_b64"]))) as z:
                tensors = {k: z[k] for k in z.files}
        return ModelArtifact(doc["app"], doc.get("extensions"), doc.get("content"), tensors)

    # -- PMML export shim ---------------------------------------------------

    def to_pmml_xml(self) -> str:
        """Minimal PMML 4.3 document: header + extensions (+ ClusteringModel
        for k-means content), enough for external PMML consumers to read what
        the reference would have published."""
        from xml.sax.saxutils import escape, quoteattr

        lines = [
            '<?xml version="1.0" encoding="UTF-8"?>',
            '<PMML xmlns="http://www.dmg.org/PMML-4_3" version="4.3">',
            '  <Header><Application name="oryx_tpu"/></Header>',
        ]
        for k, v in self.extensions.items():
            lines.append(f"  <Extension name={quoteattr(k)} value={quoteattr(str(v))}/>")
        if self.app == "kmeans" and "centers" in self.tensors:
            centers = self.tensors["centers"]
            counts = self.content.get("counts", [0] * len(centers))
            n_feat = centers.shape[1] if len(centers) else 0
            lines.append(
                f'  <ClusteringModel functionName="clustering" modelClass="centerBased" '
                f'numberOfClusters="{len(centers)}">'
            )
            lines.append(
                '    <ComparisonMeasure kind="distance"><squaredEuclidean/></ComparisonMeasure>'
            )
            lines.append("    <MiningSchema/>")
            ids = self.content.get("clusterIDs") or [str(i) for i in range(len(centers))]
            for i, c in enumerate(centers):
                center = " ".join(repr(float(x)) for x in c)
                lines.append(
                    f"    <Cluster id={quoteattr(str(ids[i]))} "
                    f"size={quoteattr(str(int(counts[i])))}>"
                    f'<Array n="{n_feat}" type="real">{escape(center)}</Array></Cluster>'
                )
            lines.append("  </ClusteringModel>")
        lines.append("</PMML>")
        return "\n".join(lines)


def read_artifact_from_update(key: str, message: str) -> ModelArtifact:
    """Decode a MODEL (inline artifact) or MODEL-REF (path) update message —
    the consumer-side counterpart of the size cutover at the reference's
    MLUpdate.java:212-231 / AppPMMLUtils.readPMMLFromUpdateKeyMessage.

    MODEL-REF resolution is cross-host capable: the local path wins when it
    exists (shared mount / same host), otherwise the bus-chunked copy
    assembled by the ArtifactRelay stands in — the reference reads the
    path through a shared Hadoop FileSystem (AppPMMLUtils.java:261-275,
    FileSystem.get), which has no equivalent here without HDFS."""
    if key == "MODEL":
        # an inline MODEL is decoded by EVERY consumer that receives it —
        # inherently per-replica distribution cost (N replicas on a host
        # pay N decodes); only the chunked MODEL-REF path can amortize
        _distribution_bytes().inc(
            len(message.encode("utf-8")), mode="per-replica"
        )
        return ModelArtifact.from_string(message)
    if key == "MODEL-REF":
        return ModelArtifact.read(artifact_relay().resolve(message))
    raise ValueError(f"not a model update key: {key}")


# -- bus-chunked MODEL-REF transfer (no shared filesystem required) --------

CHUNK_KEY = "MODEL-CHUNK"

# sha marker the relay leaves beside a materialized artifact so co-hosted
# sibling processes can tell "this exact chunk stream is already decoded
# here" without re-assembling it (the fleet's amortized distribution)
RELAY_META_FILENAME = "relay.json"


def _distribution_bytes():
    """Counter behind the fleet's distribution-amortization claim:
    artifact bytes this process decoded+materialized getting a model to
    its serving replica(s). mode="shared" rode the per-host artifact
    cache (first completer decodes, siblings skip — N co-hosted replicas
    total ~1x the artifact); mode="per-replica" was a redundant
    per-process decode (inline MODELs, or sharing disabled)."""
    from oryx_tpu_torch.common.metrics import get_registry

    return get_registry().counter(
        "oryx_fleet_distribution_bytes",
        "Artifact bytes decoded for model distribution in this process: "
        "mode=shared deduplicated through the per-host artifact cache "
        "(one decode per host), mode=per-replica redundant per-process "
        "decode (inline MODEL messages, or oryx.fleet.distribution."
        "shared=false)",
        labeled=True,
    )


class ArtifactRelay:
    """Assembles MODEL-CHUNK messages into a local artifact cache so any
    consumer on any host can resolve a MODEL-REF without a shared mount.

    The publisher emits the oversized artifact's exact serialized form as
    N b64 chunks (each under the update topic's max message size) just
    before the MODEL-REF line; replaying consumers (serving/speed read the
    update topic from earliest) re-assemble them on every restart, which
    is the same replay contract the reference relies on for UP messages.
    Requires the update topic's publish order (single partition, the
    reference's own convention for ordered model updates)."""

    # un-assembled chunks of refs OTHER than the one currently arriving;
    # the in-flight ref itself is never evicted — its transient memory
    # floor is one artifact's serialized size, the same cost the
    # publisher paid to send it
    MAX_PENDING_BYTES = 1 << 29  # 512 MB
    # materialized artifacts kept on disk per process; replay (consumers
    # read the update topic from earliest on every restart) re-walks all
    # historical models, and without a cap the cache would accrete every
    # oversized artifact ever published
    MAX_CACHED = 8

    # parked re-dispatch callbacks for refs that could not be resolved
    # when their MODEL-REF arrived (chunks still in flight, sha-mismatch
    # republish, eviction race): bounded because replay also walks
    # MODEL-REFs whose artifacts were TTL-pruned years ago and will never
    # materialize
    MAX_PARKED = 32

    def __init__(self, cache_root: str | Path | None = None):
        import threading

        self._lock = threading.Lock()
        # ref -> {"n": int, "sha": str | None, "chunks": {i: bytes}}
        self._pending: dict[str, dict] = {}
        # None: the stable per-user root under the temp dir, shared with
        # every co-hosted consumer (and with the JAX package's relay)
        self._root_arg = cache_root
        self._cache_root: Path | None = None
        # ref -> ONE re-dispatch callback (latest wins): a sha-mismatch
        # republish parks the same ref twice, and firing both would load
        # and swap the same model twice
        self._parked: dict[str, object] = {}
        # amortize assembly across co-hosted replicas (the fleet's shared
        # model distribution): a sibling's sha-marked materialization is
        # adopted instead of redundantly re-decoded. Configured from
        # oryx.fleet.distribution.shared (configure_artifact_relay).
        self.shared_distribution = True
        # cache dirs the LRU must never evict (ref -> pin count): the
        # model gate pins its adoption history so a rollback target is
        # still a local pointer swap however many generations replay
        # through the cache in between
        self._pinned: dict[str, int] = {}  # guarded-by: _lock

    def _root(self) -> Path:
        if self._cache_root is None:
            import os
            import tempfile

            # STABLE per-user root (not a fresh mkdtemp per process):
            # cache dirs are keyed by ref, so a restart's replay rewrites
            # the same paths instead of accreting a new copy of history
            # in a new directory every time
            root = (
                Path(strip_scheme(str(self._root_arg)))
                if self._root_arg is not None
                else Path(tempfile.gettempdir())
                / f"oryx-artifact-cache-{os.getuid()}"
            )
            root.mkdir(mode=0o700, parents=True, exist_ok=True)
            self._cache_root = root
        return self._cache_root

    def offer(self, message: str) -> None:
        """Ingest one MODEL-CHUNK message; materializes the artifact into
        the local cache when the last chunk arrives. With shared
        distribution on, a chunk stream a co-hosted sibling already
        assembled (matching sha marker in the shared cache) is skipped
        wholesale — not even base64-decoded — so N replicas on one host
        pay ~one decode total."""
        import hashlib

        d = json.loads(message)
        ref, i, n = str(d["ref"]), int(d["i"]), int(d["n"])
        if not (0 <= i < n):
            raise ValueError(f"bad chunk index {i}/{n}")
        if (
            self.shared_distribution
            and d.get("sha") is not None
            and self._cached_sha(ref) == d["sha"]
        ):
            # the marker re-check stays per-chunk (one tiny-file read —
            # it also notices a sibling evicting the dir mid-stream) but
            # the adoption side-effects (LRU utime, cache-root scan,
            # parked-ref fire) run once per STREAM, not once per chunk:
            # a replayed 1 GB artifact at 1 MB chunks must not cost ~1000
            # directory scans on the update-consumer thread. A parked
            # MODEL-REF fires immediately instead of waiting for the
            # stream's tail.
            with self._lock:
                self._pending.pop(ref, None)
                parked = ref in self._parked
            if parked or i == n - 1:
                self._adopt(ref)
            return
        data = base64.b64decode(d["data"])
        with self._lock:
            ent = self._pending.setdefault(
                ref, {"n": n, "sha": d.get("sha"), "chunks": {}}
            )
            if ent["n"] != n or (
                d.get("sha") is not None and d["sha"] != ent["sha"]
            ):
                # a republish changed the chunking OR the bytes (same
                # count, new content after a publisher restart): restart
                # the assembly — mixing streams would fail verification
                # forever
                ent = self._pending[ref] = {
                    "n": n, "sha": d.get("sha"), "chunks": {}
                }
            ent["chunks"][i] = data
            self._evict_locked(keep=ref)
            if len(ent["chunks"]) < n:
                return
            blob = b"".join(ent["chunks"][j] for j in range(n))
            del self._pending[ref]
        sha = ent.get("sha")
        if sha and hashlib.sha256(blob).hexdigest() != sha:
            raise ValueError(f"MODEL-CHUNK sha mismatch for {ref}")
        self._finish(ref, blob, sha)

    def _finish(self, ref: str, blob: bytes, sha: str | None) -> None:
        """Decode + materialize one fully assembled chunk stream, deduped
        across co-hosted processes when sharing is on: the assembly lock
        serializes the (fast) decode+write, and a loser re-checking the
        sha marker under the lock adopts the winner's bytes-identical
        copy instead of decoding its own. Either way exactly one process
        counts the blob into mode=shared; the disabled path counts every
        process's decode into mode=per-replica."""
        if self.shared_distribution and sha is not None:
            with self._assembly_lock(ref):
                if self._cached_sha(ref) == sha:
                    # lost the race to a sibling replica — its copy is the
                    # same bytes (same sha); nothing left to decode
                    self._adopt(ref)
                    return
                self._materialize(ref, blob, sha=sha)
            _distribution_bytes().inc(len(blob), mode="shared")
            return
        self._materialize(ref, blob, sha=sha)
        _distribution_bytes().inc(len(blob), mode="per-replica")

    def _adopt(self, ref: str) -> None:
        """Adopt a sibling's materialization as this relay's own: bump the
        shared LRU stamp and apply this relay's cache cap. An adopting
        consumer replaying a long topic history must prune exactly like a
        materializing one would, or its MAX_CACHED stops bounding the
        shared root whenever the artifacts are already decoded."""
        dest = self._dest(ref)
        self._stamp(dest)
        self._evict_cache_dirs(keep=dest)
        self._fire_parked(ref)

    def _assembly_lock(self, ref: str):
        """Cross-process exclusive lock for one ref's decode+materialize
        (an advisory flock file beside the cache dir — a dotfile, so the
        cache-dir LRU never sees it). Platforms without fcntl fall back
        to unlocked operation: the race then just costs a redundant
        decode, never corruption (materialize is rename-atomic)."""
        from contextlib import contextmanager

        @contextmanager
        def _cm():
            try:
                import fcntl

                f = open(self._root() / f".{self._dest(ref).name}.lock", "a+b")
            except (ImportError, OSError):
                yield
                return
            try:
                fcntl.flock(f, fcntl.LOCK_EX)
                yield
            finally:
                try:
                    fcntl.flock(f, fcntl.LOCK_UN)
                except OSError:  # pragma: no cover - unlock-on-close wins
                    pass
                f.close()

        return _cm()

    def _cached_sha(self, ref: str) -> str | None:
        """sha of the materialized artifact for `ref` in the shared cache,
        or None (not materialized, or materialized by a pre-marker
        writer)."""
        try:
            with open(
                self._dest(ref) / RELAY_META_FILENAME, encoding="utf-8"
            ) as f:
                v = json.load(f).get("sha")
            return str(v) if v else None
        except (OSError, ValueError):
            return None

    def _dest(self, ref: str) -> Path:
        """The deterministic cache dir for a ref — derived, not tracked:
        every process sharing the root computes the same path, so one
        process's materialization is a cache hit for its siblings."""
        import hashlib

        return self._root() / hashlib.sha256(ref.encode()).hexdigest()[:24]

    def _materialize(
        self, ref: str, blob: bytes, sha: str | None = None
    ) -> None:
        """Write an assembled chunk stream (the artifact's serialized form)
        into the stable cache, atomically enough for concurrent processes:
        build in a per-pid temp dir, then rename into place; a lost race
        just adopts the winner's copy (identical bytes — both assembled the
        same chunk stream). The stream's npz archive of tensors is written
        as the publisher encoded it, never inflated and deflated again on
        the way. The sha marker rides INSIDE the dir
        (written before the rename) so a sibling never reads a marker
        whose artifact is half-written."""
        import os
        import shutil

        dest = self._dest(ref)
        tmp = self._root() / f".{dest.name}.tmp-{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        doc = json.loads(blob)
        npz = doc.pop("tensors_b64", None)
        ModelArtifact(doc["app"], doc.get("extensions"), doc.get("content")).write(tmp)
        if npz is not None:
            (tmp / TENSORS_FILENAME).write_bytes(base64.b64decode(npz))
        if sha is not None:
            with open(tmp / RELAY_META_FILENAME, "w", encoding="utf-8") as f:
                json.dump({"sha": sha}, f)
        shutil.rmtree(dest, ignore_errors=True)
        try:
            os.replace(tmp, dest)
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)  # another process won
        self._stamp(dest)
        self._evict_cache_dirs(keep=dest)
        self._fire_parked(ref)

    def _cache_dirs(self) -> list[Path]:
        return [
            d
            for d in self._root().iterdir()
            if d.is_dir() and not d.name.startswith(".")
        ]

    @staticmethod
    def _mtime_ns(d: Path) -> int:
        try:
            return d.stat().st_mtime_ns
        except OSError:  # concurrently evicted by a sibling
            return 0

    def _stamp(self, dest: Path) -> None:
        """Bump ``dest``'s shared LRU stamp (see _evict_cache_dirs) to
        strictly above every stamp under the cache root, or to the clock
        where that is later. The file system's clock is coarse: two dirs
        touched within one tick would tie, and the older one could
        outlive the newer."""
        import os
        import time

        try:
            newest = max((self._mtime_ns(d) for d in self._cache_dirs()),
                         default=0)
            t = max(time.time_ns(), newest + 1)
            os.utime(dest, ns=(t, t))
        except OSError:
            pass

    def _evict_cache_dirs(self, keep: Path) -> None:
        """Cross-PROCESS LRU over the shared per-user cache root: speed
        and serving consumers on one host share the root, so eviction
        must rank by shared state — directory mtimes, stamped strictly
        above the root's newest on every materialize and resolve
        (``_stamp``), ties broken by name — not a per-process dict.
        (Round-4 advice: per-process LRU deleted dirs a sibling process
        still held in its in-memory cache, silently dropping its MODEL
        update.) A dir in active use carries the newest stamp and
        survives; any residual race is caught by resolve()'s existence
        re-check."""
        import shutil

        try:
            dirs = self._cache_dirs()
        except OSError:
            return
        if len(dirs) <= self.MAX_CACHED:
            return
        with self._lock:
            pinned = {self._dest(r).name for r in self._pinned}
        dirs.sort(key=lambda d: (self._mtime_ns(d), d.name))
        for d in dirs[: len(dirs) - self.MAX_CACHED]:
            if d != keep and d.name not in pinned:
                shutil.rmtree(d, ignore_errors=True)

    def _evict_locked(self, keep: str) -> None:
        total = sum(
            len(c)
            for e in self._pending.values()
            for c in e["chunks"].values()
        )
        while total > self.MAX_PENDING_BYTES:
            victim = next(
                (r for r in self._pending if r != keep), None
            )
            if victim is None:
                return  # never evict the ref currently being assembled
            ev = self._pending.pop(victim)
            total -= sum(len(c) for c in ev["chunks"].values())
            import logging

            logging.getLogger(__name__).warning(
                "artifact relay evicted pending chunks for %s", victim
            )

    def park(self, ref: str, redispatch) -> None:
        """Register a callback to re-run when `ref` later materializes —
        the dispatch loop's short OSError retries give up in ~1.2s, which
        loses the model permanently when the chunk stream simply hadn't
        finished (multi-partition lag, sha-mismatch republish, eviction
        race). One callback per ref, latest wins: a republished ref parks
        twice but must dispatch once. Parked callbacks fire from
        _materialize; the register-then-recheck order closes the race
        against a materialization landing between the caller's last retry
        and the park."""
        import logging

        with self._lock:
            self._parked[ref] = redispatch
            while len(self._parked) > self.MAX_PARKED:
                victim = next(r for r in self._parked if r != ref)
                del self._parked[victim]
                logging.getLogger(__name__).warning(
                    "dropping parked MODEL-REF %s (parking full)", victim
                )
        try:
            self.resolve(ref)
        except OSError:
            return  # genuinely pending: _materialize will fire it
        self._fire_parked(ref)

    def _fire_parked(self, ref: str) -> None:
        import logging

        with self._lock:
            cb = self._parked.pop(ref, None)
        if cb is not None:
            try:
                cb()
            except Exception:
                logging.getLogger(__name__).exception(
                    "parked MODEL-REF re-dispatch failed for %s", ref
                )

    def pin(self, ref: str) -> None:
        """Exempt a ref's cache dir from LRU eviction (refcounted — the
        model gate pins every adoption-history entry and a generation can
        re-enter history). Pinning is advisory: it protects the CACHE
        copy only, and a ref resolving through its original path needs no
        protection at all."""
        with self._lock:
            self._pinned[ref] = self._pinned.get(ref, 0) + 1
        self._stamp(self._dest(ref))  # absent: original path, inline MODEL

    def unpin(self, ref: str) -> None:
        """Drop one pin on a ref; at zero the dir rejoins the normal LRU
        (not deleted eagerly — it may be the freshest entry)."""
        with self._lock:
            n = self._pinned.get(ref, 0) - 1
            if n <= 0:
                self._pinned.pop(ref, None)
            else:
                self._pinned[ref] = n

    def resolve(self, ref: str) -> str:
        """A readable local path for a MODEL-REF: the path itself when it
        exists, else the bus-assembled cache copy. FileNotFoundError (an
        OSError — the dispatch loop's transient-I/O retry class) when
        neither is available yet."""
        p = Path(strip_scheme(ref))
        if (p / MODEL_FILENAME).exists() or p.is_file():
            return str(p)
        c = self._dest(ref)  # derived path: a SIBLING process's
        if (c / MODEL_FILENAME).exists():  # materialization is a hit too
            self._stamp(c)  # in-use dirs survive
            return str(c)
        raise FileNotFoundError(
            f"MODEL-REF {ref} is not readable locally and no complete "
            f"bus-chunked copy has arrived"
        )


_RELAY: ArtifactRelay | None = None


def artifact_relay() -> ArtifactRelay:
    """Process-global relay: one consumer-side cache shared by every
    listener thread in the process."""
    global _RELAY
    if _RELAY is None:
        _RELAY = ArtifactRelay()
    return _RELAY


def reset_artifact_relay(cache_root: str | Path | None = None) -> ArtifactRelay:
    """Replace the process-global relay with a fresh one whose cache lives
    under ``cache_root`` (None: the stable per-user root). A process that
    must keep its cache inside its own directory, such as a test or the
    smoke run, calls this before its consumers start."""
    global _RELAY
    _RELAY = ArtifactRelay(cache_root)
    return _RELAY


def configure_artifact_relay(config) -> None:
    """Adopt the fleet's distribution mode (called wherever a process
    adopts its config — ServingApp, layer startup): shared = amortize
    chunk assembly across co-hosted replicas through the per-host cache;
    off restores strictly per-process decodes."""
    artifact_relay().shared_distribution = config.get_bool(
        "oryx.fleet.distribution.shared", True
    )


def publish_model_ref(
    producer,
    serialized: str,
    model_path: str,
    max_message_size: int,
    transfer: bool = True,
) -> None:
    """Publish an oversized model as MODEL-CHUNK x N + MODEL-REF. transfer
    False restores the reference's bare-path behavior (shared-mount
    deployments that don't want the topic to carry the artifact bytes)."""
    # headroom for the JSON envelope (ref path + indices + sha), then 4/3
    # b64 expansion; a cap too small to carry even the envelope falls back
    # to the bare reference (chunks would overrun the topic's limit)
    budget = (max_message_size - 512 - len(model_path)) // 4 * 3
    if transfer and budget < 1:
        import logging

        logging.getLogger(__name__).warning(
            "update-topic max-size %d too small for artifact chunks; "
            "publishing bare MODEL-REF (consumers need path access)",
            max_message_size,
        )
        transfer = False
    if transfer:
        import hashlib
        import math

        raw = serialized.encode("utf-8")
        sha = hashlib.sha256(raw).hexdigest()
        n = max(1, math.ceil(len(raw) / budget))
        # chunks ship in bounded batches through send_batch (one broker
        # lock round-trip per group instead of per chunk; same-key records
        # share a partition, so publish order is preserved). The group cap
        # bounds transient memory to ~8 encoded chunks, not the whole
        # artifact twice.
        send_batch = getattr(producer, "send_batch", None)
        batch: list[tuple[str, str]] = []

        def _flush() -> None:
            if not batch:
                return
            if send_batch is not None:
                send_batch(batch)
            else:  # bare-broker callers without the batch API
                for key, msg in batch:
                    producer.send(key, msg)
            batch.clear()

        for i in range(n):
            batch.append(
                (
                    CHUNK_KEY,
                    json.dumps(
                        {
                            "ref": model_path,
                            "i": i,
                            "n": n,
                            "sha": sha,
                            "data": base64.b64encode(
                                raw[i * budget : (i + 1) * budget]
                            ).decode("ascii"),
                        },
                        separators=(",", ":"),
                    ),
                )
            )
            if len(batch) >= 8:
                _flush()
        _flush()
    producer.send("MODEL-REF", model_path)
