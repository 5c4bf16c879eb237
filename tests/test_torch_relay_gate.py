"""The artifact relay and the staged-adoption model gate of the port, against
the JAX package's own contracts (tests/test_artifact_relay.py,
tests/test_modelgate.py) and side by side with the JAX package:

- relay: the JAX contracts against the port's ``ArtifactRelay``, every
  cache rooted under ``tmp_path`` (never the stable per-user root the JAX
  package's tests share); chunks that one package's ``publish_model_ref``
  published assemble in the other package's relay, and each package adopts
  a cache directory the other materialized (the ``relay.json`` sha marker);
- gate: the JAX contracts against the port's ``ModelGate`` and its
  ``ServingLayer``; the same message sequence (MODEL, TRACE with
  generations, approve, rollback) gives both packages' gates the same
  adopt/hold/refuse decisions and the same ``healthz_section``;
- the control routes on the port's serving layer: approve/rollback answer
  (409 while the gate is off, 400 on a bad body), and while an approve
  builds the model's view a concurrent /ready and /healthz still answer
  on the async frontend.

Tolerance: exact equality throughout (the relay moves bytes, the gate is
plain control flow).
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import oryx_tpu.common.artifact as jartifact
import oryx_tpu.common.modelgate as jmodelgate
import oryx_tpu_torch.common.artifact as artifact_mod
import oryx_tpu_torch.common.modelgate as modelgate
from oryx_tpu.bus.api import KeyMessage as JKeyMessage
from oryx_tpu.common.config import load_config as jax_load_config
from oryx_tpu_torch.bus.api import KeyMessage
from oryx_tpu_torch.common.artifact import (
    CHUNK_KEY,
    RELAY_META_FILENAME,
    ArtifactRelay,
    ModelArtifact,
    publish_model_ref,
    read_artifact_from_update,
)
from oryx_tpu_torch.common.config import load_config
from oryx_tpu_torch.common.freshness import publish_stamp
from oryx_tpu_torch.common.modelgate import ModelGate, ModelGateError

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _fresh_relay(monkeypatch, tmp_path):
    """The process-global relays of both packages, rooted under tmp_path."""
    monkeypatch.setattr(
        artifact_mod, "_RELAY", ArtifactRelay(tmp_path / "relay-cache"))
    jrelay = jartifact.ArtifactRelay()
    jrelay._cache_root = tmp_path / "jax-relay-cache"
    jrelay._cache_root.mkdir()
    monkeypatch.setattr(jartifact, "_RELAY", jrelay)


class _CaptureProducer:
    def __init__(self):
        self.sent: list[tuple[str, str]] = []

    def send(self, key, message):
        self.sent.append((key, message))


def _sample_artifact() -> ModelArtifact:
    # big enough that to_string() far exceeds the 1024-byte max-size the
    # tests publish with (forcing the MODEL-REF + chunk path)
    rng = np.random.default_rng(5)
    return ModelArtifact(
        "kmeans",
        {"k": "3"},
        {"counts": [4, 5, 6]},
        {"centers": rng.standard_normal((3, 2048)).astype(np.float32)},
    )


def _relay(tmp_path, name: str = "isolated-root") -> ArtifactRelay:
    return ArtifactRelay(tmp_path / name)


def _kmeans_blob(i: str) -> bytes:
    """The serialized form of a tiny artifact, as a chunk stream assembles it."""
    return ModelArtifact("kmeans", {"i": i}, {}, {}).to_string().encode()


# ---- the relay: the JAX package's contracts ---------------------------------


def test_publish_chunks_then_ref_and_reassemble_out_of_order(tmp_path):
    art = _sample_artifact()
    prod = _CaptureProducer()
    ref = str(tmp_path / "model" / "12345")  # never written: no shared fs
    publish_model_ref(prod, art.to_string(), ref, max_message_size=1024)
    keys = [k for k, _ in prod.sent]
    assert keys[-1] == "MODEL-REF"
    chunks = [m for k, m in prod.sent if k == CHUNK_KEY]
    assert len(chunks) > 1  # really chunked at this max size
    for _k, m in prod.sent[:-1]:
        assert len(m.encode()) <= 1024  # every chunk respects max-size

    relay = artifact_mod.artifact_relay()
    # before any chunk: unresolvable, and as an OSError (retry class)
    with pytest.raises(OSError):
        relay.resolve(ref)
    for m in reversed(chunks):  # out-of-order arrival
        relay.offer(m)
    loaded = ModelArtifact.read(relay.resolve(ref))
    assert loaded.app == "kmeans"
    assert loaded.content["counts"] == [4, 5, 6]
    np.testing.assert_array_equal(
        loaded.tensors["centers"], art.tensors["centers"])
    # the cache lives under the configured root, not the stable one
    assert Path(relay.resolve(ref)).parent == tmp_path / "relay-cache"
    # the full consumer path resolves through the relay too
    art2 = read_artifact_from_update("MODEL-REF", ref)
    assert art2.extensions["k"] == "3"


@pytest.mark.parametrize("publisher", ["port", "jax"])
def test_relay_caches_the_published_npz_as_it_came(tmp_path, publisher):
    """A chunk stream materializes with its tensors' npz archive byte for
    byte as the publisher (the port's or the JAX package's serializer)
    encoded it, with no inflate and deflate on the way, and reads back
    equal to the artifact, also through the JAX package's reader."""
    import base64
    import io
    import zipfile

    art = _sample_artifact()
    if publisher == "port":
        serialized = art.to_string()
    else:
        serialized = jartifact.ModelArtifact(
            art.app, art.extensions, art.content, art.tensors).to_string()
    npz = base64.b64decode(json.loads(serialized)["tensors_b64"])
    with zipfile.ZipFile(io.BytesIO(npz)) as z:
        stored = {i.compress_type for i in z.infolist()}
    assert stored == {zipfile.ZIP_DEFLATED}
    assert ModelArtifact.from_string(serialized).tensors["centers"].tobytes() == (
        art.tensors["centers"].tobytes())
    prod = _CaptureProducer()
    ref = str(tmp_path / "model" / f"verbatim-{publisher}")
    publish_model_ref(prod, serialized, ref, max_message_size=1024)
    relay = _relay(tmp_path)
    for k, m in prod.sent:
        if k == CHUNK_KEY:
            relay.offer(m)
    d = Path(relay.resolve(ref))
    assert (d / "tensors.npz").read_bytes() == npz
    for loaded in (ModelArtifact.read(d), jartifact.ModelArtifact.read(str(d))):
        assert (loaded.app, loaded.extensions, loaded.content) == (
            art.app, art.extensions, art.content)
        np.testing.assert_array_equal(
            loaded.tensors["centers"], art.tensors["centers"])


def test_local_path_wins_over_cache(tmp_path):
    art = _sample_artifact()
    local = tmp_path / "local-model"
    art.write(local)
    assert _relay(tmp_path).resolve(str(local)) == str(local)


def test_sha_mismatch_rejected(tmp_path):
    prod = _CaptureProducer()
    ref = str(tmp_path / "m")
    publish_model_ref(prod, _sample_artifact().to_string(), ref,
                      max_message_size=1024)
    chunks = [m for k, m in prod.sent if k == CHUNK_KEY]
    relay = artifact_mod.artifact_relay()
    for m in chunks[:-1]:
        relay.offer(m)
    last = json.loads(chunks[-1])
    last["data"] = last["data"][:-8] + "AAAAAAAA"  # corrupt the payload
    with pytest.raises(ValueError):
        relay.offer(json.dumps(last))
    with pytest.raises(OSError):
        relay.resolve(ref)


def test_transfer_flag_off_sends_bare_ref(tmp_path):
    prod = _CaptureProducer()
    publish_model_ref(
        prod, _sample_artifact().to_string(), str(tmp_path / "m"),
        max_message_size=1024, transfer=False,
    )
    assert [k for k, _ in prod.sent] == ["MODEL-REF"]


def _kmeans_config():
    return load_config(overlay={
        "oryx.input-schema.num-features": 8,
        "oryx.input-schema.feature-names": [f"f{i}" for i in range(8)],
        "oryx.input-schema.numeric-features": [f"f{i}" for i in range(8)],
    })


def test_serving_manager_loads_chunked_model_without_path(tmp_path):
    """The port's k-means serving manager consumes the chunk stream +
    MODEL-REF through its normal dispatch loop and loads the model even
    though the referenced path never existed here."""
    from oryx_tpu_torch.apps.kmeans.serving import KMeansServingModelManager

    prod = _CaptureProducer()
    ref = str(tmp_path / "never-written" / "999")
    publish_model_ref(prod, _sample_artifact().to_string(), ref,
                      max_message_size=1024)
    mgr = KMeansServingModelManager(_kmeans_config(), device="cpu")
    mgr.consume(iter([KeyMessage(k, m) for k, m in prod.sent]))
    assert mgr.model is not None
    assert mgr.model.centers.shape == (3, 2048)


def test_cross_process_model_ref(tmp_path):
    """A batch process publishes a >max-size model over a file:// bus from
    ITS data dir (the port's MLUpdate.publish_model, artifact transfer on
    by default); a port consumer with no access to that dir (deleted here
    — no shared mount) still loads it."""
    bus = tmp_path / "bus"
    model_root = tmp_path / "batch-host-models"
    pub = (
        "import sys; sys.path.insert(0, %r)\n"
        "import numpy as np\n"
        "from oryx_tpu_torch.bus import TopicProducer, get_broker, topic_admin\n"
        "from oryx_tpu_torch.common.artifact import ModelArtifact\n"
        "from oryx_tpu_torch.common.config import load_config\n"
        "from oryx_tpu_torch.ml.update import MLUpdate\n"
        "uri = 'file://%s'\n"
        "topic_admin.maybe_create(uri, 'OryxUpdate', partitions=1)\n"
        "rng = np.random.default_rng(5)\n"
        "art = ModelArtifact('kmeans', {'k': '3'}, {'counts': [4, 5, 6]},\n"
        "                    {'centers': rng.standard_normal((3, 2048)).astype(np.float32)})\n"
        "path = art.write(%r)\n"
        "cfg = load_config(overlay={'oryx.update-topic.message.max-size': 1024})\n"
        "class Pub(MLUpdate):\n"
        "    def build_model(self, *a, **k): raise NotImplementedError\n"
        "    def evaluate(self, *a, **k): raise NotImplementedError\n"
        "prod = TopicProducer(get_broker(uri), 'OryxUpdate')\n"
        "Pub(cfg).publish_model(art, str(path), prod)\n"
        "print('PUBLISHED')\n"
    ) % (str(ROOT), bus, str(model_root / "12345"))
    r = subprocess.run(
        [sys.executable, "-c", pub], capture_output=True, text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "PUBLISHED" in r.stdout
    shutil.rmtree(model_root)  # a different host: the dir is unreachable

    from oryx_tpu_torch.apps.kmeans.serving import KMeansServingModelManager
    from oryx_tpu_torch.bus import ConsumeDataIterator, get_broker

    mgr = KMeansServingModelManager(_kmeans_config(), device="cpu")
    with ConsumeDataIterator(get_broker(f"file://{bus}"), "OryxUpdate",
                             group="s", start="earliest") as it:
        msgs = it.poll_available()
    assert any(km.key == "MODEL-REF" for km in msgs)
    assert any(km.key == CHUNK_KEY for km in msgs)
    mgr.consume(iter(msgs))
    assert mgr.model is not None
    assert mgr.model.centers.shape == (3, 2048)
    np.testing.assert_array_equal(np.asarray(mgr.model.counts),
                                  np.array([4, 5, 6]))


def test_cache_stable_across_restarts_and_capped(tmp_path, monkeypatch):
    """Replay on restart overwrites the same cache paths (no growth), and
    the cache is LRU-capped so history can't accrete."""
    art = _sample_artifact()
    prod = _CaptureProducer()
    refs = [str(tmp_path / f"gen-{g}") for g in range(3)]
    for ref in refs:
        publish_model_ref(prod, art.to_string(), ref, max_message_size=4096)
    chunk_msgs = [m for k, m in prod.sent if k == CHUNK_KEY]

    r1 = _relay(tmp_path, "cache-root")
    for m in chunk_msgs:
        r1.offer(m)
    dests1 = {ref: r1.resolve(ref) for ref in refs}
    # a "restarted" process replays the same history: same dests, nothing
    # new on disk
    r2 = _relay(tmp_path, "cache-root")
    for m in chunk_msgs:
        r2.offer(m)
    for ref in refs:
        assert r2.resolve(ref) == dests1[ref]
    root = Path(dests1[refs[0]]).parent
    entries = [p for p in root.iterdir() if not p.name.startswith(".")]
    assert len(entries) == len(refs)
    # LRU cap: with MAX_CACHED=2, materializing 3 refs keeps the newest two
    monkeypatch.setattr(ArtifactRelay, "MAX_CACHED", 2)
    r3 = _relay(tmp_path, "cache-root")
    for m in chunk_msgs:
        r3.offer(m)
    with pytest.raises(OSError):
        r3.resolve(refs[0])  # evicted
    assert r3.resolve(refs[2])  # newest survives


def test_cache_eviction_ranks_tied_stamps_by_use(tmp_path, monkeypatch):
    """Two cache dirs whose stamps tie (a coarse file-system clock touched
    both within one tick) still rank by use: a resolve stamps its dir
    strictly above every stamp under the root, so the dir used last
    survives the next eviction even while the clock has not left that
    tick."""
    art = _sample_artifact()
    prod = _CaptureProducer()
    refs = [str(tmp_path / f"gen-{g}") for g in range(3)]
    for ref in refs:
        publish_model_ref(prod, art.to_string(), ref, max_message_size=4096)
    chunks: dict[str, list[str]] = {}
    for k, m in prod.sent:
        if k == CHUNK_KEY:
            chunks.setdefault(json.loads(m)["ref"], []).append(m)
    monkeypatch.setattr(ArtifactRelay, "MAX_CACHED", 2)
    relay = _relay(tmp_path)
    for m in chunks[refs[0]] + chunks[refs[1]]:
        relay.offer(m)
    dirs = [Path(relay.resolve(ref)) for ref in refs[:2]]
    # both dirs carry the same stamp, and the clock the stamp reads is
    # pinned to that tick
    tick = time.time_ns() + 60 * 10**9
    for d in dirs:
        os.utime(d, ns=(tick, tick))
    monkeypatch.setattr(time, "time_ns", lambda: tick)
    relay.resolve(refs[0])  # the older dir is used again
    for m in chunks[refs[2]]:
        relay.offer(m)
    assert relay.resolve(refs[0]) == str(dirs[0])
    assert relay.resolve(refs[2])
    with pytest.raises(OSError):
        relay.resolve(refs[1])  # the least recently used went


def test_oversized_pending_is_never_self_evicted(tmp_path, monkeypatch):
    """An artifact bigger than the pending cap still assembles — only
    OTHER refs' stale chunks are evicted."""
    monkeypatch.setattr(ArtifactRelay, "MAX_PENDING_BYTES", 1024)
    art = _sample_artifact()  # serialized ~30KB >> 1KB cap
    prod = _CaptureProducer()
    ref = "/nowhere/big-model"
    publish_model_ref(prod, art.to_string(), ref, max_message_size=4096)
    relay = _relay(tmp_path)
    for k, m in prod.sent:
        if k == CHUNK_KEY:
            relay.offer(m)
    loaded = ModelArtifact.read(relay.resolve(ref))
    np.testing.assert_array_equal(
        loaded.tensors["centers"], art.tensors["centers"])


def test_republish_with_new_bytes_restarts_assembly(tmp_path):
    """Same chunk count, new content: the assembly restarts on the new
    sha instead of verifying the mixed stream against the stale one."""
    rng = np.random.default_rng(9)
    ref = str(tmp_path / "gen")
    old = ModelArtifact("kmeans", {}, {}, {"centers": rng.standard_normal((3, 2048)).astype(np.float32)})
    new = ModelArtifact("kmeans", {}, {}, {"centers": rng.standard_normal((3, 2048)).astype(np.float32)})
    p_old, p_new = _CaptureProducer(), _CaptureProducer()
    publish_model_ref(p_old, old.to_string(), ref, max_message_size=4096)
    publish_model_ref(p_new, new.to_string(), ref, max_message_size=4096)
    old_chunks = [m for k, m in p_old.sent if k == CHUNK_KEY]
    new_chunks = [m for k, m in p_new.sent if k == CHUNK_KEY]
    assert len(old_chunks) == len(new_chunks)  # same n: the nasty case
    relay = _relay(tmp_path)
    for m in old_chunks[: len(old_chunks) // 2]:  # publisher died mid-send
        relay.offer(m)
    for m in new_chunks:  # republish, full stream
        relay.offer(m)
    loaded = ModelArtifact.read(relay.resolve(ref))
    np.testing.assert_array_equal(
        loaded.tensors["centers"], new.tensors["centers"])


def test_unresolved_ref_parks_and_redispatches_on_late_arrival(tmp_path):
    """A MODEL-REF that arrives before its chunks exhausts the dispatch
    retries and parks; the materialization fires the parked dispatch."""
    from oryx_tpu_torch.api import _dispatch_update

    prod = _CaptureProducer()
    ref = str(tmp_path / "model" / "777")  # never written: no shared fs
    publish_model_ref(prod, _sample_artifact().to_string(), ref,
                      max_message_size=1024)
    chunks = [m for k, m in prod.sent if k == CHUNK_KEY]
    loaded = []

    def handler(key, message):
        loaded.append(read_artifact_from_update(key, message))

    _dispatch_update(handler, KeyMessage("MODEL-REF", ref))
    assert loaded == []
    for m in chunks:
        _dispatch_update(handler, KeyMessage(CHUNK_KEY, m))
    assert len(loaded) == 1
    assert loaded[0].extensions["k"] == "3"


def test_resolve_rechecks_existence_after_sibling_eviction(tmp_path):
    """A sibling's eviction of a cache dir surfaces as the retry class
    (FileNotFoundError), never a dead path."""
    prod = _CaptureProducer()
    ref = str(tmp_path / "m2")
    publish_model_ref(prod, _sample_artifact().to_string(), ref,
                      max_message_size=4096)
    relay = _relay(tmp_path)
    for k, m in prod.sent:
        if k == CHUNK_KEY:
            relay.offer(m)
    cached = Path(relay.resolve(ref))
    shutil.rmtree(cached)  # the sibling process's eviction
    with pytest.raises(FileNotFoundError):
        relay.resolve(ref)


def test_cache_eviction_is_cross_process_lru_by_mtime(tmp_path, monkeypatch):
    """Eviction ranks by shared directory mtimes, so every process
    sharing the root agrees on the LRU order."""
    monkeypatch.setattr(ArtifactRelay, "MAX_CACHED", 3)
    relay = _relay(tmp_path)
    paths = []
    for i in range(5):
        ref = str(tmp_path / f"gen-{i}")
        relay._materialize(ref, _kmeans_blob(str(i)))
        p = relay._dest(ref)
        os.utime(p, (1000 + i, 1000 + i))  # deterministic LRU order
        paths.append(p)
    relay._evict_cache_dirs(keep=paths[-1])
    assert [p.exists() for p in paths] == [False, False, True, True, True]


def test_pinned_refs_survive_eviction_until_unpinned(tmp_path, monkeypatch):
    """A pinned ref is exempt from LRU eviction; pins are refcounted."""
    monkeypatch.setattr(ArtifactRelay, "MAX_CACHED", 2)
    relay = _relay(tmp_path)
    pinned_ref = str(tmp_path / "gen-0")
    relay._materialize(pinned_ref, _kmeans_blob("0"))
    os.utime(relay._dest(pinned_ref), (1000, 1000))  # oldest = first victim
    relay.pin(pinned_ref)
    relay.pin(pinned_ref)  # a second holder
    newer = []
    for i in range(1, 5):
        ref = str(tmp_path / f"gen-{i}")
        relay._materialize(ref, _kmeans_blob(str(i)))
        os.utime(relay._dest(ref), (1000 + i, 1000 + i))
        newer.append(ref)
    relay._evict_cache_dirs(keep=relay._dest(newer[-1]))
    assert Path(relay.resolve(pinned_ref)).exists()

    def _pressure(start: int) -> None:
        os.utime(relay._dest(pinned_ref), (1000, 1000))
        for i in range(start, start + 3):
            r = str(tmp_path / f"gen-{i}")
            relay._materialize(r, _kmeans_blob(str(i)))
            newer.append(r)

    relay.unpin(pinned_ref)
    _pressure(5)
    assert Path(relay.resolve(pinned_ref)).exists()  # one holder remains
    relay.unpin(pinned_ref)
    _pressure(8)
    with pytest.raises(OSError):
        relay.resolve(pinned_ref)


# ---- the relay across the two packages --------------------------------------


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_chunks_cross_packages(tmp_path, publisher):
    """Chunks one package's publish_model_ref wrote assemble in the other
    package's relay into the same artifact, and both packages publish the
    same chunk stream."""
    art = _sample_artifact()
    ref = str(tmp_path / "never-written")
    jprod, pprod = _CaptureProducer(), _CaptureProducer()
    jartifact.publish_model_ref(jprod, art.to_string(), ref,
                                max_message_size=1024)
    publish_model_ref(pprod, art.to_string(), ref, max_message_size=1024)
    assert jprod.sent == pprod.sent
    sent = jprod.sent if publisher == "jax" else pprod.sent
    consumer = (artifact_mod.artifact_relay() if publisher == "jax"
                else jartifact.artifact_relay())
    for k, m in sent:
        if k == CHUNK_KEY:
            consumer.offer(m)
    mod = artifact_mod if publisher == "jax" else jartifact
    loaded = mod.ModelArtifact.read(consumer.resolve(ref))
    np.testing.assert_array_equal(
        loaded.tensors["centers"], art.tensors["centers"])
    assert loaded.content["counts"] == [4, 5, 6]


@pytest.mark.parametrize("materializer", ["jax", "port"])
def test_cache_dir_adopted_across_packages(tmp_path, monkeypatch, materializer):
    """Both packages' relays on one cache root: a stream one package
    materialized (with its relay.json sha marker) is adopted by the other
    without decoding — its chunks are not even base64-decoded."""
    art = _sample_artifact()
    ref = str(tmp_path / "never-written")
    prod = _CaptureProducer()
    publish_model_ref(prod, art.to_string(), ref, max_message_size=1024)
    chunks = [m for k, m in prod.sent if k == CHUNK_KEY]
    root = tmp_path / "shared-root"
    root.mkdir()
    port_relay = ArtifactRelay(root)
    jax_relay = jartifact.ArtifactRelay()
    jax_relay._cache_root = root
    first, second = ((jax_relay, port_relay) if materializer == "jax"
                     else (port_relay, jax_relay))
    for m in chunks:
        first.offer(m)
    dest = Path(first.resolve(ref))
    marker = json.loads((dest / RELAY_META_FILENAME).read_text())
    assert marker["sha"] == json.loads(chunks[0])["sha"]

    # the adopting side must not decode a byte: break its base64 decoder
    mod = jartifact if second is jax_relay else artifact_mod
    monkeypatch.setattr(mod.base64, "b64decode", _no_decode)
    for m in chunks:
        second.offer(m)
    assert second.resolve(ref) == str(dest)
    loaded = ModelArtifact.read(second.resolve(ref))
    np.testing.assert_array_equal(
        loaded.tensors["centers"], art.tensors["centers"])


def _no_decode(*_a, **_k):
    raise AssertionError("adopting relay decoded a chunk")


def test_parked_model_ref_stamp_is_held_for_its_late_load(tmp_path):
    """The parked-load handshake, as the JAX package's: a MODEL-REF parked
    for its late chunks, then its TRACE stamp, then the chunks — the held
    stamp is claimed by that model's re-dispatched load, so the generation
    and its update-to-serve lag are still observed."""
    from oryx_tpu_torch.api import _dispatch_update
    from oryx_tpu_torch.common import freshness

    tracker = freshness.ModelFreshness()
    prod = _CaptureProducer()
    ref = str(tmp_path / "model" / "4242")
    publish_model_ref(prod, _sample_artifact().to_string(), ref,
                      max_message_size=1024)
    chunks = [m for k, m in prod.sent if k == CHUNK_KEY]
    loaded = []
    old = freshness._instance
    freshness._instance = tracker
    try:
        _dispatch_update(lambda k, m: loaded.append(
            read_artifact_from_update(k, m)), KeyMessage("MODEL-REF", ref))
        _dispatch_update(lambda k, m: None, KeyMessage(
            "TRACE", publish_stamp(generation=4242)))
        assert loaded == [] and tracker.generation is None
        for m in chunks:
            _dispatch_update(lambda k, m: loaded.append(
                read_artifact_from_update(k, m)), KeyMessage(CHUNK_KEY, m))
    finally:
        freshness._instance = old
    assert len(loaded) == 1
    assert tracker.generation == 4242


# ---- the model gate: the JAX package's contracts ----------------------------


class _Handler:
    """Records every (key, message) the gate delivers."""

    def __init__(self):
        self.loads: list[tuple[str, str]] = []

    def __call__(self, key, message):
        self.loads.append((key, message))


def _gate(mode: str, history: int = 4, pkg: str = "port"):
    overlay = {
        "oryx.serving.model-gate.mode": mode,
        "oryx.serving.model-gate.history": history,
    }
    if pkg == "jax":
        g = jmodelgate.ModelGate()
        g.configure(jax_load_config(overlay=overlay))
    else:
        g = ModelGate()
        g.configure(load_config(overlay=overlay))
    return g


def _offer_generation(gate, handler, gen: int, message: str | None = None):
    """Publish order on the update topic: MODEL, then its TRACE stamp."""
    msg = message if message is not None else f"model-gen-{gen}"
    assert gate.offer(handler, KeyMessage("MODEL", msg))
    return gate.offer(handler, KeyMessage("TRACE", publish_stamp(generation=gen)))


def test_off_gate_is_never_consulted():
    assert not _gate("off").active


def test_configure_rejects_unknown_mode():
    with pytest.raises(ValueError):
        _gate("blue-green")


def test_unarmed_hold_gate_adopts_bootstrap_replay():
    g, h = _gate("hold"), _Handler()
    assert _offer_generation(g, h, 1)
    assert h.loads == [("MODEL", "model-gen-1")]
    assert g.healthz_section()["generations"] == [1]
    assert g.watermark is None  # adoption does not arm the gate


def test_armed_hold_gate_parks_newer_generation_until_approved():
    g, h = _gate("hold"), _Handler()
    _offer_generation(g, h, 1)
    g.approve(1)  # arm the gate at the incumbent
    assert _offer_generation(g, h, 2)
    assert h.loads == [("MODEL", "model-gen-1")]  # 2 parked: nothing loaded
    hz = g.healthz_section()
    assert hz["pending_generation"] == 2
    assert hz["watermark"] == 1
    res = g.approve(2)
    assert res["adopted"] is True
    assert h.loads[-1] == ("MODEL", "model-gen-2")
    assert g.healthz_section()["generations"] == [1, 2]


def test_held_generation_latest_wins():
    g, h = _gate("hold"), _Handler()
    _offer_generation(g, h, 1)
    g.approve(1)
    _offer_generation(g, h, 2)
    _offer_generation(g, h, 3)
    assert g.healthz_section()["pending_generation"] == 3
    g.approve(3)
    assert [m for _, m in h.loads] == ["model-gen-1", "model-gen-3"]


def test_canary_rollback_is_pointer_swap_and_vetoes():
    g, h = _gate("canary"), _Handler()
    _offer_generation(g, h, 1)
    _offer_generation(g, h, 2)  # canary adopts immediately
    assert [m for _, m in h.loads] == ["model-gen-1", "model-gen-2"]
    res = g.rollback("quality gate refused promotion")
    assert res["rolled_back_to"] == 1 and res["vetoed"] == 2
    assert h.loads[-1] == ("MODEL", "model-gen-1")
    hz = g.healthz_section()
    assert hz["generations"] == [1]
    assert hz["vetoed"] == [2]
    before = len(h.loads)
    assert _offer_generation(g, h, 2)  # replay cannot re-adopt it
    assert len(h.loads) == before
    with pytest.raises(ModelGateError):
        g.rollback("again")


def test_rollback_lowers_watermark_below_vetoed_generation():
    g, h = _gate("hold"), _Handler()
    _offer_generation(g, h, 1)
    g.approve(1)
    _offer_generation(g, h, 2)
    g.approve(2)
    g.rollback("bad promote")
    assert g.watermark == 1


def test_unparseable_stamp_adopts_like_ungated_path():
    g, h = _gate("hold"), _Handler()
    assert g.offer(h, KeyMessage("MODEL", "model-x"))
    assert not g.offer(h, KeyMessage("TRACE", "not json"))
    assert h.loads == [("MODEL", "model-x")]


def test_gate_ignores_non_model_keys():
    g, h = _gate("hold"), _Handler()
    assert not g.offer(h, KeyMessage("UP", "some update"))
    assert h.loads == []


def test_serving_layer_configures_gate_before_replay(monkeypatch, tmp_path):
    """The port's ServingLayer configures the gate before its update
    listener replays the topic: with the app constructor slowed, a canary
    replica still adopts its incumbent THROUGH the gate."""
    import oryx_tpu_torch.common.qualitystats as qualitystats
    from oryx_tpu_torch.api import ServingModelManager, _dispatch_update
    from oryx_tpu_torch.bus import get_broker
    from oryx_tpu_torch.common.modelgate import get_model_gate
    from oryx_tpu_torch.serving.server import ServingLayer

    monkeypatch.setattr(modelgate, "_instance", None)  # fresh gate
    bus = "mem://port-gate-order"
    broker = get_broker(bus)
    for t in ("OryxInput", "OryxUpdate"):
        if not broker.topic_exists(t):
            broker.create_topic(t, 1)
    broker.send("OryxUpdate", "MODEL", json.dumps({"gen": 1}))
    broker.send("OryxUpdate", "TRACE", publish_stamp(generation=1))
    real_configure = qualitystats.configure_qualitystats

    def slow_configure(config):
        time.sleep(0.3)
        return real_configure(config)

    monkeypatch.setattr(qualitystats, "configure_qualitystats", slow_configure)

    class _Mgr(ServingModelManager):
        def __init__(self, config):
            super().__init__(config)
            self.mode_at_replay: str | None = None
            self.saw_model = threading.Event()

        def consume(self, updates):
            self.mode_at_replay = get_model_gate().mode
            for km in updates:
                _dispatch_update(self._on, km)

        def _on(self, key, message):
            if key == "MODEL":
                self.saw_model.set()

        def get_model(self):
            return None

    cfg = load_config(overlay={
        "oryx.input-topic.broker": bus,
        "oryx.update-topic.broker": bus,
        "oryx.serving.api.port": 0,
        "oryx.serving.api.read-only": True,
        "oryx.serving.model-gate.mode": "canary",
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common",
        ],
    })
    mgr = _Mgr(cfg)
    with ServingLayer(cfg, model_manager=mgr):
        assert mgr.saw_model.wait(10.0), "incumbent never replayed"
        assert mgr.mode_at_replay == "canary"
        assert get_model_gate().healthz_section()["generations"] == [1]
    monkeypatch.setattr(modelgate, "_instance", None)


def test_model_ref_adoptions_pin_and_rollback_unpins(monkeypatch):
    """MODEL-REF history entries pin their relay cache dirs; rolling a
    generation out unpins it, and history overflow unpins the oldest."""
    import oryx_tpu_torch.api as api

    class _Relay:
        def __init__(self):
            self.pins: list[str] = []
            self.unpins: list[str] = []

        def pin(self, ref):
            self.pins.append(ref)

        def unpin(self, ref):
            self.unpins.append(ref)

    relay = _Relay()
    monkeypatch.setattr(artifact_mod, "artifact_relay", lambda: relay)
    monkeypatch.setattr(
        api, "_dispatch_model", lambda handler, km: handler(km.key, km.message))
    g, h = _gate("canary", history=2), _Handler()
    for gen in (1, 2):
        assert g.offer(h, KeyMessage("MODEL-REF", f"/models/gen-{gen}"))
        assert g.offer(h, KeyMessage("TRACE", publish_stamp(generation=gen)))
    assert relay.pins == ["/models/gen-1", "/models/gen-2"]
    g.rollback("bad")
    assert relay.unpins == ["/models/gen-2"]
    for gen in (3, 4):
        assert g.offer(h, KeyMessage("MODEL-REF", f"/models/gen-{gen}"))
        assert g.offer(h, KeyMessage("TRACE", publish_stamp(generation=gen)))
    assert "/models/gen-1" in relay.unpins


# ---- the gate in both packages on one message sequence ----------------------


def _gate_script(pkg: str, mode: str, stamps: dict) -> list:
    """One message sequence through a gate: bootstrap, arm, a held
    generation superseded by a newer one, a vetoed replay, approve,
    rollback; every decision and healthz_section along the way. The
    stamps are the same messages for both packages."""
    g, h = _gate(mode, history=3, pkg=pkg), _Handler()
    km = JKeyMessage if pkg == "jax" else KeyMessage
    trace = []

    def stamp(generation):
        return stamps[generation]

    def step(what, fn):
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 - the error is the decision
            out = f"{type(e).__name__}: {e}"
        trace.append((what, out, list(h.loads), g.healthz_section(),
                      g.watermark))

    def offer(key, msg):
        step(f"{key} {msg}", lambda: g.offer(h, km(key, msg)))

    offer("MODEL", "m1")
    offer("TRACE", stamp(generation=1))
    step("approve 1", lambda: g.approve(1))
    offer("MODEL-REF", "/models/2")
    offer("TRACE", stamp(generation=2))
    offer("MODEL", "m3")
    offer("TRACE", stamp(generation=3))
    offer("MODEL", "m-unstamped")
    offer("MODEL", "m4")
    offer("TRACE", stamp(generation=4))
    step("approve 4", lambda: g.approve(4))
    step("rollback", lambda: g.rollback("bad"))
    offer("MODEL", "m4-replay")
    offer("TRACE", stamp(generation=4))
    step("rollback again", lambda: g.rollback())
    step("rollback again", lambda: g.rollback())
    offer("TRACE", "not json")
    offer("UP", "row")
    return trace


@pytest.mark.parametrize("mode", ["hold", "canary", "off"])
def test_gate_decisions_equal_the_jax_package(monkeypatch, mode):
    """Same messages, approve and rollback in both packages: the same
    consumed/passed decisions, the same deliveries, the same
    healthz_section and watermark at every step."""
    for mod in (jartifact, artifact_mod):
        monkeypatch.setattr(mod, "artifact_relay", lambda: _NoRelay())
    import oryx_tpu.api as japi
    import oryx_tpu_torch.api as papi

    for mod in (japi, papi):
        monkeypatch.setattr(
            mod, "_dispatch_model",
            lambda handler, km: handler(km.key, km.message))
    stamps = {g: publish_stamp(generation=g) for g in (1, 2, 3, 4)}
    jax_trace = _gate_script("jax", mode, stamps)
    port_trace = _gate_script("port", mode, stamps)
    assert len(jax_trace) == len(port_trace) == 18
    for j, p in zip(jax_trace, port_trace):
        assert j == p
    if mode == "hold":
        # the held generation 2 was superseded by 3, then 4; approve
        # adopted 4, rollback vetoed it
        assert jax_trace[11][3]["vetoed"] == [4]


class _NoRelay:
    def pin(self, ref):
        pass

    def unpin(self, ref):
        pass


def test_healthz_section_does_not_wait_for_a_delivery(monkeypatch):
    """An approve delivers its model under the gate's lock; healthz_section
    answers from the last snapshot meanwhile instead of waiting."""
    import oryx_tpu_torch.api as api

    release, entered = threading.Event(), threading.Event()

    def slow_dispatch(handler, km):
        entered.set()
        release.wait(10)
        handler(km.key, km.message)

    monkeypatch.setattr(api, "_dispatch_model", slow_dispatch)
    g, h = _gate("hold"), _Handler()
    monkeypatch.setattr(api, "_dispatch_model",
                        lambda handler, km: handler(km.key, km.message))
    _offer_generation(g, h, 1)
    g.approve(1)
    _offer_generation(g, h, 2)
    monkeypatch.setattr(api, "_dispatch_model", slow_dispatch)
    t = threading.Thread(target=g.approve, args=(2,))
    t.start()
    try:
        assert entered.wait(10)
        t0 = time.monotonic()
        hz = g.healthz_section()
        assert time.monotonic() - t0 < 0.5
        assert hz["pending_generation"] == 2 and hz["generations"] == [1]
    finally:
        release.set()
        t.join(10)
    assert not t.is_alive()
    assert g.healthz_section()["generations"] == [1, 2]


# ---- the control routes on the port's serving layer --------------------------


def _request(port, method, path, body=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        c.request(method, path, body=body,
                  headers={"Accept": "application/json"})
        r = c.getresponse()
        return r.status, r.read()
    finally:
        c.close()


def _als_artifact(tmp_path, gen: int, n_items: int = 300):
    # a new feature count per generation: each load builds a new model
    # and its view on the delivering thread (the same rank would keep the
    # state and resync its rows in the background)
    features = 6 + gen
    rng = np.random.default_rng(gen)
    art = ModelArtifact(
        "als",
        extensions={"features": str(features), "implicit": "true"},
        tensors={
            "X": rng.standard_normal((40, features)).astype(np.float32),
            "Y": rng.standard_normal((n_items, features)).astype(np.float32),
        },
    )
    art.set_extension("XIDs", [f"u{j}" for j in range(40)])
    art.set_extension("YIDs", [f"i{j}" for j in range(n_items)])
    path = tmp_path / f"model-{gen}"
    art.write(path)
    return str(path)


@pytest.fixture()
def gated_layer(monkeypatch, tmp_path):
    """The port's ALS ServingLayer (CPU manager) with the gate in hold
    mode and generations 1 (adopted, armed) and 2 (held) published."""
    from oryx_tpu_torch.apps.als.serving import ALSServingModelManager
    from oryx_tpu_torch.apps.spi import app_overlay
    from oryx_tpu_torch.bus import get_broker
    from oryx_tpu_torch.serving.server import ServingLayer

    monkeypatch.setattr(modelgate, "_instance", None)
    bus = f"mem://port-gate-routes-{time.monotonic_ns()}"
    broker = get_broker(bus)
    for t in ("OryxInput", "OryxUpdate"):
        broker.create_topic(t, 1)
    overlay = dict(app_overlay("als"))
    overlay.update({
        "oryx.input-topic.broker": bus, "oryx.update-topic.broker": bus,
        "oryx.serving.api.port": 0,
        "oryx.serving.model-gate.mode": "hold",
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
    })
    cfg = load_config(overlay=overlay)
    layer = ServingLayer(cfg, model_manager=ALSServingModelManager(
        cfg, device="cpu"))
    layer.start()
    try:
        broker.send("OryxUpdate", "MODEL-REF", _als_artifact(tmp_path, 1))
        broker.send("OryxUpdate", "TRACE", publish_stamp(generation=1))
        _until(lambda: _request(layer.port, "GET", "/ready")[0] == 200)
        assert _request(layer.port, "POST", "/control/model/approve",
                        b'{"generation": 1}')[0] == 200
        broker.send("OryxUpdate", "MODEL-REF", _als_artifact(tmp_path, 2))
        broker.send("OryxUpdate", "TRACE", publish_stamp(generation=2))
        _until(lambda: json.loads(_request(layer.port, "GET", "/healthz")[1])
               .get("model_gate", {}).get("pending_generation") == 2)
        yield layer
    finally:
        layer.close()
        monkeypatch.setattr(modelgate, "_instance", None)


def _until(cond, timeout_s: float = 30.0) -> None:
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise TimeoutError("condition never held")


def test_control_routes_approve_and_rollback(gated_layer):
    port = gated_layer.port
    assert _request(port, "POST", "/control/model/approve", b"{}")[0] == 400
    status, body = _request(port, "POST", "/control/model/approve",
                            b'{"generation": 2}')
    assert status == 200
    assert json.loads(body) == {"watermark": 2, "adopted": True,
                                "generation": 2}
    hz = json.loads(_request(port, "GET", "/healthz")[1])
    assert hz["model_gate"]["generations"] == [1, 2]
    assert hz["model_generation"] == 2
    status, body = _request(port, "POST", "/control/model/rollback",
                            b'{"reason": "test"}')
    assert status == 200
    assert json.loads(body) == {"rolled_back_to": 1, "vetoed": 2,
                                "reason": "test"}
    hz = json.loads(_request(port, "GET", "/healthz")[1])
    assert hz["model_gate"]["vetoed"] == [2]
    assert hz["model_generation"] == 1
    # nothing left to roll back to
    assert _request(port, "POST", "/control/model/rollback")[0] == 409


def test_ready_answers_while_approve_builds_the_view(gated_layer, monkeypatch):
    """The approve handler builds the new model's view (about a second on
    the card at 1M x 50; stretched here to 2 s). The async frontend runs
    it on its worker pool, so /ready and /healthz keep answering on the
    event loop meanwhile."""
    from oryx_tpu_torch.apps.als import serving as als_serving

    real, building = als_serving.ALSServingModel.build_views, threading.Event()

    def slow_build(self):
        building.set()
        time.sleep(2.0)
        real(self)

    monkeypatch.setattr(als_serving.ALSServingModel, "build_views", slow_build)
    port = gated_layer.port
    out = {}
    t = threading.Thread(target=lambda: out.update(approve=_request(
        port, "POST", "/control/model/approve", b'{"generation": 2}')))
    t.start()
    try:
        assert building.wait(10)
        for path in ("/ready", "/healthz"):
            t0 = time.monotonic()
            status, _ = _request(port, "GET", path)
            assert status == 200
            assert time.monotonic() - t0 < 1.0, path
        assert t.is_alive()  # the build was still running
    finally:
        t.join(30)
    assert not t.is_alive()
    assert out["approve"][0] == 200


def test_control_routes_409_while_the_gate_is_off(monkeypatch, tmp_path):
    from oryx_tpu_torch.serving.app import Request, ServingApp

    monkeypatch.setattr(modelgate, "_instance", None)
    cfg = load_config(overlay={
        "oryx.monitoring.flight.dir": str(tmp_path / "flight"),
        "oryx.serving.application-resources": [
            "oryx_tpu_torch.serving.resources.common"],
    })
    app = ServingApp(cfg, None, input_producer=None)
    for path, body in (("/control/model/approve", b'{"generation": 3}'),
                       ("/control/model/rollback", b"")):
        status, _body, _ = app.dispatch(
            Request("POST", path, {}, {}, body, {}))
        assert status == 409, path
    monkeypatch.setattr(modelgate, "_instance", None)
