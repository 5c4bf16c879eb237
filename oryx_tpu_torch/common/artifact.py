"""Self-describing model artifact: JSON metadata plus optional npz tensor
payloads (the port's copy of ``ModelArtifact``, ``read_artifact_from_update``
and the publisher side, ``publish_model_ref``, of
oryx_tpu/common/artifact.py).

It reads what the JAX package's ``ModelArtifact.write`` / ``to_string``
produce, and ``to_pmml_xml`` writes the same PMML document, so the
artifact is the weight interchange between the two packages. Layout on
disk (a directory):
    <dir>/model.json      {"app":..., "extensions":{...}, "content":{...}}
    <dir>/tensors.npz     optional named ndarray payloads

The consumer side of the bus-chunked MODEL-REF relay (``ArtifactRelay``,
ROADMAP queue 1 item 3) is not ported yet: the port's consumers skip
``MODEL-CHUNK`` records, and a MODEL-REF must name a path readable on this
host (with the layers on one host it does).
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
    """Decode a MODEL (inline artifact) or MODEL-REF (local path) update
    message (AppPMMLUtils.readPMMLFromUpdateKeyMessage). A MODEL-REF whose
    path is not readable here raises FileNotFoundError."""
    if key == "MODEL":
        return ModelArtifact.from_string(message)
    if key == "MODEL-REF":
        p = Path(strip_scheme(message))
        if not ((p / MODEL_FILENAME).exists() or p.is_file()):
            raise FileNotFoundError(f"MODEL-REF {message} is not readable locally")
        return ModelArtifact.read(p)
    raise ValueError(f"not a model update key: {key}")


# Update-topic key of one chunk of an oversized artifact's bytes.
CHUNK_KEY = "MODEL-CHUNK"


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
