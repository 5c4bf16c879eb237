"""Self-describing model artifact: JSON metadata plus optional npz tensor
payloads (the port's copy of ``ModelArtifact`` and
``read_artifact_from_update`` from oryx_tpu/common/artifact.py).

It reads what the JAX package's ``ModelArtifact.write`` / ``to_string``
produce, so the artifact is the weight interchange between the two
packages. Layout on disk (a directory):
    <dir>/model.json      {"app":..., "extensions":{...}, "content":{...}}
    <dir>/tensors.npz     optional named ndarray payloads

The bus-chunked MODEL-REF relay is not ported yet: a MODEL-REF must name a
path readable on this host.
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
