"""The port's twin of ``__graft_entry__.dryrun_multichip``: every
multi-device path of the port, on tiny shapes, over a mesh of
``n_devices`` cells.

The JAX package's dry run re-executes itself on n virtual CPU devices. The
port's mesh entries may repeat, so its n cells lie on one device: the card
(the default) or the CPU (``device="cpu"``). The legs run in the JAX
package's order:

1. the mesh ALS step (the data-parallel trainer over every cell) and the
   tensor-parallel trainer (X over "data", Y over "model");
2. sharded serving: a bf16 and an int8 view row-sharded over the cells,
   bit-identical to the unsharded answers (the partial kernel per shard
   and one cross-shard merge on the card);
3. the speed layer's fold-in batch;
4. ring and Ulysses attention with the sequence over "data", held to the
   exact attention;
5. the partitioned candidate search: two ALS candidates on disjoint
   sub-meshes, publishing the serial search's winner;
6. the chunked MODEL-REF relay: an oversized artifact rides the update
   topic as chunks, and a relay with no path access rebuilds it;
7. the row-sharded bucketed trainer over a model-axis mesh.

    python -m oryx_tpu_torch.dryrun 4 [--cpu]
"""

from __future__ import annotations

import json
import tempfile

import numpy as np
import torch

# attention against the exact version (f32, TF32 off; the ring sums in
# another order)
ATTENTION_TOL = 2e-5


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run every leg on a mesh of ``n_devices`` cells over ``device`` (the
    card unless the caller names the CPU); raises AssertionError on a leg
    that disagrees. Returns a summary of each leg."""
    from oryx_tpu_torch.device import resolve_device
    from oryx_tpu_torch.ops.als import (
        aggregate_interactions,
        fold_in_batch,
        topk_dot_batch,
        train_als,
        train_als_tp,
    )
    from oryx_tpu_torch.ops.attention import attention, ring_attention, ulysses_attention
    from oryx_tpu_torch.ops.transfer import (
        QuantizedMatrix,
        quantize_rows_int8,
        sharded_device_put,
        staged_device_put,
    )
    from oryx_tpu_torch.ops.vector import gram
    from oryx_tpu_torch.parallel.mesh import (
        DATA_AXIS,
        MODEL_AXIS,
        MeshSpec,
        make_mesh,
        model_mesh,
    )

    dev = resolve_device(device)
    model_ax = 2 if n_devices % 2 == 0 and n_devices > 1 else 1
    mesh = make_mesh(MeshSpec(data=n_devices // model_ax, model=model_ax),
                     [dev] * n_devices)
    dp, tp = mesh.shape[DATA_AXIS], mesh.shape[MODEL_AXIS]
    out: dict = {"cells": n_devices, "mesh": [dp, tp], "device": str(dev)}

    # 1. the mesh ALS step and the tensor-parallel trainer
    rng = np.random.default_rng(7)
    n_raw = 256
    data = aggregate_interactions(
        rng.integers(0, 32, n_raw).astype(str),
        rng.integers(0, 48, n_raw).astype(str),
        rng.random(n_raw).astype(np.float32) + 0.1,
        implicit=True,
    )
    k = 8
    y0 = (np.random.default_rng(0).standard_normal((data.n_items, k)) * 0.1
          ).astype(np.float32)
    flat = make_mesh(MeshSpec(data=n_devices, model=1), [dev] * n_devices)
    step = train_als(data, features=k, iterations=2, block=8, mesh=flat,
                     resume_y=y0)
    single = train_als(data, features=k, iterations=2, block=8,
                       resume_y=y0, device=dev)
    step_err = float(np.abs(step.x - single.x).max())
    assert step_err < 1e-3, f"mesh ALS step drifted {step_err}"
    tp_model = train_als_tp(data, mesh, features=k, iterations=2, block=8,
                            resume_y=y0)
    assert tp_model.x.shape == (data.n_users, k)
    assert tp_model.y.shape == (data.n_items, k)
    tp_err = float(np.abs(tp_model.x - single.x).max())
    assert tp_err < 1e-3, f"tensor-parallel trainer drifted {tp_err}"
    out["als"] = {"mesh_step_max_err": step_err, "tp_max_err": tp_err}

    # 2. sharded serving, bit-identical to unsharded
    rng2 = np.random.default_rng(23)
    cat = rng2.normal(size=(4096, 32)).astype(np.float32)
    qs = torch.from_numpy(rng2.normal(size=(64, 32)).astype(np.float32)).to(dev)
    v0, i0 = topk_dot_batch(qs, staged_device_put(cat, dtype=torch.bfloat16,
                                                  device=dev), k=10)
    qm, sc = quantize_rows_int8(cat)
    vq0, iq0 = topk_dot_batch(
        qs, QuantizedMatrix(torch.from_numpy(qm).to(dev),
                            torch.from_numpy(sc).to(dev)), k=10)
    shards = (1, 2) if n_devices >= 2 else (1,)
    for s in shards:
        v, i = topk_dot_batch(
            qs, sharded_device_put(cat, s, dtype=torch.bfloat16,
                                   devices=[dev]), k=10)
        assert torch.equal(i.cpu(), i0.cpu()), "sharded idx drift"
        assert torch.equal(v.cpu(), v0.cpu()), "sharded val drift"
        vq, iq = topk_dot_batch(
            qs, sharded_device_put(cat, s, quantize=True, devices=[dev]), k=10)
        assert torch.equal(iq.cpu(), iq0.cpu()), "int8 shard idx drift"
        assert torch.equal(vq.cpu(), vq0.cpu()), "int8 shard value drift"
    out["sharded_serving"] = {"shards": list(shards), "bit_identical": True}

    # 3. the speed layer's fold-in batch
    yt = torch.from_numpy(single.y).to(dev)
    chol = torch.linalg.cholesky(gram(yt) + 0.01 * torch.eye(k, device=dev))
    b = dp * 2
    xu = torch.from_numpy(single.x[:b]).to(dev)
    folded = fold_in_batch(chol, torch.ones(b, device=dev), xu, yt[:b])
    assert torch.isfinite(folded).all(), "fold-in produced non-finite rows"
    out["fold_in"] = {"rows": b}

    # 4. ring and Ulysses attention, the sequence over "data"
    seq = dp * 8
    gen = torch.Generator(device="cpu").manual_seed(0)
    qkv = torch.randn((3, 2, seq, k), generator=gen).to(dev)
    heads = dp * 2
    qkv_h = torch.randn((3, 2, heads, seq, k), generator=gen).to(dev)
    errs = {}
    for causal in (False, True):
        ref = attention(*qkv, causal=causal)
        ring = ring_attention(*qkv, mesh, causal=causal).full()
        ref_h = attention(*qkv_h, causal=causal)
        uly = ulysses_attention(*qkv_h, mesh, causal=causal).full()
        errs[f"ring_causal={causal}"] = float((ring - ref.cpu()).abs().max())
        errs[f"ulysses_causal={causal}"] = float((uly - ref_h.cpu()).abs().max())
    assert max(errs.values()) <= ATTENTION_TOL, errs
    out["attention"] = errs

    # 5. the partitioned candidate search on two sub-meshes
    from oryx_tpu_torch.apps.als.batch import ALSUpdate
    from oryx_tpu_torch.bus.api import KeyMessage, TopicProducer
    from oryx_tpu_torch.bus.inproc import InProcBroker
    from oryx_tpu_torch.common.config import load_config
    from oryx_tpu_torch.common.rng import RandomManager

    with tempfile.TemporaryDirectory() as td:
        cfg = load_config(overlay={
            "oryx.id": "dryrun",
            "oryx.batch.storage.model-dir": f"{td}/m",
            "oryx.ml.eval.candidates": 2,
            "oryx.ml.eval.parallelism": 2,
            "oryx.ml.eval.hyperparam-search": "grid",
            "oryx.ml.eval.test-fraction": 0.2,
            "oryx.als.hyperparams.features": k,
            "oryx.als.hyperparams.iterations": 2,
            "oryx.als.hyperparams.alpha": 10.0,
            "oryx.als.hyperparams.lambda": [0.01, 500.0],
            "oryx.als.no-known-items": True,
        })
        # planted block structure (users of group g like item block g) so
        # the AUC eval cleanly separates the sane lambda from the absurd one
        users = rng.integers(0, 32, 900)
        msgs = [
            KeyMessage(None, f"u{u},i{(u % 3) * 16 + int(rng.integers(0, 16))},1,{j}")
            for j, u in enumerate(users)
        ]
        broker = InProcBroker()
        broker.create_topic("U", partitions=1)
        RandomManager.use_test_seed(99)
        ALSUpdate(cfg, device=dev, mesh=mesh).run_update(
            1000, msgs, [], f"{td}/model", TopicProducer(broker, "U")
        )
        winners = [m for _, key_, m in broker.read("U", 0, 0, 5) if key_ == "MODEL"]
        assert winners, "parallel candidate search published no model"
        lam = json.loads(winners[0])["extensions"]["lambda"]
        assert lam == "0.01", lam
    out["candidate_search"] = {"sub_meshes": 2, "winner_lambda": lam}

    # 6. the chunked MODEL-REF relay
    from oryx_tpu_torch.common.artifact import (
        CHUNK_KEY,
        ArtifactRelay,
        ModelArtifact,
        publish_model_ref,
    )

    class _Capture:
        def __init__(self):
            self.sent = []

        def send(self, key, message):
            self.sent.append((key, message))

    big = ModelArtifact("als", {"features": str(k)},
                        tensors={"Y": np.asarray(single.y[:64])})
    prod = _Capture()
    ref_path = "/nonexistent/dryrun/model/999"  # no shared filesystem
    publish_model_ref(prod, big.to_string(), ref_path, max_message_size=2048)
    chunks = [m for key_, m in prod.sent if key_ == CHUNK_KEY]
    assert len(chunks) > 1, "artifact did not chunk"
    with tempfile.TemporaryDirectory() as td:
        relay = ArtifactRelay(td)
        for m in chunks:
            relay.offer(m)
        loaded = ModelArtifact.read(relay.resolve(ref_path))
    np.testing.assert_array_equal(loaded.tensors["Y"], single.y[:64])
    out["relay"] = {"chunks": len(chunks)}

    # 7. the row-sharded bucketed trainer over a model-axis mesh
    if n_devices >= 2:
        sharded = train_als(data, features=k, iterations=2, resume_y=y0,
                            shard_mesh=model_mesh(2, dev))
        assert sharded.y.shape == (data.n_items, k)
        shard_err = float(np.abs(sharded.y - train_als(
            data, features=k, iterations=2, resume_y=y0, device=dev).y).max())
        assert shard_err < 1e-3, f"row-sharded trainer drifted {shard_err}"
        out["row_sharded_train"] = {"max_err": shard_err}
    return out


if __name__ == "__main__":
    import sys

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    print(json.dumps(dryrun_multichip(n, "cpu" if "--cpu" in sys.argv else None)))
