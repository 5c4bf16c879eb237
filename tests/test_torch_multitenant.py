"""Multi-tenant batch on the port: concurrent model builds sharing one
device (BASELINE.json configs[4] — "ALS + RDF concurrent model-builds"),
the contract of tests/test_multitenant.py on port objects, on the CPU
(the card case is in tests/test_torch_cuda.py).

The reference runs tenants as separate Spark jobs on a shared YARN
cluster; here tenants share one torch device. Two builds racing from
different threads must both come out correct — no cross-talk through the
RNG manager or the device.
"""

from __future__ import annotations

import threading

import numpy as np


def test_concurrent_als_and_rdf_builds():
    from oryx_tpu_torch.ml.quality import build_and_evaluate
    from oryx_tpu_torch.ops.rdf import bin_dataset, grow_forest, predict_class_probs

    results: dict = {}
    errors: list = []

    def als_tenant():
        try:
            rep = build_and_evaluate(
                n_users=1500, n_items=900, nnz=80_000, features=16,
                iterations=4, compute_dtype="bfloat16", seed=5,
                sample_users=300, device="cpu",
            )
            results["als"] = rep
        except Exception as e:  # noqa: BLE001
            errors.append(("als", e))

    def rdf_tenant():
        try:
            rng = np.random.default_rng(13)
            X = rng.standard_normal((20_000, 12)).astype(np.float32)
            y = (X[:, 0] + 0.5 * X[:, 1] > 0).astype(np.int32)
            binned = bin_dataset(
                X,
                is_categorical=np.zeros(12, dtype=bool),
                category_counts=np.zeros(12, dtype=np.int32),
                max_split_candidates=16,
            )
            forest = grow_forest(
                binned, y, num_trees=6, max_depth=6,
                impurity="entropy", n_classes=2, device="cpu",
            )
            pred = predict_class_probs(forest, binned.binned)
            acc = float((np.asarray(pred).argmax(-1) == y).mean())
            results["rdf_acc"] = acc
        except Exception as e:  # noqa: BLE001
            errors.append(("rdf", e))

    threads = [
        threading.Thread(target=als_tenant, name="tenant-als"),
        threading.Thread(target=rdf_tenant, name="tenant-rdf"),
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not errors, errors
    assert results["als"].nan_rows == 0
    assert results["als"].auc > 0.70
    assert results["rdf_acc"] > 0.85
