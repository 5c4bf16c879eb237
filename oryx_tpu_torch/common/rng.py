"""Central RNG management with a process-wide deterministic test switch
(the port's copy of oryx_tpu/common/rng.py).

Mirrors the reference's RandomManager (framework/oryx-common
.../random/RandomManager.java:37-75): production code asks this module for
generators; tests flip `use_test_seed()` once and every random code path in
the process becomes deterministic.

Alongside numpy Generators it hands out ``torch.Generator`` objects on a
given device (the JAX package hands out ``jax.random`` keys there), seeded
the same way: test seed + allocation sequence number, or ``os.urandom``.
"""

from __future__ import annotations

import os
import threading

import numpy as np

_TEST_SEED_ENV = "ORYX_TEST_SEED"
_lock = threading.Lock()


class RandomManager:
    _test_seed: int | None = None
    _generators: list[np.random.Generator] = []
    _key_seq: int = 0

    @classmethod
    def use_test_seed(cls, seed: int | None = None) -> None:
        """Switch the whole process to a fixed seed (reference
        RandomManager.useTestSeed, RandomManager.java:60-75). Existing
        generators handed out earlier are re-seeded in place, and the
        allocation sequence restarts so each call site sees the same stream
        regardless of what previous tests allocated."""
        with _lock:
            cls._test_seed = int(
                seed if seed is not None else os.environ.get(_TEST_SEED_ENV, 1234)
            )
            cls._key_seq = 0
            for i, g in enumerate(cls._generators):
                g.bit_generator.state = np.random.PCG64(cls._test_seed + i).state
            cls._generators = []

    @classmethod
    def clear_test_seed(cls) -> None:
        with _lock:
            cls._test_seed = None

    @classmethod
    def get_random(cls) -> np.random.Generator:
        """A numpy Generator; fixed-seeded iff in test mode. Generators are
        only recorded in test mode (for re-seeding) — a long-running
        production process must not accumulate every generator ever made."""
        with _lock:
            if cls._test_seed is None:
                return np.random.default_rng()
            g = np.random.default_rng(cls._test_seed + len(cls._generators))
            cls._generators.append(g)
            return g

    @classmethod
    def get_generator(cls, device=None):
        """A fresh ``torch.Generator`` on ``device`` (the CPU when None),
        deterministic under the test seed: the counterpart of the JAX
        package's ``get_key``."""
        import torch

        with _lock:
            if cls._test_seed is not None:
                seed = cls._test_seed + cls._key_seq
            else:
                seed = int.from_bytes(os.urandom(4), "little")
            cls._key_seq += 1
        g = torch.Generator(device=device if device is not None else "cpu")
        g.manual_seed(seed)
        return g
