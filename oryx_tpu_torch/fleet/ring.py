"""Consistent-hash ring for the fleet front's hash-by-user policy (the
port's copy of oryx_tpu/fleet/ring.py: same points, same placement).

Classic Karger ring with virtual nodes: each replica owns ``vnodes``
points on a 64-bit circle (blake2b of ``"{node}#{i}"``), and a key maps
to the first point clockwise from its own hash. Adding or removing one
replica therefore remaps only the slice of keys that fall between the
new/old points and their predecessors — about ``1/n`` of the keyspace —
while every other key keeps its replica. That stability is the point:
a fleet resize must not blow every user's request onto a cold replica
(and with it any per-user cache locality) the way ``hash(u) % n`` would.

Deterministic across processes and runs: blake2b, not the salted builtin
``hash`` — the front restarts must route users the same way.
"""

from __future__ import annotations

import bisect
import hashlib


def _point(data: str) -> int:
    """64-bit position on the circle for an arbitrary string."""
    return int.from_bytes(
        hashlib.blake2b(data.encode("utf-8"), digest_size=8).digest(), "big"
    )


class HashRing:
    """Immutable-membership operations on a mutable ring: ``add`` /
    ``remove`` rebuild the sorted point index (cheap at fleet sizes),
    ``lookup`` is O(log points)."""

    def __init__(self, nodes=(), vnodes: int = 64):
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self._nodes: set[str] = set()
        self._points: list[int] = []
        self._owners: list[str] = []
        for n in nodes:
            self.add(n)

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def nodes(self) -> set[str]:
        return set(self._nodes)

    def add(self, node: str) -> None:
        if node in self._nodes:
            return
        self._nodes.add(node)
        self._rebuild()

    def remove(self, node: str) -> None:
        if node not in self._nodes:
            return
        self._nodes.discard(node)
        self._rebuild()

    def _rebuild(self) -> None:
        pairs = sorted(
            (_point(f"{node}#{i}"), node)
            for node in self._nodes
            for i in range(self.vnodes)
        )
        self._points = [p for p, _ in pairs]
        self._owners = [o for _, o in pairs]

    def lookup(self, key: str) -> str | None:
        """The replica owning ``key``, or None on an empty ring."""
        for node in self.lookup_seq(key):
            return node
        return None

    def lookup_seq(self, key: str):
        """Replicas in ring order starting at ``key``'s owner, each
        distinct node once — the front walks this to skip ejected
        replicas, so an ejection remaps ONLY the ejected node's keys
        (each lands on its ring successor) instead of reshuffling the
        whole keyspace."""
        if not self._points:
            return
        i = bisect.bisect_left(self._points, _point(key)) % len(self._points)
        seen: set[str] = set()
        for j in range(len(self._points)):
            owner = self._owners[(i + j) % len(self._points)]
            if owner not in seen:
                seen.add(owner)
                yield owner
