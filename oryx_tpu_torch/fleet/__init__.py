"""Replicated serving fleet: supervisor, consistent-hash front, shared
model distribution (the port's copy of oryx_tpu/fleet/).

The single-host serving story scales event loops and replica
processes on one port (``oryx.serving.api.processes``); this package is
the N-hosts story the lambda contract makes natural — serving instances
are stateless consumers of the update topic (PAPER.md), so a fleet is N
independent serving processes behind a thin L7 front:

- :mod:`oryx_tpu_torch.fleet.supervisor` launches and monitors N serving
  replicas on distinct ports with per-replica config overlays.
- :mod:`oryx_tpu_torch.fleet.front` is the router: round-robin or
  consistent-hash-by-user placement, health-driven ejection from the
  replicas' ``GET /healthz`` degraded states, and Retry-After-aware
  retry of shed requests on a different replica.
- :mod:`oryx_tpu_torch.fleet.ring` is the hash ring behind the hash policy.
- :mod:`oryx_tpu_torch.fleet.control` closes the loop: canary rollout with
  quality-gated promotion and pointer-swap rollback, plus SLO-burn
  autoscaling with connection draining on scale-down.

Model distribution is amortized across co-hosted replicas by the shared
artifact relay cache (``common/artifact.py``): MODEL-CHUNK reassembly
happens once per host, measured by
``oryx_fleet_distribution_bytes{mode=shared|per-replica}``.

Every replica is a ``python -m oryx_tpu_torch.cli serving`` process that
opens the CUDA card itself (``oryx.compute.platform = cpu`` puts it on the
CPU instead); the front, the supervisor and the controller open no device.
Sharded replicas (``oryx.fleet.shards > 1``) are config only here: the
port's serving layer refuses ``sync.shard-count > 1`` until sharded views
are ported.
"""

from oryx_tpu_torch.fleet.ring import HashRing
from oryx_tpu_torch.fleet.control import FleetController
from oryx_tpu_torch.fleet.front import FleetFront, ReplicaInfo
from oryx_tpu_torch.fleet.supervisor import FleetSupervisor, replica_overlays

__all__ = [
    "FleetController",
    "FleetFront",
    "FleetSupervisor",
    "HashRing",
    "ReplicaInfo",
    "replica_overlays",
]
