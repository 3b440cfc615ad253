"""Fleet orchestration layer: event-driven global scheduling across
replicas (lockstep virtual time), dynamic routing, cross-replica
relegation offload and queued-prefill migration. See docs/fleet.md."""
from repro_torch.serving.fleet.controller import FleetController
from repro_torch.serving.fleet.router import Router, offline_jsq
from repro_torch.serving.fleet.telemetry import (FleetReport, MigrationEvent,
                                                 ReplicaSnapshot, snapshot)

__all__ = [
    "FleetController", "Router", "offline_jsq",
    "FleetReport", "MigrationEvent", "ReplicaSnapshot", "snapshot",
]
