"""Replica-group policies of the port (counterpart of ``repro/distributed``;
its logical-axis sharding rules serve only the model substrate and are not
ported)."""
from repro_torch.distributed.fault import (Replica, ReplicaFailure, ReplicaRouter,
                                           StragglerMitigator)

__all__ = ["Replica", "ReplicaFailure", "ReplicaRouter", "StragglerMitigator"]
