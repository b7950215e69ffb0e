"""Replica-group policies and the logical-axis sharding rules of the port
(counterpart of ``repro/distributed``)."""
from repro_torch.distributed.fault import (Replica, ReplicaFailure, ReplicaRouter,
                                           StragglerMitigator)
from repro_torch.distributed.sharding import (LOGICAL_RULES, batch_axes, logical_to_pspec,
                                              seq_axis)

__all__ = ["Replica", "ReplicaFailure", "ReplicaRouter", "StragglerMitigator",
           "LOGICAL_RULES", "logical_to_pspec", "batch_axes", "seq_axis"]
