"""Fault tolerance of the training loop and the session pools' shards.

  ft       — NaN/inf sentinel with rollback to the last good checkpoint (the
             poisoned batch skipped), straggler monitor, resume from the
             latest checkpoint, counters in an `obs.MetricsRegistry`;
             `elastic_restore` places a checkpoint on another mesh
  sharding — the session pools' slot placement: `fleet_mesh`, `slot_pspec`,
             `pool_shardings`, the `Sharded` leaf, `shard` / `gather`

The LM model-sharding vocabulary of the JAX package (`logical_to_physical`,
`named_sharding`, `shard_constraint`, `use_mesh`) waits for ROADMAP Queue 1
item 8c.
"""
from repro_torch.distributed import ft, sharding
from repro_torch.distributed.ft import (FaultTolerantRunner,
                                        StragglerMonitor, elastic_restore,
                                        loss_is_bad)
from repro_torch.distributed.sharding import (FleetMesh, Sharded,
                                              SlotSharding, fleet_mesh,
                                              pool_shardings, slot_pspec)

__all__ = ["ft", "sharding", "FaultTolerantRunner", "StragglerMonitor",
           "elastic_restore", "loss_is_bad", "FleetMesh", "Sharded",
           "SlotSharding", "fleet_mesh", "pool_shardings", "slot_pspec"]
