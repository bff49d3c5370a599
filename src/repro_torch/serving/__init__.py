"""Session serving: continuous batching of plastic streams into fixed slots.

A "user" of FireFly-P's Phase-2 controllers is not a request but a
long-lived plastic STATE that outlives any single residency on the card:

  * `sessions.SessionStore`   — owns per-user plastic state: an LRU warm
    cache over durable `checkpoint.manager` persistence (the JAX package's
    on-disk layout).  Evict -> restore is bit-identical.
  * `scheduler.FleetScheduler` — admits/evicts sessions into a fixed-shape
    ``(B, N, M)`` slot pool with in-place row copies, and steps the whole
    pool through the fleet-step or rollout kernels in one launch, with
    optional in-band telemetry.
"""
from repro_torch.serving.scheduler import (SHARED, FleetScheduler,
                                           SessionPool, make_slot_ops,
                                           slot_put, slot_take, uniform_axes)
from repro_torch.serving.sessions import SessionStore

__all__ = ["FleetScheduler", "SHARED", "SessionPool", "SessionStore",
           "make_slot_ops", "slot_put", "slot_take", "uniform_axes"]
