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
  * `lm.LMScheduler`          — the same for plastic LM streams: a pool of
    decode slots (backbone cache, per-slot position, adapter state, pending
    token) stepped a token or a K-token window at a time; `lm.AdapterPool`
    holds only the adapter rows of the lockstep serve loop.
"""
from repro_torch.serving.scheduler import (SHARED, FleetScheduler,
                                           SessionPool, make_slot_ops,
                                           slot_put, slot_take, uniform_axes)
from repro_torch.serving.lm import AdapterPool, LMScheduler
from repro_torch.serving.sessions import SessionStore

__all__ = ["AdapterPool", "FleetScheduler", "LMScheduler", "SHARED",
           "SessionPool", "SessionStore", "make_slot_ops", "slot_put",
           "slot_take", "uniform_axes"]
