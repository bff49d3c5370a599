"""SessionStore: per-user plastic state with LRU caching + durable restore.

A *session* is one user's learned synaptic memory.  FireFly-P's Phase-2
deployment rewrites it on every step, so it can never be recomputed from
parameters: it is owned, evicted, persisted and restored like any other
first-class resource.  The store is generic over the state tree
(dataclasses, tuples, lists and dicts of tensors): an unbatched
`engine.NetworkState` for an SNN controller.

Ownership model (what the FleetScheduler drives):

    checkout(uid) ──> warm-cache hit (exclusive: removed from the cache)
                 ──> durable restore          (bit-identical resumption)
                 ──> factory()                (brand-new user, zero state)
    checkin(uid, state, step)
                 ──> persist FIRST (write-through), then warm-cache (LRU)

`checkin` is write-through: the session is durable the moment it leaves the
fleet, so the LRU warm cache is a re-admission fast path and drops entries
without I/O.  Persistence rides on `checkpoint.manager`: each session gets
its own directory ``<root>/<uid>/`` in the JAX package's checkpoint layout,
so a session persisted by the JAX package's store restores here bit for bit
(sessions learned under JAX resume on the card).  With ``root=None`` the
store archives to host RAM instead (same API, process-lifetime
durability).
"""
from __future__ import annotations

import os
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.checkpoint.manager import CheckpointManager, latest_step
from repro_torch.obs import MetricsRegistry


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


class SessionStore:
    """Durable per-user plastic state behind an LRU warm cache.

    Args:
      root:     directory for durable persistence (one subdirectory per
                user, `checkpoint.manager` layout inside).  ``None``
                archives evicted state in host RAM instead.
      capacity: max sessions held in the warm cache; beyond it the least-
                recently-used entry is dropped (no I/O — `checkin` already
                persisted it).  ``None`` = unbounded cache.
      keep:     checkpoints retained per session (CheckpointManager keep-K).
      registry: `obs.MetricsRegistry` receiving the store's metrics (a
                private registry is created if omitted): counters
                ``session_store_{warm_hits,restores,creates,persists}_total``
                and histograms ``session_store_{checkout,persist}_seconds``.
    """

    def __init__(self, root: Optional[str] = None,
                 capacity: Optional[int] = None, keep: int = 2,
                 registry: Optional[MetricsRegistry] = None):
        self.root = root
        self.capacity = capacity
        self.keep = keep
        self._warm: "OrderedDict[str, Tuple[Any, int]]" = OrderedDict()
        self._archive: Dict[str, Tuple[Any, int]] = {}   # root=None
        self._managers: Dict[str, CheckpointManager] = {}
        self.metrics = registry if registry is not None else MetricsRegistry()
        self._m_warm_hits = self.metrics.counter(
            "session_store_warm_hits_total",
            "checkouts served from the LRU warm cache")
        self._m_restores = self.metrics.counter(
            "session_store_restores_total",
            "checkouts restored from the durable store")
        self._m_creates = self.metrics.counter(
            "session_store_creates_total",
            "checkouts that built a fresh session (factory)")
        self._m_persists = self.metrics.counter(
            "session_store_persists_total", "durable session writes")
        self._m_checkout = self.metrics.histogram(
            "session_store_checkout_seconds", "checkout latency")
        self._m_persist_s = self.metrics.histogram(
            "session_store_persist_seconds", "persist latency")

    # ---- counter views (read-only; the registry is the source) -----------

    @property
    def warm_hits(self) -> int:
        return int(self._m_warm_hits.value)

    @property
    def restores(self) -> int:
        return int(self._m_restores.value)

    @property
    def creates(self) -> int:
        return int(self._m_creates.value)

    @property
    def persists(self) -> int:
        return int(self._m_persists.value)

    # ---- ownership -------------------------------------------------------

    def __contains__(self, uid: str) -> bool:
        return uid in self._warm

    @property
    def cached(self) -> list:
        """Warm-cached uids, least-recently-used first."""
        return list(self._warm)

    def known(self, uid: str) -> bool:
        """True if `uid` has any state (warm, archived, or on disk)."""
        if uid in self._warm or uid in self._archive:
            return True
        return (self.root is not None
                and latest_step(os.path.join(self.root, str(uid)))
                is not None)

    def checkout(self, uid: str, factory: Callable[[], Any],
                 template: Any = None, device=None) -> Tuple[Any, int]:
        """Return ``(state, step)`` for `uid`; the caller owns it exclusively
        until `checkin`.

        Resolution order: warm cache (entry removed, so no stale second
        copy can be handed out while the session lives in a fleet slot) ->
        durable store (restored onto ``device``, the CPU when None, into
        the structure of the template) -> ``factory()`` itself (fresh zero
        state, step 0).

        Every resolved payload is validated against the template (tree
        structure and per-leaf shape and dtype): the pool's swap-in casts
        leaves to the pool dtype, so a float32 session admitted to an int8
        pool would not crash, it would be silently destroyed.  Migrating a
        float session into a quantized pool is the explicit
        `snn.quantize_state`.  A pool passes its template (meta tensors, no
        allocation); without one, ``factory()`` is built and serves as it.
        """
        with self._m_checkout.time():
            fresh = None
            if template is None:
                template = fresh = factory()
            if uid in self._warm:
                self._m_warm_hits.inc()
                state, step = self._warm.pop(uid)
                self._validate(uid, state, template)
                return state, step
            if self.root is not None:
                mgr = self._manager(uid)
                if mgr.latest_step() is not None:
                    try:
                        state, step, _ = mgr.restore(template, device=device)
                    except (KeyError, ValueError) as e:
                        raise ValueError(
                            f"session {uid!r}: persisted payload does not "
                            f"fit the requested pool mode ({e}); if it is a "
                            "float session being admitted to a quantized "
                            "pool, migrate it explicitly with "
                            "snn.quantize_state") from e
                    self._m_restores.inc()
                    self._validate(uid, state, template)
                    return state, int(step)
            elif uid in self._archive:
                self._m_restores.inc()
                host, step = self._archive[uid]
                state = _ckpt.tree_map(lambda a: a.to(device), host)
                self._validate(uid, state, template)
                return state, step
            self._m_creates.inc()
            return (factory() if fresh is None else fresh), 0

    @staticmethod
    def _validate(uid: str, state: Any, template: Any) -> None:
        """Reject payloads whose structure, shapes or dtypes disagree with
        the pool-mode template (no silent corrupting casts on swap-in)."""
        got_def, want_def = _ckpt.structure(state), _ckpt.structure(template)
        if got_def != want_def:
            raise ValueError(
                f"session {uid!r}: payload tree {got_def} does not match "
                f"the requested pool mode {want_def} (use "
                "snn.quantize_state to migrate float sessions into a "
                "quantized pool)")
        for got, want in zip(_ckpt.flatten(state)[1],
                             _ckpt.flatten(template)[1]):
            g_shape, w_shape = tuple(got.shape), tuple(want.shape)
            g_dt, w_dt = _dtype_name(got), _dtype_name(want)
            if g_shape != w_shape or g_dt != w_dt:
                raise ValueError(
                    f"session {uid!r}: payload leaf {g_dt}{g_shape} "
                    f"does not match the requested pool mode "
                    f"{w_dt}{w_shape}; admitting it would silently "
                    "corrupt the session on the swap-in cast (use "
                    "snn.quantize_state to migrate float sessions into a "
                    "quantized pool)")

    def checkin(self, uid: str, state: Any, step: int) -> None:
        """Return a session to the store: persist FIRST, then warm-cache."""
        self.persist(uid, state, step)
        self._warm[uid] = (state, int(step))
        self._warm.move_to_end(uid)
        while self.capacity is not None and len(self._warm) > self.capacity:
            self._warm.popitem(last=False)       # already durable; no I/O

    # ---- durability ------------------------------------------------------

    def persist(self, uid: str, state: Any, step: int) -> None:
        """Durably write one session snapshot."""
        with self._m_persist_s.time():
            self._m_persists.inc()
            if self.root is None:
                # host copies: later in-place writes to the caller's
                # tensors cannot reach the archived snapshot
                self._archive[uid] = (
                    _ckpt.tree_map(
                        lambda a: a.detach().to("cpu", copy=True), state),
                    int(step))
                return
            self._manager(uid).save(int(step), state)

    def _manager(self, uid: str) -> CheckpointManager:
        if uid not in self._managers:
            self._managers[uid] = CheckpointManager(
                os.path.join(self.root, str(uid)), keep=self.keep)
        return self._managers[uid]
