"""Session slot pools: continuous batching into fixed-shape tensors.

The fleet tensor gives B per-request weight sets one fused launch per
window; this module decides WHICH users occupy those B slots over time.  A
pool is a tree of fixed-shape tensors (dataclasses, tuples, lists, dicts) in
which each leaf either carries a slot axis (one row per resident session)
or is shared pool state (the clock).  Slots are never added or removed, so
every kernel sees the same shapes whatever the occupancy.

`FleetScheduler` is the SNN controller fleet: a `NetworkState` of shape
``(B, N, M)`` stepped through `snn.timestep` (one fleet-step launch per
layer) or `snn.rollout_window` (one rollout launch per window).

Mechanics per scheduling event (`SessionPool`):

  * ``admit(uid)``  — `SessionStore.checkout` (warm hit / durable restore /
    fresh state), then swap-in: an in-place copy of the session into row
    `slot` of every slot-carrying pool tensor (the slot is a Python int).
  * ``evict(uid)``  — swap-out (a copy of the slot's rows), the step
    counter stamped into the session, `SessionStore.checkin` (write-through
    persist); the vacated rows are overwritten with zeros.
  * stepping        — one fused launch over all B slots with the
    ``active (B,)`` mask gating vacant slots into true no-ops (state frozen
    bit for bit, outputs zero).  The mask is an operand, not a shape.

Slot rows are independent and the mask freezes state bit for bit, so a
session's trajectory does not depend on WHICH slot it occupies, on its
neighbours, or on evict -> persist -> re-admit round trips.

`compiled_programs()` is the port's counterpart of the JAX pools' jit-cache
audit: for each entry point, the number of distinct static signatures it
has dispatched (operand shapes, dtypes and device; the telemetry flag;
whether an active mask and a teaching signal were given).  After warm-up it
stays constant under churn; each new signature is reported to the
recompile watchdog (`obs.watchdog`) as ``"<Class>.<entry point>"``.

Session health (``health=HealthConfig(...)``): the pools gain a flight
recorder and streaming detectors (`obs.recorder`, `obs.health`) as a third
variant of the stepping entry points (``record=``, like ``telemetry=``; on
the card one more launch, ``csrc/recorder.cu``, after the telemetry
kernels), and the base class turns the latched verdict into action:
`flagged_sessions` -> `quarantine` (the slot joins the active-mask freeze
vacant slots use) -> `rollback` (re-admit from the last healthy
`SessionStore` checkpoint; `health_checkpoint` rides `persist_resident`)
-> a bit-identical continuation.  `remediate()` runs the whole loop,
optionally dumping a flight-recorder incident bundle per casualty first.

Shards (``mesh=distributed.sharding.fleet_mesh(...)``): the pool's slot
rows split over D shards, slot s on shard ``s * D // B``, each shard's rows
a tensor of their own on its device (`distributed.sharding.Sharded`).  The
stepping entry points launch the same kernels once per shard on its B/D
rows (`core.engine.fleet_spmd`), planned as the whole pool's launch
(`kernels.plasticity.kernel.pool_plan`), so a meshed pool is the unmeshed
pool bit for bit.  Device loss: `fail_device` / `fail_slots` mark a shard's
slots lost (poisoned by default, frozen by the active mask), and
`drain_failed` re-admits their sessions onto surviving shards from their
last durable snapshot (`persist_resident`); `save_pool` stores the leaves
whole, so `load_pool` resumes a pool saved at D shards at any D'
(`distributed.ft.elastic_restore`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.core import snn
from repro_torch.core.engine import NetworkState, fleet_spmd
from repro_torch.distributed import ft as _ft
from repro_torch.distributed import sharding as _sharding
from repro_torch.kernels.plasticity.kernel import pool_plan
from repro_torch.obs import MetricsRegistry, phase
from repro_torch.obs import recorder as _recorder
from repro_torch.obs.health import HealthConfig
from repro_torch.obs.telemetry import record_fleet_telemetry
from repro_torch.obs.watchdog import watchdog as _compile_watchdog
from repro_torch.serving.sessions import SessionStore

# Axis sentinel: a pool leaf marked SHARED has no slot rows — it is pool-
# global state (the fleet clock `NetworkState.t`).  Swap-in leaves it alone;
# swap-out returns zeros (the scheduler stamps the session's own value).
SHARED = "shared"


# ---- slot copies (any tree of leading-slot-rank leaves) --------------------

def slot_put(pool, slot: int, user):
    """Copy `user` (tree of unbatched leaves) into row `slot` of every pool
    leaf, in place (cast to the pool's dtype).  Returns `pool`."""
    for p, u in zip(_ckpt.flatten(pool)[1], _ckpt.flatten(user)[1]):
        p[slot].copy_(u)
    return pool


def slot_take(pool, slot: int):
    """A copy of row `slot` of every pool leaf, as an unbatched tree."""
    return _ckpt.tree_map(lambda p: p[slot].clone(), pool)


def make_slot_ops(axes):
    """(put, take) for a pool whose per-leaf slot axes are `axes`.

    `axes` is a tree matching the pool whose leaves are an int (the axis
    carrying slot rows in that leaf) or `SHARED`.  ``put(pool, slot, user)``
    writes in place and returns the pool; ``take(pool, slot)`` returns
    copies (a SHARED leaf comes back as zeros).
    """
    ax_leaves = _ckpt.flatten(axes)[1]

    def put(pool, slot: int, user):
        for p, u, ax in zip(_ckpt.flatten(pool)[1], _ckpt.flatten(user)[1],
                            ax_leaves):
            if ax != SHARED:
                p.select(ax, slot).copy_(u)
        return pool

    def take(pool, slot: int):
        return _ckpt.unflatten(pool, [
            torch.zeros_like(p) if ax == SHARED else p.select(ax, slot).clone()
            for p, ax in zip(_ckpt.flatten(pool)[1], ax_leaves)])

    return put, take


def uniform_axes(tree, axis=0):
    """Axes tree assigning one slot `axis` to every leaf of `tree`."""
    return _ckpt.tree_map(lambda _: axis, tree)


# ---- the generic pool ------------------------------------------------------


class SessionPool:
    """Admit/evict user sessions into a fixed-shape slot pool (base class).

    Subclasses provide the pool tree and its slot-axes tree and own the
    stepping; this base owns occupancy bookkeeping, LRU admission, the slot
    copies, per-session step counters and the `SessionStore` round trip.

    Args:
      pool:  the pool tree (ZEROED in its slot rows: slot 0 of the initial
             pool is the template of a vacated slot).
      axes:  tree matching `pool`: per-leaf slot axis (int) or `SHARED`.
      slots: pool size B; fixes every pool tensor shape forever.
      store: `SessionStore` backing eviction/restore; a private in-RAM
             store is created if omitted.
      registry: `obs.MetricsRegistry` for the pool's (and a private
             store's) metrics; a private one is created if omitted.
      health: optional `obs.health.HealthConfig` enabling session health:
             subclasses gain ``record=True`` stepping, this base gains
             `flagged_sessions` / `health_checkpoint` / `remediate`.
             Without it, recording and remediation raise.
      mesh:  optional `distributed.sharding.FleetMesh` (`fleet_mesh`): the
             pool tree is split over its shards along the slot axes, shard
             d owning the contiguous slots ``[d B/D, (d+1) B/D)``; `slots`
             must divide evenly over them.  The pool's devices are then
             the mesh's (``self.device`` is its first, where sessions are
             built and restored before their rows are copied in).
    """

    # entry points of the static-signature audit, registered at 0
    ENTRY_POINTS = ("slot_put", "slot_take", "recorder_reset")

    def __init__(self, pool, axes, slots: int,
                 store: Optional[SessionStore] = None,
                 registry: Optional[MetricsRegistry] = None,
                 health: Optional[HealthConfig] = None, mesh=None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = slots
        self.mesh = mesh
        self.num_devices = 1
        if mesh is not None:
            if _sharding.DATA not in mesh.axis_names:
                raise ValueError(
                    f"pool mesh needs a 'data' axis (the slot axis); got "
                    f"axes {mesh.axis_names}: build it with "
                    "distributed.sharding.fleet_mesh()")
            self.num_devices = mesh.size
            if slots % self.num_devices:
                raise ValueError(
                    f"slots={slots} must divide evenly over the "
                    f"{self.num_devices}-shard 'data' axis (every shard "
                    "owns the same number of slot rows; pad the pool or "
                    "shrink the mesh)")
            pool = _sharding.shard(pool,
                                   _sharding.pool_shardings(mesh, axes))
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.store = (store if store is not None
                      else SessionStore(registry=self.metrics))
        self.pool = pool
        self._axes = axes
        self.device = (mesh.devices[0] if mesh is not None
                       else _ckpt.flatten(pool)[1][0].device)
        self._put, self._take = make_slot_ops(axes)
        self._zero_session = self._take(pool, 0)
        # the pool-mode session template: shapes and dtypes, no storage
        self._template = _ckpt.tree_map(
            lambda a: torch.empty(a.shape, dtype=a.dtype, device="meta"),
            self._zero_session)
        self.slot_user: list = [None] * slots        # slot -> uid | None
        self.user_slot: Dict[str, int] = {}          # uid -> slot
        self._steps = np.zeros(slots, np.int64)      # per-session step count
        self._admit_seq = np.zeros(slots, np.int64)  # admission order (LRU)
        self._seq = 0
        self.evictions = 0
        # fault tolerance: slots whose shard is marked lost never admit,
        # never count active and refuse evict (their rows are gone);
        # `drain_failed` re-homes their sessions
        self._lost_slots: set = set()
        self._poison_session = None                  # built on first failure
        # session health: quarantined slots are occupied but frozen by the
        # active mask; the recorder is built on the first recorded step, so
        # a health-enabled pool that never records allocates nothing
        self.health_cfg = health
        self._quarantined: set = set()
        self._rec = None                             # obs.recorder state
        self._rec_pos = 0                            # global ring cursor
        self.last_verdict = None                     # (B,) bool, on device
        self._signatures: Dict[str, set] = {n: set()
                                            for n in self.ENTRY_POINTS}
        self._m_admit = self.metrics.histogram(
            "pool_admit_seconds", "admit latency (checkout + swap-in)")
        self._m_evict = self.metrics.histogram(
            "pool_evict_seconds", "evict latency (swap-out + persist)")
        self._m_occupancy = self.metrics.gauge(
            "pool_occupancy", "admitted sessions / pool slots")
        self._m_admissions = self.metrics.counter(
            "pool_admissions_total", "sessions admitted")
        self._m_evictions = self.metrics.counter(
            "pool_evictions_total", "sessions evicted")
        self._m_failures = self.metrics.counter(
            "pool_device_failures_total", "device shards marked lost")
        self._m_drained = self.metrics.counter(
            "pool_drained_sessions_total",
            "sessions re-homed off a lost shard")
        self._m_drain = self.metrics.histogram(
            "pool_drain_seconds", "drain latency (restore + re-admit, per "
            "drain_failed call)")
        self._m_quarantined = self.metrics.counter(
            "pool_quarantined_total", "sessions quarantined as unhealthy")
        self._m_rollbacks = self.metrics.counter(
            "pool_rollbacks_total",
            "quarantined sessions rolled back to their last healthy "
            "checkpoint")
        self._m_health_ckpts = self.metrics.counter(
            "pool_health_checkpoints_total",
            "health_checkpoint() sweeps (rollback restore points)")

    def _dispatch(self, name: str, *operands, **flags) -> None:
        """Record the static signature of one call of entry point `name`;
        a new one is reported to the recompile watchdog."""
        sig = _ckpt.signature(*operands, **flags)
        seen = self._signatures[name]
        if sig not in seen:
            seen.add(sig)
            _compile_watchdog.notify(f"{type(self).__name__}.{name}")

    # ---- occupancy -------------------------------------------------------

    @property
    def active_users(self) -> list:
        return [u for u in self.slot_user if u is not None]

    @property
    def free_slots(self) -> int:
        return sum(1 for s, u in enumerate(self.slot_user)
                   if u is None and s not in self._lost_slots)

    @property
    def lost_slots(self) -> frozenset:
        """Slots whose shard has been marked lost."""
        return frozenset(self._lost_slots)

    def slot_device(self, slot: int) -> int:
        """The shard owning ``slot`` (0 unmeshed): contiguous blocks,
        shard d owns slots ``[d B/D, (d+1) B/D)``."""
        return slot * self.num_devices // self.slots

    def device_slots(self, device: int) -> range:
        """The contiguous slot block owned by shard ``device``."""
        per = self.slots // self.num_devices
        if not 0 <= device < self.num_devices:
            raise ValueError(f"device must be in [0, {self.num_devices}), "
                             f"got {device}")
        return range(device * per, (device + 1) * per)

    def _active_mask(self) -> torch.Tensor:
        # lost and quarantined slots are masked out like vacant ones: a
        # stranded session is frozen until drain_failed re-homes it, an
        # unhealthy one until rollback restores it.  A meshed pool's mask
        # stays on the host; each shard gets its block on its device.
        mask = np.fromiter((u is not None and s not in self._lost_slots
                            and s not in self._quarantined
                            for s, u in enumerate(self.slot_user)),
                           np.bool_, self.slots)
        return self._on_pool(torch.from_numpy(mask))

    def _on_pool(self, t: torch.Tensor) -> torch.Tensor:
        """A host operand on the pool's device; a meshed pool keeps it on
        the host and each shard takes its block (`engine.fleet_spmd`)."""
        return t if self.mesh is not None else t.to(self.device)

    def _rows(self, out, axis: int = 0) -> dict:
        """uid -> its row of ``out`` (slot rows on ``axis``); a sharded
        output comes to the host once a shard."""
        if not isinstance(out, _sharding.Sharded):
            return {uid: out.select(axis, slot)
                    for uid, slot in self.user_slot.items()}
        pieces = [p.cpu() for p in out.pieces]
        per = self.slots // self.num_devices
        return {uid: pieces[slot // per].select(axis, slot % per)
                for uid, slot in self.user_slot.items()}

    def compiled_programs(self) -> Dict[str, int]:
        """Per-entry-point counts of distinct static signatures dispatched:
        {name: signatures}.  Every entry point is listed, unused ones at 0."""
        return {name: len(s) for name, s in self._signatures.items()}

    def compile_count(self) -> int:
        """Total static signatures dispatched by the pool's entry points."""
        return sum(self.compiled_programs().values())

    def pool_nbytes(self) -> int:
        """Resident bytes of the pool tree (all leaves, every shard's): an
        int8 pool holds about 4x more sessions per byte than a float32
        one."""
        return sum(t.numel() * t.element_size()
                   for t in _ckpt.flatten(self.pool)[1])

    # ---- session template hooks -----------------------------------------

    def _session_factory(self):
        """Fresh (zero) session for a brand-new user."""
        return _ckpt.tree_map(torch.zeros_like, self._zero_session)

    def _finalize_session(self, user, step: int):
        """Hook: adjust a just-gathered session before persisting it."""
        return user

    def _put_slot(self, slot: int, user) -> None:
        self._dispatch("slot_put", self.pool, user)
        self.pool = self._put(self.pool, slot, user)

    def _take_slot(self, slot: int):
        self._dispatch("slot_take", self.pool)
        return self._take(self.pool, slot)

    # ---- admission / eviction -------------------------------------------

    def admit(self, uid: str, evict_lru: bool = False, factory=None) -> int:
        """Place `uid` into a free slot (restoring persisted state if any).

        Returns the slot index.  With ``evict_lru=True`` a full pool evicts
        its least-recently-admitted session to make room; otherwise a full
        pool raises RuntimeError.  `factory` overrides the fresh-session
        constructor for THIS admission.
        """
        if uid in self.user_slot:
            raise ValueError(f"session {uid!r} is already in slot "
                             f"{self.user_slot[uid]}")
        lost = self._lost_slots
        slot = next((s for s, u in enumerate(self.slot_user)
                     if u is None and s not in lost), None)
        if slot is None:
            # quarantined residents are not LRU-evictable: evicting one
            # would persist its diverged state over the healthy checkpoint
            candidates = [s for s in range(self.slots)
                          if s not in lost and s not in self._quarantined]
            if not evict_lru or not candidates:
                gone = (f" ({len(lost)} slots lost to device failure)"
                        if lost else "")
                raise RuntimeError(
                    f"pool is full ({self.slots} slots{gone}); pass "
                    "evict_lru=True or evict a session first")
            slot = min(candidates, key=lambda s: self._admit_seq[s])
            self.evict(self.slot_user[slot])
        with self._m_admit.time(), phase("pool.admit"):
            state, step = self.store.checkout(
                uid, self._session_factory if factory is None else factory,
                template=self._template, device=self.device)
            with phase("pool.swap_in"):
                self._put_slot(slot, state)
        self.slot_user[slot] = uid
        self.user_slot[uid] = slot
        self._steps[slot] = step
        self._admit_seq[slot] = self._seq
        self._seq += 1
        # the slot's recorder history belongs to the previous tenant
        self._reset_recorder(slot)
        self._m_admissions.inc()
        self._m_occupancy.set(len(self.user_slot) / self.slots)
        return slot

    def evict(self, uid: str) -> None:
        """Swap `uid` out, persist it durably, and clear its slot."""
        slot = self.user_slot.get(uid)
        if slot is None:
            raise KeyError(f"session {uid!r} is not in the pool")
        if slot in self._lost_slots:
            raise RuntimeError(
                f"session {uid!r} sits in lost slot {slot} (device "
                f"{self.slot_device(slot)}); its rows are gone — recover it "
                "with drain_failed(), which restores the last durable "
                "checkpoint, instead of evicting garbage")
        if slot in self._quarantined:
            raise RuntimeError(
                f"session {uid!r} in slot {slot} is quarantined as "
                "unhealthy; evicting would persist its diverged state over "
                "the last healthy checkpoint — recover it with rollback() "
                "or remediate() instead")
        self.user_slot.pop(uid)
        with self._m_evict.time(), phase("pool.evict"):
            with phase("pool.swap_out"):
                user = self._take_slot(slot)
            user = self._finalize_session(user, int(self._steps[slot]))
            self.store.checkin(uid, user, int(self._steps[slot]))
            self.slot_user[slot] = None
            # hygiene: zeros over the vacated rows, so no stale user data
            # lingers in the pool tensors (the mask already freezes them)
            self._put_slot(slot, self._zero_session)
        self._steps[slot] = 0
        self._reset_recorder(slot)
        self.evictions += 1
        self._m_evictions.inc()
        self._m_occupancy.set(len(self.user_slot) / self.slots)

    def advance_steps(self, k: int) -> None:
        """Advance every admitted session's host-side step counter by k.
        A stranded session (in a lost slot) takes no step, so its counter
        holds where the failure left it and `drain_failed`'s
        ``steps_lost`` counts the steps it took after its snapshot (the
        JAX package's counter also counts the windows it sat stranded)."""
        for slot in self.user_slot.values():
            if slot not in self._lost_slots:
                self._steps[slot] += k

    # ---- device-loss recovery --------------------------------------------

    def persist_resident(self) -> int:
        """Durably snapshot every resident session WITHOUT evicting it
        (`SessionStore.persist`; the warm cache is untouched): the
        drain-safety checkpoint, whose age is the blast radius of a device
        loss.  Returns the number of sessions persisted.  Lost slots are
        skipped (their rows are gone) and so are quarantined ones (their
        rows are diverged state, and persisting one would overwrite the
        checkpoint rollback needs)."""
        n = 0
        for uid, slot in list(self.user_slot.items()):
            if slot in self._lost_slots or slot in self._quarantined:
                continue
            user = self._take_slot(slot)
            user = self._finalize_session(user, int(self._steps[slot]))
            self.store.persist(uid, user, int(self._steps[slot]))
            n += 1
        return n

    def stranded_sessions(self) -> list:
        """Uids resident in lost slots, awaiting `drain_failed`."""
        return [u for u, s in self.user_slot.items()
                if s in self._lost_slots]

    def _poison(self):
        """A session of garbage: NaN float planes, the integer dtype's
        largest value, ones for bool."""
        if self._poison_session is None:
            def leaf(z):
                if z.dtype.is_floating_point:
                    return torch.full_like(z, float("nan"))
                if z.dtype == torch.bool:
                    return torch.ones_like(z)
                return torch.full_like(z, torch.iinfo(z.dtype).max)
            self._poison_session = _ckpt.tree_map(leaf, self._zero_session)
        return self._poison_session

    def fail_slots(self, slots, poison: bool = True) -> list:
        """Failure injection: mark ``slots`` lost; returns the stranded
        uids.

        With ``poison=True`` (the default) their rows are overwritten with
        garbage (`_poison`): a recovery that passes with poison on shows
        that the drain reads only `SessionStore` checkpoints, never the dead
        shard, and that the active mask isolates the garbage from the
        surviving slots' arithmetic."""
        slots = sorted(set(int(s) for s in slots))
        for s in slots:
            if not 0 <= s < self.slots:
                raise ValueError(f"slot {s} out of range [0, {self.slots})")
        self._lost_slots.update(slots)
        if poison:
            for s in slots:
                self._put_slot(s, self._poison())
        return self.stranded_sessions()

    def fail_device(self, device: int, poison: bool = True) -> list:
        """Mark shard ``device``'s whole slot block lost (see `fail_slots`):
        everything it owned, resident sessions included, is gone; follow
        with `drain_failed()` to re-home its sessions on the survivors."""
        stranded = self.fail_slots(self.device_slots(device), poison=poison)
        self._m_failures.inc()
        return stranded

    def drain_failed(self, evict_lru: bool = False) -> list:
        """Re-home every stranded session onto surviving shards.

        For each uid resident in a lost slot: drop the dead occupancy
        (nothing is read from the shard), then `admit` the uid, which
        restores its last durable snapshot from the `SessionStore` into a
        healthy slot.  A session's trajectory does not depend on its slot
        or neighbours, so its continuation equals an uninterrupted run from
        that snapshot bit for bit.  Steps after the last
        `persist_resident` or evict are lost; each report row says how
        many.

        Returns one dict a session: ``{uid, from_slot, to_slot,
        from_device, to_device, steps_lost}``.  With ``evict_lru=True`` a
        full pool evicts least-recently-admitted survivors to make room.
        """
        report = []
        with self._m_drain.time(), phase("pool.drain"):
            for uid in self.stranded_sessions():
                old_slot = self.user_slot.pop(uid)
                self.slot_user[old_slot] = None
                steps_at_fail = int(self._steps[old_slot])
                self._steps[old_slot] = 0
                # hygiene (an injected loss is writable, a real one is
                # not): zeros over the poison keep vacant slots zero for
                # save_pool
                self._put_slot(old_slot, self._zero_session)
                new_slot = self.admit(uid, evict_lru=evict_lru)
                self._m_drained.inc()
                report.append({
                    "uid": uid,
                    "from_slot": old_slot, "to_slot": new_slot,
                    "from_device": self.slot_device(old_slot),
                    "to_device": self.slot_device(new_slot),
                    "steps_lost": steps_at_fail - int(self._steps[new_slot]),
                })
        self._m_occupancy.set(len(self.user_slot) / self.slots)
        return report

    # ---- session health: detect -> quarantine -> rollback ----------------

    @property
    def quarantined_slots(self) -> frozenset:
        """Slots frozen by `quarantine` (occupied, masked out, awaiting
        rollback)."""
        return frozenset(self._quarantined)

    def _ensure_recorder(self):
        """The flight-recorder state, built on first use."""
        if self.health_cfg is None:
            raise ValueError(
                "this pool was built without health=HealthConfig(...); "
                "recording and remediation are unavailable")
        if self._rec is None:
            if self.mesh is None:
                self._rec = _recorder.init_recorder(
                    self.health_cfg, self.slots, device=self.device)
            else:
                # every recorder leaf is slot-major: split like the pool
                rec = _recorder.init_recorder(self.health_cfg, self.slots,
                                              device="cpu")
                self._rec = _sharding.shard(rec, _sharding.pool_shardings(
                    self.mesh, uniform_axes(rec)))
        return self._rec

    def _reset_recorder(self, slot: int) -> None:
        """Zero one slot's recorder rows (a new tenancy starts clean)."""
        if self._rec is not None:
            self._dispatch("recorder_reset", self._rec)
            _recorder.reset_slot(self._rec, slot)

    def health_checkpoint(self) -> int:
        """Durably snapshot every healthy resident session: the restore
        point `rollback` recovers to.  Rides `persist_resident`
        (quarantined slots are skipped); steps since the last call are the
        blast radius of an incident.  Returns the number persisted."""
        n = self.persist_resident()
        self._m_health_ckpts.inc()
        return n

    def flagged_sessions(self) -> list:
        """Uids whose latched device-side verdict is unhealthy (slot order).

        The one host read of the health loop, a single ``(B,)`` copy on
        demand (one a shard), never per step.  Lost and quarantined slots
        are excluded."""
        if self._rec is None:
            return []
        flags = _sharding.host(self._rec.health.flagged).any(dim=-1).numpy()
        return [u for s, u in enumerate(self.slot_user)
                if u is not None and flags[s]
                and s not in self._lost_slots
                and s not in self._quarantined]

    def quarantine(self, uid: str) -> int:
        """Freeze `uid`'s slot by the active mask (no data moves): its state
        stops evolving bit for bit, like a vacant slot's, until `rollback`
        re-homes it.  Returns the quarantined slot."""
        slot = self.user_slot.get(uid)
        if slot is None:
            raise KeyError(f"session {uid!r} is not in the pool")
        if slot in self._lost_slots:
            raise RuntimeError(
                f"session {uid!r} sits in LOST slot {slot}; use "
                "drain_failed(), not quarantine")
        self._quarantined.add(slot)
        self._m_quarantined.inc()
        return slot

    def rollback(self, uid: str, evict_lru: bool = False) -> dict:
        """Re-admit a quarantined session from its last healthy checkpoint.

        Drops the diverged occupancy (nothing is gathered or persisted from
        it), zeroes the slot and its recorder rows, then `admit(uid)`,
        which restores the last durable snapshot from the `SessionStore`:
        the continuation equals a manual evict-at-checkpoint -> re-admit of
        the same checkpoint bit for bit.  Steps since the last
        `health_checkpoint` or evict are lost; the report says how many.

        Returns ``{uid, from_slot, to_slot, steps_lost}``.
        """
        slot = self.user_slot.get(uid)
        if slot is None:
            raise KeyError(f"session {uid!r} is not in the pool")
        if slot not in self._quarantined:
            raise RuntimeError(
                f"session {uid!r} (slot {slot}) is not quarantined; "
                "rollback only recovers quarantined sessions — call "
                "quarantine(uid) first (or remediate(), which does both)")
        steps_at_flag = int(self._steps[slot])
        self.user_slot.pop(uid)
        self.slot_user[slot] = None
        self._steps[slot] = 0
        self._put_slot(slot, self._zero_session)
        self._quarantined.discard(slot)
        self._reset_recorder(slot)
        new_slot = self.admit(uid, evict_lru=evict_lru)
        self._m_rollbacks.inc()
        return {"uid": uid, "from_slot": slot, "to_slot": new_slot,
                "steps_lost": steps_at_flag - int(self._steps[new_slot])}

    def remediate(self, evict_lru: bool = False,
                  flight_dir: Optional[str] = None) -> list:
        """The health loop: quarantine every flagged session, optionally
        dump its flight-recorder incident bundle into ``flight_dir``, and
        roll it back to the last healthy checkpoint.  Returns one
        `rollback` report per casualty (with an ``"incident"`` path when
        dumping).  A clean pool is a no-op."""
        reports = []
        for uid in self.flagged_sessions():
            slot = self.quarantine(uid)
            incident = None
            if flight_dir is not None:
                incident = _recorder.dump_incident(
                    flight_dir, uid=uid, slot=slot, rec=self._rec,
                    cfg=self.health_cfg, pos=self._rec_pos,
                    registry=self.metrics, watchdog=_compile_watchdog)
            report = self.rollback(uid, evict_lru=evict_lru)
            if incident is not None:
                report["incident"] = incident
            reports.append(report)
        return reports

    # ---- whole-pool checkpointing ----------------------------------------

    def save_pool(self, directory: str) -> str:
        """Checkpoint the WHOLE pool — resident sessions in place — plus the
        occupancy bookkeeping, in the `checkpoint.manager` layout, every
        leaf whole (a meshed pool's shards gathered on the host): a pool
        saved at D shards loads at any D' (`load_pool`), and in the JAX
        package's.  Stranded sessions must be drained first (their rows are
        garbage); a pool with quarantined sessions refuses too: `load_pool`
        restarts with none, which would unfreeze diverged state as
        healthy."""
        stranded = self.stranded_sessions()
        if stranded:
            raise RuntimeError(
                f"cannot checkpoint a pool with stranded sessions "
                f"{stranded}; run drain_failed() first")
        sick = [u for u, s in self.user_slot.items()
                if s in self._quarantined]
        if sick:
            raise RuntimeError(
                f"cannot checkpoint a pool with quarantined sessions "
                f"{sick}; run remediate() first")
        extra = {
            "slots": self.slots,
            "slot_user": list(self.slot_user),
            "steps": [int(s) for s in self._steps],
            "admit_seq": [int(s) for s in self._admit_seq],
            "seq": int(self._seq),
        }
        return _ckpt.save_checkpoint(directory, int(self._seq), self.pool,
                                     extra=extra)

    def load_pool(self, directory: str, step: Optional[int] = None) -> None:
        """Resume a `save_pool` checkpoint into this pool, laid out on this
        pool's mesh: the elastic re-mesh.  Build the pool at the new
        topology (any shard count dividing ``slots``, or none) and load a
        checkpoint taken at the old one; the leaves are stored whole, so
        this places them on the new shards
        (`distributed.ft.elastic_restore`).  Occupancy, per-session step
        counters and LRU order resume exactly; every slot comes back
        healthy."""
        if self.mesh is not None:
            tree, _, extra = _ft.elastic_restore(
                directory, self.pool, self.mesh,
                lambda mesh: _sharding.pool_shardings(mesh, self._axes),
                step=step)
        else:
            tree, _, extra = _ckpt.load_checkpoint(
                directory, self.pool, step=step, device=self.device)
        if int(extra["slots"]) != self.slots:
            raise ValueError(
                f"checkpointed pool has {extra['slots']} slots; this pool "
                f"has {self.slots} (elastic restore re-meshes devices, not "
                "the slot count)")
        self.pool = tree
        self.slot_user = list(extra["slot_user"])
        self.user_slot = {u: s for s, u in enumerate(self.slot_user)
                          if u is not None}
        self._steps = np.asarray(extra["steps"], np.int64).copy()
        self._admit_seq = np.asarray(extra["admit_seq"], np.int64).copy()
        self._seq = int(extra["seq"])
        self._lost_slots = set()
        self._poison_session = None
        # the recorder is not checkpointed (detector baselines are cheap to
        # rebuild and meaningless across a re-mesh): every slot restarts
        # healthy and unrecorded
        self._quarantined = set()
        self._rec = None
        self._rec_pos = 0
        self.last_verdict = None
        self._m_occupancy.set(len(self.user_slot) / self.slots)


# ---- the SNN controller fleet ---------------------------------------------


def _network_axes(fleet: NetworkState) -> NetworkState:
    """Slot axes of a fleet NetworkState: every leaf carries slot rows on
    axis 0 except the shared pool clock `t`; in a quantized pool the
    per-layer ``w_scale`` rows travel with their session."""
    return NetworkState(
        w=tuple(0 for _ in fleet.w),
        v=tuple(0 for _ in fleet.v),
        trace=tuple(0 for _ in fleet.trace),
        t=SHARED,
        w_scale=tuple(0 for _ in fleet.w_scale))


class FleetScheduler(SessionPool):
    """Admit/evict user sessions into a fixed-shape controller slot pool.

    Args:
      cfg:    `snn.SNNConfig` of the controller (``cfg.quant`` — see
              `snn.quant_config` — makes it a QUANTIZED pool: int8 weight
              slots with per-slot scales, int32 membranes and traces, and
              per-session step counters driving the deterministic
              stochastic round, so evict -> re-admit stays bit-identical).
      theta:  per-layer packed rule coefficients, shared by every session
              (the rule is the deployment, the weights are the user).
      slots:  pool size B; fixes the fleet tensor shape forever.
      store:  `SessionStore` backing eviction/restore; a private in-RAM
              store is created if omitted.
      device: where the pool lives; None is the card (and raises where
              there is none).
      health: optional `obs.health.HealthConfig`: ``record=True`` stepping
              and the remediation loop (see `SessionPool`).
      mesh:   optional `distributed.sharding.FleetMesh`, exclusive with
              ``device``: the fleet splits over its shards along the slot
              axis and every stepping entry point runs per shard through
              `engine.fleet_spmd`, each shard launching the same kernels on
              its B/D slots with its block of the drives, the mask and the
              per-session seeds; the pool clock ``t`` stays whole and
              advances outside the shards.  Outputs come back to the host
              once a shard; the pool is the unmeshed pool bit for bit.
    """

    ENTRY_POINTS = SessionPool.ENTRY_POINTS + (
        "pool_step", "pool_rollout", "pool_step_telemetry",
        "pool_rollout_telemetry", "pool_step_record", "pool_rollout_record")

    def __init__(self, cfg: snn.SNNConfig, theta, slots: int,
                 store: Optional[SessionStore] = None,
                 registry: Optional[MetricsRegistry] = None, device=None,
                 health: Optional[HealthConfig] = None, mesh=None):
        if mesh is not None and device is not None:
            raise ValueError("FleetScheduler takes device= or mesh=, not "
                             "both: a meshed pool lives on the mesh's "
                             "devices")
        self.cfg = cfg
        self.theta = theta
        # a meshed fleet is built on the host and split onto the shards
        fleet = snn.init_state(cfg, batch=slots, fleet=True,
                               device="cpu" if mesh is not None else device)
        super().__init__(fleet, _network_axes(fleet), slots, store, registry,
                         health=health, mesh=mesh)
        self._thetas = {}            # device -> the rule there (meshed)

    # the historical attribute name: the pool tree IS the fleet state
    @property
    def fleet(self) -> NetworkState:
        return self.pool

    @fleet.setter
    def fleet(self, value: NetworkState) -> None:
        self.pool = value

    def _session_factory(self):
        return snn.init_state(self.cfg, device=self.device)

    def _finalize_session(self, user: NetworkState, step: int) -> NetworkState:
        # swap-out zeroes the SHARED pool clock; stamp the session's own
        # host-side step count before it is persisted
        return dataclasses.replace(
            user, t=torch.tensor(step, dtype=torch.int32, device=self.device))

    # ---- stepping --------------------------------------------------------

    def _gather_rows(self, drives: Mapping[str, Any],
                     teach: Optional[Mapping[str, Any]]):
        """Validate uid coverage and pack per-session rows into slot order
        (one host-to-device copy each)."""
        missing = [u for u in self.user_slot if u not in drives]
        extra = [u for u in drives if u not in self.user_slot]
        if missing or extra:
            raise ValueError(
                f"drives must cover exactly the admitted sessions; missing "
                f"{missing}, not admitted {extra}")
        n_in = self.cfg.layer_sizes[0]
        drive = np.zeros((self.slots, n_in), np.float32)
        for uid, row in drives.items():
            drive[self.user_slot[uid]] = np.asarray(row, np.float32)
        tarr = None
        if teach is not None:
            ghosts = [u for u in teach if u not in self.user_slot]
            if ghosts:
                raise ValueError(
                    f"teach signals for sessions not in the pool: {ghosts}")
            m_out = self.cfg.layer_sizes[-1]
            tarr = np.zeros((self.slots, m_out), np.float32)
            for uid, row in teach.items():
                tarr[self.user_slot[uid]] = np.asarray(row, np.float32)
            tarr = self._on_pool(torch.from_numpy(tarr))
        return self._on_pool(torch.from_numpy(drive)), tarr

    def _seeds(self) -> torch.Tensor:
        """Per-SESSION step counters: in a quantized pool they drive the
        stochastic round, so a session's update stream follows the session
        across evictions, slots and shards, never the pool clock (a shard
        gets its block of them)."""
        return self._on_pool(torch.from_numpy(self._steps.astype(np.int32)))

    def _theta_on(self, device) -> list:
        """The shared rule on ``device``, copied there once."""
        th = self._thetas.get(device)
        if th is None:
            th = self._thetas[device] = [
                None if t is None else t.to(device) for t in self.theta]
        return th

    def _launch(self, window: int, drive, tarr, active, seeds,
                telemetry: bool, record: bool):
        """The fused step (``window`` 0) or a ``window``-step rollout of the
        whole pool, recorded with ``record``: ``(new fleet, outputs,
        telemetry or None)``, the recorder advanced in place.  A meshed
        pool runs it once a shard (`engine.fleet_spmd`) under the whole
        pool's kernel plans (`pool_plan`)."""
        cfg, tel_on, quant = self.cfg, telemetry or record, \
            self.cfg.quant is not None
        rec = self._rec if record else None
        pos = self._rec_pos

        def core(fleet, x, active, teach, seeds, rec, theta):
            if window:
                res = snn.rollout_window(
                    cfg, fleet, theta, x[None].expand(window, *x.shape),
                    teach=teach, active=active, seed=seeds,
                    telemetry=tel_on)
            else:
                res = snn.timestep(cfg, fleet, theta, x, teach=teach,
                                   active=active, seed=seeds,
                                   telemetry=tel_on)
            tail = ()
            if record:
                tail = _recorder.record_step(self.health_cfg, rec, res[0],
                                             res[2], pos, active, quant)
            return res[0], res[1], (res[2] if tel_on else None), tail

        if self.mesh is None:
            ns, out, tel, tail = core(self.fleet, drive, active, tarr, seeds,
                                      rec, self.theta)
        else:
            def body(w, v, tr, scl, t, x, active, teach, seeds, rec):
                st = NetworkState(w=w, v=v, trace=tr, t=t, w_scale=scl)
                ns, out, tel, tail = core(st, x, active, teach, seeds, rec,
                                          self._theta_on(x.device))
                return ((ns.w, ns.v, ns.trace, ns.w_scale, out)
                        + ((tel,) if tel_on else ()) + tuple(tail))

            out_axes = ((0, 0, 0, 0, 1 if window else 0)
                        + ((0,) if tel_on else ()) + ((0, 0) if record
                                                      else ()))
            mapped = fleet_spmd(body, self.mesh,
                                in_axes=(0, 0, 0, 0, None, 0, 0, 0, 0, 0),
                                out_axes=out_axes)
            f = self.fleet
            with pool_plan(self.slots):
                res = mapped(f.w, f.v, f.trace, f.w_scale, f.t, drive,
                             active, tarr, seeds, rec)
            ns = NetworkState(w=res[0], v=res[1], trace=res[2],
                              t=f.t + max(window, 1), w_scale=res[3])
            out = res[4]
            tel = res[5] if tel_on else None
            tail = res[-2:] if record else ()
        if record:
            self._rec, self.last_verdict = tail
            self._rec_pos += 1
        return ns, out, tel

    def _telemetry_out(self, tel):
        """Record the fleet gauges; a sharded telemetry comes to the host
        once a shard."""
        if self.mesh is not None:
            tel = _sharding.gather(tel)
        record_fleet_telemetry(self.metrics, tel)
        return tel

    def step(self, drives: Mapping[str, Any],
             teach: Optional[Mapping[str, Any]] = None,
             telemetry: bool = False, record: bool = False):
        """One fused SNN timestep for the WHOLE pool (one fleet-step launch
        per layer, a shard).

        `drives` maps uid -> input drive ``(obs_dim,)`` (already encoded).
        Every admitted session must receive a drive; vacant slots get zero
        drive and are frozen by the active mask.  Returns uid -> readout
        row.  ``telemetry=True`` launches the telemetry variants and returns
        ``(outputs, FleetTelemetry)``, recording the fleet gauges into
        ``self.metrics``.

        ``record=True`` (needs ``health=HealthConfig(...)``) launches the
        telemetry variants, then the recorder: the telemetry channels and
        the weight norm feed the flight-recorder ring and the detectors,
        with no host sync; the latched verdict waits on the device for
        `flagged_sessions` / `remediate`.  Pass ``telemetry=True`` too to
        also get the tuple return and the gauges.  Outputs and state are
        those of ``record=False`` bit for bit.
        """
        drive, tarr = self._gather_rows(drives, teach)
        rec = self._ensure_recorder() if record else None
        active, seeds = self._active_mask(), self._seeds()
        if record:
            self._dispatch("pool_step_record", self.fleet, drive, active,
                           tarr, seeds, rec)
        else:
            name = "pool_step_telemetry" if telemetry else "pool_step"
            self._dispatch(name, self.fleet, drive, active, tarr, seeds,
                           telemetry=telemetry)
        with phase("pool.step"):
            self.fleet, out, tel = self._launch(0, drive, tarr, active, seeds,
                                                telemetry, record)
        self.advance_steps(1)
        outputs = self._rows(out)
        if not telemetry:
            return outputs
        return outputs, self._telemetry_out(tel)

    def _window(self, drives, timesteps, teach, telemetry, record=False):
        k = self.cfg.timesteps if timesteps is None else int(timesteps)
        if k < 1:
            raise ValueError(f"pool_step needs timesteps >= 1, got {k}")
        drive, tarr = self._gather_rows(drives, teach)
        rec = self._ensure_recorder() if record else None
        active, seeds = self._active_mask(), self._seeds()
        window = drive[None].expand(k, *drive.shape)
        if record:
            self._dispatch("pool_rollout_record", self.fleet, window, active,
                           tarr, seeds, rec)
        else:
            name = "pool_rollout_telemetry" if telemetry else "pool_rollout"
            self._dispatch(name, self.fleet, window, active, tarr, seeds,
                           telemetry=telemetry)
        with phase("pool.rollout"):
            self.fleet, outs, tel = self._launch(k, drive, tarr, active,
                                                 seeds, telemetry, record)
        self.advance_steps(k)
        if not telemetry:
            return outs, None
        return outs, self._telemetry_out(tel)

    def pool_step(self, drives: Mapping[str, Any],
                  timesteps: Optional[int] = None,
                  teach: Optional[Mapping[str, Any]] = None,
                  telemetry: bool = False, record: bool = False):
        """K fused SNN timesteps for the WHOLE pool in ONE rollout launch
        (one a shard).

        The time-fused form of calling `step` K times on held drives, with
        per-session step counters seeding each step of the window exactly
        as K single steps would.  ``timesteps`` defaults to
        ``cfg.timesteps``; occupancy is frozen across the window.

        Returns uid -> (K, act_dim) readout window; with
        ``telemetry=True``, ``(outputs, FleetTelemetry)`` of window means,
        recording the fleet gauges into ``self.metrics``.

        ``record=True`` (needs ``health=HealthConfig(...)``): the window's
        mean telemetry channels write one flight-recorder row and one
        detector update per call (see `step`).
        """
        outs, tel = self._window(drives, timesteps, teach, telemetry,
                                 record)
        outputs = self._rows(outs, axis=1)
        return outputs if tel is None else (outputs, tel)

    def control_step(self, obs: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One CONTROL step = ``cfg.timesteps`` pool timesteps on held
        observations as ONE rollout launch (mirrors `snn.controller_step`:
        mean readout over the window, tanh-squashed unless the readout
        spikes)."""
        outs, _ = self._window(obs, None, None, False)

        def act(o):
            a = o.mean(dim=0)
            return a if self.cfg.spiking_readout else torch.tanh(a)

        if isinstance(outs, _sharding.Sharded):
            return self._rows(_sharding.Sharded(
                [act(p) for p in outs.pieces], 0))
        return self._rows(act(outs))
