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
stays constant under churn.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.core import snn
from repro_torch.core.engine import NetworkState
from repro_torch.obs import MetricsRegistry, phase
from repro_torch.obs.telemetry import record_fleet_telemetry
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


def _signature(*operands, **flags) -> tuple:
    """Static signature of one dispatch: each operand leaf's shape, dtype
    and device (None for an absent operand) and the flags."""
    sig = []
    for op in operands:
        leaves = _ckpt.flatten(op)[1] if op is not None else [None]
        sig.append(tuple(None if t is None else
                         (tuple(t.shape), t.dtype, t.device) for t in leaves))
    return tuple(sig) + tuple(sorted(flags.items()))


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
    """

    # entry points of the static-signature audit, registered at 0
    ENTRY_POINTS = ("slot_put", "slot_take")

    def __init__(self, pool, axes, slots: int,
                 store: Optional[SessionStore] = None,
                 registry: Optional[MetricsRegistry] = None):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        self.slots = slots
        self.metrics = registry if registry is not None else MetricsRegistry()
        self.store = (store if store is not None
                      else SessionStore(registry=self.metrics))
        self.pool = pool
        self.device = _ckpt.flatten(pool)[1][0].device
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
        # The fault-tolerance and session-health metrics of the JAX pools,
        # under the same names so both export one schema; they stay at 0
        # until those subsystems are ported.
        self.metrics.counter("pool_device_failures_total",
                             "device shards marked lost")
        self.metrics.counter("pool_drained_sessions_total",
                             "sessions re-homed off a lost shard")
        self.metrics.histogram("pool_drain_seconds",
                               "drain latency (restore + re-admit, per "
                               "drain_failed call)")
        self.metrics.counter("pool_quarantined_total",
                             "sessions quarantined as unhealthy")
        self.metrics.counter("pool_rollbacks_total",
                             "quarantined sessions rolled back to their "
                             "last healthy checkpoint")
        self.metrics.counter("pool_health_checkpoints_total",
                             "health_checkpoint() sweeps (rollback restore "
                             "points)")

    def _dispatch(self, name: str, *operands, **flags) -> None:
        """Record the static signature of one call of entry point `name`."""
        self._signatures[name].add(_signature(*operands, **flags))

    # ---- occupancy -------------------------------------------------------

    @property
    def active_users(self) -> list:
        return [u for u in self.slot_user if u is not None]

    @property
    def free_slots(self) -> int:
        return sum(1 for u in self.slot_user if u is None)

    def _active_mask(self) -> torch.Tensor:
        mask = np.fromiter((u is not None for u in self.slot_user),
                           np.bool_, self.slots)
        return torch.from_numpy(mask).to(self.device)

    def compiled_programs(self) -> Dict[str, int]:
        """Per-entry-point counts of distinct static signatures dispatched:
        {name: signatures}.  Every entry point is listed, unused ones at 0."""
        return {name: len(s) for name, s in self._signatures.items()}

    def compile_count(self) -> int:
        """Total static signatures dispatched by the pool's entry points."""
        return sum(self.compiled_programs().values())

    def pool_nbytes(self) -> int:
        """Resident bytes of the pool tree (all leaves): an int8 pool holds
        about 4x more sessions per byte than a float32 one."""
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
        free = [s for s in range(self.slots) if self.slot_user[s] is None]
        if not free:
            if not evict_lru:
                raise RuntimeError(
                    f"pool is full ({self.slots} slots); pass "
                    "evict_lru=True or evict a session first")
            lru = min(range(self.slots), key=lambda s: self._admit_seq[s])
            self.evict(self.slot_user[lru])
            free = [lru]
        slot = free[0]
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
        self._m_admissions.inc()
        self._m_occupancy.set(len(self.user_slot) / self.slots)
        return slot

    def evict(self, uid: str) -> None:
        """Swap `uid` out, persist it durably, and clear its slot."""
        slot = self.user_slot.get(uid)
        if slot is None:
            raise KeyError(f"session {uid!r} is not in the pool")
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
        self.evictions += 1
        self._m_evictions.inc()
        self._m_occupancy.set(len(self.user_slot) / self.slots)

    def advance_steps(self, k: int) -> None:
        """Advance every admitted session's host-side step counter by k."""
        for slot in self.user_slot.values():
            self._steps[slot] += k

    def persist_resident(self) -> int:
        """Durably snapshot every resident session WITHOUT evicting it
        (`SessionStore.persist`; the warm cache is untouched).  Returns the
        number of sessions persisted."""
        n = 0
        for uid, slot in list(self.user_slot.items()):
            user = self._take_slot(slot)
            user = self._finalize_session(user, int(self._steps[slot]))
            self.store.persist(uid, user, int(self._steps[slot]))
            n += 1
        return n

    # ---- whole-pool checkpointing ----------------------------------------

    def save_pool(self, directory: str) -> str:
        """Checkpoint the WHOLE pool — resident sessions in place — plus the
        occupancy bookkeeping, in the `checkpoint.manager` layout."""
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
        """Resume a `save_pool` checkpoint into this pool: occupancy,
        per-session step counters and LRU order resume exactly."""
        tree, _, extra = _ckpt.load_checkpoint(directory, self.pool,
                                               step=step, device=self.device)
        if int(extra["slots"]) != self.slots:
            raise ValueError(
                f"checkpointed pool has {extra['slots']} slots; this pool "
                f"has {self.slots}")
        self.pool = tree
        self.slot_user = list(extra["slot_user"])
        self.user_slot = {u: s for s, u in enumerate(self.slot_user)
                          if u is not None}
        self._steps = np.asarray(extra["steps"], np.int64).copy()
        self._admit_seq = np.asarray(extra["admit_seq"], np.int64).copy()
        self._seq = int(extra["seq"])
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
    """

    ENTRY_POINTS = SessionPool.ENTRY_POINTS + (
        "pool_step", "pool_rollout", "pool_step_telemetry",
        "pool_rollout_telemetry")

    def __init__(self, cfg: snn.SNNConfig, theta, slots: int,
                 store: Optional[SessionStore] = None,
                 registry: Optional[MetricsRegistry] = None, device=None):
        self.cfg = cfg
        self.theta = theta
        fleet = snn.init_state(cfg, batch=slots, fleet=True, device=device)
        super().__init__(fleet, _network_axes(fleet), slots, store, registry)

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
            tarr = torch.from_numpy(tarr).to(self.device)
        return torch.from_numpy(drive).to(self.device), tarr

    def _seeds(self) -> torch.Tensor:
        """Per-SESSION step counters: in a quantized pool they drive the
        stochastic round, so a session's update stream follows the session
        across evictions and slots, never the pool clock."""
        return torch.from_numpy(self._steps.astype(np.int32)).to(self.device)

    def _rows(self, out: torch.Tensor, axis: int = 0) -> dict:
        return {uid: out.select(axis, slot)
                for uid, slot in self.user_slot.items()}

    def step(self, drives: Mapping[str, Any],
             teach: Optional[Mapping[str, Any]] = None,
             telemetry: bool = False):
        """One fused SNN timestep for the WHOLE pool (one fleet-step launch
        per layer).

        `drives` maps uid -> input drive ``(obs_dim,)`` (already encoded).
        Every admitted session must receive a drive; vacant slots get zero
        drive and are frozen by the active mask.  Returns uid -> readout
        row.  ``telemetry=True`` launches the telemetry variants and returns
        ``(outputs, FleetTelemetry)``, recording the fleet gauges into
        ``self.metrics``.
        """
        drive, tarr = self._gather_rows(drives, teach)
        active, seeds = self._active_mask(), self._seeds()
        name = "pool_step_telemetry" if telemetry else "pool_step"
        self._dispatch(name, self.fleet, drive, active, tarr, seeds,
                       telemetry=telemetry)
        with phase("pool.step"):
            res = snn.timestep(self.cfg, self.fleet, self.theta, drive,
                               teach=tarr, active=active, seed=seeds,
                               telemetry=telemetry)
        self.fleet = res[0]
        self.advance_steps(1)
        outputs = self._rows(res[1])
        if not telemetry:
            return outputs
        record_fleet_telemetry(self.metrics, res[2])
        return outputs, res[2]

    def _window(self, drives, timesteps, teach, telemetry):
        k = self.cfg.timesteps if timesteps is None else int(timesteps)
        if k < 1:
            raise ValueError(f"pool_step needs timesteps >= 1, got {k}")
        drive, tarr = self._gather_rows(drives, teach)
        window = drive[None].expand(k, *drive.shape)
        active, seeds = self._active_mask(), self._seeds()
        name = "pool_rollout_telemetry" if telemetry else "pool_rollout"
        self._dispatch(name, self.fleet, window, active, tarr, seeds,
                       telemetry=telemetry)
        with phase("pool.rollout"):
            res = snn.rollout_window(self.cfg, self.fleet, self.theta, window,
                                     teach=tarr, active=active, seed=seeds,
                                     telemetry=telemetry)
        self.fleet = res[0]
        self.advance_steps(k)
        if not telemetry:
            return res[1], None
        record_fleet_telemetry(self.metrics, res[2])
        return res[1], res[2]

    def pool_step(self, drives: Mapping[str, Any],
                  timesteps: Optional[int] = None,
                  teach: Optional[Mapping[str, Any]] = None,
                  telemetry: bool = False):
        """K fused SNN timesteps for the WHOLE pool in ONE rollout launch.

        The time-fused form of calling `step` K times on held drives, with
        per-session step counters seeding each step of the window exactly
        as K single steps would.  ``timesteps`` defaults to
        ``cfg.timesteps``; occupancy is frozen across the window.

        Returns uid -> (K, act_dim) readout window; with
        ``telemetry=True``, ``(outputs, FleetTelemetry)`` of window means,
        recording the fleet gauges into ``self.metrics``.
        """
        outs, tel = self._window(drives, timesteps, teach, telemetry)
        outputs = self._rows(outs, axis=1)
        return outputs if tel is None else (outputs, tel)

    def control_step(self, obs: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        """One CONTROL step = ``cfg.timesteps`` pool timesteps on held
        observations as ONE rollout launch (mirrors `snn.controller_step`:
        mean readout over the window, tanh-squashed unless the readout
        spikes)."""
        outs, _ = self._window(obs, None, None, False)
        actions = outs.mean(dim=0)
        if not self.cfg.spiking_readout:
            actions = torch.tanh(actions)
        return self._rows(actions)
