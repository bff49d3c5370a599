"""Session health of the PyTorch port (flight recorder, streaming detectors,
recompile watchdog, quarantine -> rollback remediation) on CPU tensors,
against the JAX package called under `jax.jit` on the same numpy inputs,
mirroring tests/test_health.py.

Tolerances: detector flags, streaks, steps, verdicts and the ring cursor
are held exactly; the ring, the EWMA baselines and ``wnorm0`` within rtol =
1e-6 (XLA may contract ``mean + a * d`` into a fused multiply-add and
rewrite ``x / sqrt(v)``; the port rounds each operation once).  The same
incident drill through both schedulers in int8 is held bit for bit where
the datapath is (the verdict step, the steps lost, the continuation), its
incident ring within 1e-6.
"""
import contextlib
import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import snn as JS
from repro.obs import health as JH
from repro.obs import recorder as JR
from repro.scenarios import AnomalyPreset as JAnomalyPreset
from repro.scenarios import inject_anomaly as j_inject
from repro.serving import FleetScheduler as JFleetScheduler
from repro_torch import convert, obs
from repro_torch.checkpoint import manager as TM
from repro_torch.core import snn
from repro_torch.kernels import _build
from repro_torch.obs import health as TH
from repro_torch.obs import recorder as TR
from repro_torch.obs.watchdog import RecompileWatchdog
from repro_torch.obs.watchdog import watchdog as watch
from repro_torch.scenarios import AnomalyPreset, inject_anomaly
from repro_torch.serving import FleetScheduler

RTOL = 1e-6
_OFF = 1e9      # an "effectively disabled" threshold / corridor edge
_NEVER = 9999   # an "effectively disabled" hysteresis count
B = 8
STEPS = 24


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(jax.device_get(x))


# ---- the detectors and the recorder against jitted JAX -----------------------

# warm-up 4, hysteresis ewma_z 3, bound 2, stuck 4, dead 3; window 5 wraps
# four times in 24 steps
HCFG = dict(window=5, warmup=4, hysteresis=(3, 2, 4, 3), dead_floor=1e-3)


def _script(seed=0):
    """(STEPS, B, 4) channels and (STEPS, B) masks, one behaviour a slot:
      0 clean noise            1 sustained burst on channel 0 (steps 12-17)
      2 two-step burst (14-15) 3 out of its sat corridor from step 2 (cold)
      4 frozen from step 6     5 spike rate 0 from step 10
      6 inactive on even steps 7 never active
    Channel 3 is the weight norm (the drift channel to `health_update`)."""
    rng = np.random.RandomState(seed)
    base = np.array([0.3, 0.01, 0.1, 1.0], np.float32)
    x = base + 0.01 * rng.standard_normal((STEPS, B, 4)).astype(np.float32)
    x = np.abs(x).astype(np.float32)
    x[12:18, 1, 0] = 5.0
    x[14:16, 2, 0] = 5.0
    x[2:, 3, 2] = 1.5
    x[6:, 4] = x[6, 4]
    x[10:, 5, 0] = 0.0
    act = np.ones((STEPS, B), bool)
    act[::2, 6] = False
    act[:, 7] = False
    return x, act


def _jax_states(cfg, x, act, recorder=False):
    """Each step's JAX state (jitted) as numpy leaves, and the verdicts."""
    jcfg = JH.HealthConfig(**cfg)
    if recorder:
        fn = jax.jit(functools.partial(JR.recorder_update, jcfg))
        st = JR.init_recorder(jcfg, B)
    else:
        fn = jax.jit(functools.partial(JH.health_update, jcfg))
        st = JH.init_health(jcfg, B)
    out = []
    for t in range(STEPS):
        if recorder:
            st, v = fn(st, jnp.asarray(x[t]), jnp.int32(t),
                       jnp.asarray(act[t]))
        else:
            st, v = fn(st, jnp.asarray(x[t]), jnp.asarray(act[t]))
        out.append(([_np(a) for a in jax.tree.leaves(st)], _np(v)))
    return out


def _assert_state(got, want, exact_from):
    """Leaves in flatten order: floats within RTOL up to `exact_from`, the
    integer and bool leaves from there on exactly."""
    for i, (a, b) in enumerate(zip(got, want)):
        a = _np(a)
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.dtype)
        if i < exact_from:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-9)
        else:
            np.testing.assert_array_equal(a, b)


def test_health_update_matches_jax():
    """24 steps with hysteresis, warm-up gating, latching, a winsorized
    burst and inactive slots: flags, streaks, steps and verdicts exact,
    the baseline within 1e-6."""
    x, act = _script()
    cfg = TH.HealthConfig(**HCFG)
    want = _jax_states(HCFG, x, act)
    h = TH.init_health(cfg, B, device="cpu")
    for t in range(STEPS):
        h, v = TH.health_update(cfg, h, torch.from_numpy(x[t]),
                                torch.from_numpy(act[t]))
        # HealthState: ewma_mean, ewma_var, last, streaks, flagged, steps
        _assert_state(TM.flatten(h)[1], want[t][0], exact_from=3)
        np.testing.assert_array_equal(v.numpy(), want[t][1])
    flags = h.flagged.numpy()
    assert flags[1, 0] and not flags[2, 0]          # sustained vs transient
    assert flags[3, 1] and flags[4, 2] and flags[5, 3]
    assert not flags[7].any() and not flags[0].any()
    assert h.steps.tolist() == [24, 24, 24, 24, 24, 24, 12, 0]
    assert not h.ewma_mean[7].any() and not h.last[7].any()


@pytest.mark.parametrize("window", (5, 64))
def test_recorder_update_matches_jax(window):
    """The ring (wrapping at W = 5), the latched wnorm0 and the detectors
    over the same 24 steps."""
    x, act = _script(1)
    x[:, :, 3] += 0.002 * np.arange(STEPS, dtype=np.float32)[:, None]
    hcfg = dict(HCFG, window=window)
    cfg = TH.HealthConfig(**hcfg)
    want = _jax_states(hcfg, x, act, recorder=True)
    rec = TR.init_recorder(cfg, B, device="cpu")
    for t in range(STEPS):
        rec, v = TR.recorder_update(cfg, rec, torch.from_numpy(x[t]), t,
                                    torch.from_numpy(act[t]))
        # RecorderState: ring, wnorm0, then the HealthState leaves
        _assert_state(TM.flatten(rec)[1], want[t][0], exact_from=5)
        np.testing.assert_array_equal(v.numpy(), want[t][1])
    assert (rec.wnorm0[:7] > 0).all() and rec.wnorm0[7] == 0
    assert not rec.ring[7].any()


def test_reset_slot_and_unroll_ring_across_a_wrap():
    x, act = _script(2)
    cfg = TH.HealthConfig(**HCFG)
    jcfg = JH.HealthConfig(**HCFG)
    rec = TR.init_recorder(cfg, B, device="cpu")
    jrec = JR.init_recorder(jcfg, B)
    jfn = jax.jit(functools.partial(JR.recorder_update, jcfg))
    for t in range(7):               # W = 5: the cursor has wrapped
        rec, _ = TR.recorder_update(cfg, rec, torch.from_numpy(x[t]), t,
                                    torch.from_numpy(act[t]))
        jrec, _ = jfn(jrec, jnp.asarray(x[t]), jnp.int32(t),
                      jnp.asarray(act[t]))
    for slot in (0, 6):
        got = TR.unroll_ring(rec.ring[slot].numpy(), 7, cfg.window)
        want = JR.unroll_ring(_np(jrec.ring[slot]), 7, cfg.window)
        assert got.shape == (5, 4)
        np.testing.assert_allclose(got, want, rtol=RTOL)
        # the newest row is step 6's channels (zeros where inactive)
        np.testing.assert_array_equal(got[-1, :3],
                                      x[6, slot, :3] * act[6, slot])
    assert TR.unroll_ring(rec.ring[0].numpy(), 3, 5).shape == (3, 4)
    assert TR.unroll_ring(rec.ring[0].numpy(), 0, 5).shape == (0, 4)
    before = [a.clone() for a in TM.flatten(rec)[1]]
    assert TR.reset_slot(rec, 3) is rec
    jrec = JR.reset_slot(jrec, jnp.int32(3))
    for a, b, j in zip(TM.flatten(rec)[1], before, jax.tree.leaves(jrec)):
        assert not a[3].any()
        assert torch.equal(torch.cat([a[:3], a[4:]]),
                           torch.cat([b[:3], b[4:]]))
        assert not _np(j)[3].any()


@pytest.mark.parametrize("bad", [dict(window=0), dict(bounds=((0, 1),) * 3),
                                 dict(hysteresis=(1, 2, 3)),
                                 dict(hysteresis=(1, 0, 1, 1))])
def test_health_config_validation_matches_jax(bad):
    with pytest.raises(ValueError) as want:
        JH.HealthConfig(**bad)
    with pytest.raises(ValueError) as got:
        TH.HealthConfig(**bad)
    assert str(got.value) == str(want.value)


def test_convert_round_trips_config_and_recorder_state():
    """A JAX recorder state carried into the port steps on exactly as JAX
    steps it."""
    x, act = _script(3)
    jcfg = JH.HealthConfig(**HCFG)
    cfg = convert.health_config(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jfn = jax.jit(functools.partial(JR.recorder_update, jcfg))
    jrec = JR.init_recorder(jcfg, B)
    for t in range(10):
        jrec, _ = jfn(jrec, jnp.asarray(x[t]), jnp.int32(t),
                      jnp.asarray(act[t]))
    rec = convert.recorder_state(jrec, device="cpu")
    for a, b in zip(TM.flatten(rec)[1], jax.tree.leaves(jrec)):
        np.testing.assert_array_equal(a.numpy(), _np(b))
    for t in range(10, STEPS):
        jrec, jv = jfn(jrec, jnp.asarray(x[t]), jnp.int32(t),
                       jnp.asarray(act[t]))
        rec, v = TR.recorder_update(cfg, rec, torch.from_numpy(x[t]), t,
                                    torch.from_numpy(act[t]))
        _assert_state(TM.flatten(rec)[1],
                      [_np(a) for a in jax.tree.leaves(jrec)], exact_from=5)
        np.testing.assert_array_equal(v.numpy(), _np(jv))


# ---- the weight norm and the fused step's plain version -------------------

def _cfgs(quant, sizes=(8, 12, 4), timesteps=3):
    jcfg = JS.SNNConfig(layer_sizes=sizes, timesteps=timesteps, impl="xla")
    cfg = snn.SNNConfig(layer_sizes=sizes, timesteps=timesteps)
    if quant:
        return JS.quant_config(jcfg), snn.quant_config(cfg)
    return jcfg, cfg


def _rand_fleet(cfg, b, seed):
    st = snn.init_state(cfg, batch=b, fleet=True, device="cpu")
    g = torch.Generator().manual_seed(seed)
    if cfg.quant is not None:
        w = tuple(torch.randint(-127, 128, tuple(a.shape), generator=g,
                                dtype=torch.int32).to(torch.int8)
                  for a in st.w)
        sc = tuple(torch.rand(b, generator=g) / 16 for _ in st.w)
        return dataclasses.replace(st, w=w, w_scale=sc)
    return dataclasses.replace(st, w=tuple(
        torch.randn(tuple(a.shape), generator=g) for a in st.w))


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_network_weight_norm_matches_jax(quant):
    """Within 1e-6: float32 sums in another order; in int8 the integer sums
    are exact in both, but XLA contracts the second layer's ``tot + mean *
    scale`` into a fused multiply-add where the port rounds twice."""
    _, cfg = _cfgs(quant, sizes=(8, 128, 8))
    st = _rand_fleet(cfg, 16, 4)
    jst = JS.init_state(_cfgs(quant, sizes=(8, 128, 8))[0], batch=16,
                        fleet=True)
    jst = dataclasses.replace(
        jst, w=tuple(jnp.asarray(w.numpy()) for w in st.w),
        w_scale=tuple(jnp.asarray(s.numpy()) for s in st.w_scale))
    want = _np(jax.jit(JR.network_weight_norm, static_argnums=1)(jst, quant))
    got = TR.network_weight_norm(st, quant).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL)
    if quant:       # one layer alone: no add to contract, bit for bit
        one = dataclasses.replace(st, w=st.w[:1], w_scale=st.w_scale[:1])
        jone = dataclasses.replace(jst, w=jst.w[:1], w_scale=jst.w_scale[:1])
        np.testing.assert_array_equal(
            TR.network_weight_norm(one, True).numpy(),
            _np(jax.jit(JR.network_weight_norm, static_argnums=1)(jone,
                                                                  True)))


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_record_step_on_cpu_is_the_plain_composition(quant):
    """`record_step` on CPU tensors is `recorder_update` of the telemetry
    and `network_weight_norm`, written into the recorder in place, and no
    kernel launch."""
    _, cfg = _cfgs(quant)
    hcfg = TH.HealthConfig(**HCFG)
    st = _rand_fleet(cfg, B, 5)
    x, act = _script(4)
    tel = obs.FleetTelemetry(*(torch.from_numpy(x[0, :, i].copy())
                               for i in range(3)),
                             occupancy=torch.ones(B))
    rec = TR.init_recorder(hcfg, B, device="cpu")
    ring = rec.ring
    n = TR.record_step.launches
    for t in range(3):
        ch = torch.stack([tel.spike_rate, tel.mean_abs_dw, tel.sat_frac,
                          TR.network_weight_norm(st, quant)], dim=-1)
        want, wv = TR.recorder_update(hcfg, rec, ch, t,
                                      torch.from_numpy(act[t]))
        got, v = TR.record_step(hcfg, rec, st, tel, t,
                                torch.from_numpy(act[t]), quant)
        assert got is rec and got.ring is ring
        for a, b in zip(TM.flatten(got)[1], TM.flatten(want)[1]):
            assert torch.equal(a, b)
        assert torch.equal(v, wv)
    assert TR.record_step.launches == n


def test_obs_exports_the_health_api():
    for name in ("HealthConfig", "HealthState", "health_update",
                 "init_health", "CHANNELS", "DETECTORS", "RecorderState",
                 "init_recorder", "recorder_update", "reset_slot",
                 "network_weight_norm", "unroll_ring", "dump_incident",
                 "RecompileWatchdog", "watchdog", "record_step"):
        assert name in obs.__all__ and hasattr(obs, name), name
    assert obs.CHANNELS == JH.CHANNELS and obs.DETECTORS == JH.DETECTORS
    assert dataclasses.asdict(obs.HealthConfig()) == \
        dataclasses.asdict(JH.HealthConfig())


# ---- the scheduler -----------------------------------------------------------

def _theta(jcfg):
    return JS.init_theta(jcfg, jax.random.PRNGKey(0), scale=0.05)


def _sched(quant=False, slots=4, health=None):
    jcfg, cfg = _cfgs(quant)
    return FleetScheduler(cfg, convert.theta(_theta(jcfg), device="cpu"),
                          slots=slots, device="cpu", health=health)


def _clean_drive(uid: str, t: int = 0) -> np.ndarray:
    """Per-user clean drive, constant across steps (tests/test_health.py)."""
    seed = (sum(ord(c) for c in uid) * 131) & 0x7FFFFFFF
    return (0.5 * np.random.RandomState(seed).standard_normal(8)).astype(
        np.float32)


def _own_step_drives(sched, anomalous=None, preset=None, inject=None):
    """Clean drives keyed on each session's own step counter, so a
    rolled-back session replays the stream its control twin sees."""
    drives = {}
    for uid, slot in sched.user_slot.items():
        t = int(sched._steps[slot])
        d = _clean_drive(uid, t)
        if uid == anomalous:
            d = (inject or inject_anomaly)(preset, d, t)
        drives[uid] = d
    return drives


def _assert_trees_equal(a, b):
    for x, y in zip(TM.flatten(a)[1], TM.flatten(b)[1]):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_record_off_bit_identical(quant):
    """record=True changes no output and no state bit, per step and per
    window; one more signature for each recorded entry point."""
    a = _sched(quant)
    b = _sched(quant, health=TH.HealthConfig())
    for s in (a, b):
        s.admit("u0")
        s.admit("u1")
    for t in range(4):
        drives = {u: _clean_drive(u, t) for u in ("u0", "u1")}
        off, on = a.step(drives), b.step(drives, record=True)
        for u in off:
            assert torch.equal(off[u], on[u])
    drives = {u: _clean_drive(u, 99) for u in ("u0", "u1")}
    off = a.pool_step(drives)
    on, tel = b.pool_step(drives, record=True, telemetry=True)
    for u in off:
        assert torch.equal(off[u], on[u])
    _assert_trees_equal(a.fleet, b.fleet)
    assert b.last_verdict is not None and a.last_verdict is None
    assert b.last_verdict.dtype == torch.bool and b._rec_pos == 5
    assert a.compiled_programs()["pool_step_record"] == 0
    assert b.compiled_programs()["pool_step_record"] == 1
    assert b.compiled_programs()["pool_rollout_record"] == 1
    assert b.compiled_programs()["pool_step_telemetry"] == 0
    assert tel.occupancy.tolist() == [1.0, 1.0, 0.0, 0.0]


def test_record_without_health_raises():
    sched = _sched()
    sched.admit("u0")
    with pytest.raises(ValueError, match="health=HealthConfig"):
        sched.step({"u0": _clean_drive("u0", 0)}, record=True)
    with pytest.raises(ValueError, match="health=HealthConfig"):
        sched.pool_step({"u0": _clean_drive("u0", 0)}, record=True)


def test_quarantine_freezes_slot_bit_exactly():
    sched = _sched(health=TH.HealthConfig())
    sched.admit("a")
    sched.admit("b")
    for t in range(3):
        sched.step({u: _clean_drive(u, t) for u in ("a", "b")})
    slot = sched.quarantine("a")
    frozen = sched._take(sched.pool, slot)
    moving = sched._take(sched.pool, sched.user_slot["b"])
    for t in range(3, 6):
        sched.step({u: _clean_drive(u, t) for u in ("a", "b")}, record=True)
    _assert_trees_equal(frozen, sched._take(sched.pool, slot))
    assert not torch.equal(moving.w[0],
                           sched._take(sched.pool, sched.user_slot["b"]).w[0])
    assert sched.quarantined_slots == frozenset({slot})
    # the recorder saw the frozen slot as inactive: no steps, no rows
    assert sched._rec.health.steps[slot] == 0
    assert not sched._rec.ring[slot].any()


def test_quarantine_error_paths(tmp_path):
    sched = _sched(slots=2)
    sched.admit("a")
    sched.admit("b")
    with pytest.raises(KeyError):
        sched.quarantine("ghost")
    with pytest.raises(RuntimeError, match="not quarantined"):
        sched.rollback("a")
    with pytest.raises(KeyError):
        sched.rollback("ghost")
    sched.quarantine("a")
    with pytest.raises(RuntimeError, match="quarantined"):
        sched.evict("a")
    with pytest.raises(RuntimeError, match="quarantined"):
        sched.save_pool(str(tmp_path))
    # LRU admission never evicts a quarantined resident
    sched.quarantine("b")
    with pytest.raises(RuntimeError, match="pool is full"):
        sched.admit("c", evict_lru=True)
    # without health= there is nothing to read or remediate
    with pytest.raises(ValueError, match="health=HealthConfig"):
        sched._ensure_recorder()
    assert sched.flagged_sessions() == []


def test_remediate_is_noop_on_clean_pool():
    sched = _sched(health=TH.HealthConfig())
    sched.admit("a")
    sched.step({"a": _clean_drive("a", 0)}, record=True)
    assert sched.remediate() == []
    assert _sched().remediate() == []


def test_flagged_sessions_excludes_quarantined():
    """dead_floor = _OFF flags every warm active slot; quarantining one
    removes it from the actionable list."""
    cfg = TH.HealthConfig(window=8, warmup=1, z_threshold=_OFF,
                          bounds=((-_OFF, _OFF),) * 4, dead_floor=_OFF,
                          hysteresis=(_NEVER, _NEVER, _NEVER, 2))
    sched = _sched(health=cfg)
    for u in ("a", "b", "c"):
        sched.admit(u)
    for t in range(4):
        sched.step({u: _clean_drive(u, t) for u in ("a", "b", "c")},
                   record=True)
    assert sched.flagged_sessions() == ["a", "b", "c"]
    assert sched.last_verdict.tolist() == [True, True, True, False]
    sched.quarantine("b")
    assert sched.flagged_sessions() == ["a", "c"]


def test_health_counters_and_load_pool_reset(tmp_path):
    sched = _sched(health=TH.HealthConfig())
    for u in ("a", "b"):
        sched.admit(u)
    sched.step({u: _clean_drive(u, 0) for u in ("a", "b")}, record=True)
    assert sched.health_checkpoint() == 2
    sched.quarantine("a")
    assert sched.health_checkpoint() == 1          # the quarantined skipped
    report = sched.rollback("a")
    assert report == {"uid": "a", "from_slot": 0, "to_slot": 0,
                      "steps_lost": 0}
    snap = sched.metrics.snapshot()
    assert snap["pool_quarantined_total"]["value"] == 1
    assert snap["pool_rollbacks_total"]["value"] == 1
    assert snap["pool_health_checkpoints_total"]["value"] == 2
    sched.save_pool(str(tmp_path))
    sched.load_pool(str(tmp_path))
    assert sched._rec is None and sched._rec_pos == 0
    assert sched.last_verdict is None and sched.quarantined_slots == set()


# ---- the incident drill ------------------------------------------------------

# dead_floor two decades under the clean spike rates, above the int8 pool's
# dither floor (tests/test_health.py)
DRILL = dict(warmup=8, z_threshold=_OFF, bounds=((0.0, _OFF),) * 4,
             dead_floor=1e-2, hysteresis=(_NEVER, _NEVER, _NEVER, 2))
WARM, CONT = 12, 6
USERS = ["u0", "sick", "u2"]
DRILL_PROGRAMS = {"slot_put": 1, "slot_take": 1, "recorder_reset": 1,
                  "pool_step": 0, "pool_rollout": 0,
                  "pool_step_telemetry": 0, "pool_rollout_telemetry": 0,
                  "pool_step_record": 0, "pool_rollout_record": 1}


def _drill(sched, flight_dir, preset, inject, armed):
    """WARM clean recorded windows, a checkpoint, dead input into 'sick'
    until flagged, remediate, CONT windows.  Returns what the drill
    saw."""
    for u in USERS:
        sched.admit(u)
    for _ in range(WARM):
        sched.pool_step(_own_step_drives(sched), record=True)
    sched.admit("tmp")          # a steady pool has churned once
    sched.evict("tmp")
    assert sched.flagged_sessions() == []
    assert sched.health_checkpoint() == len(USERS)
    with armed():
        n_anom = 0
        for _ in range(12):
            sched.pool_step(_own_step_drives(sched, "sick", preset, inject),
                            record=True)
            n_anom += 1
            if "sick" in sched.flagged_sessions():
                break
        flagged = sched.flagged_sessions()
        flags = _np(sched._rec.health.flagged)[sched.user_slot["sick"]] \
            .copy()
        reports = sched.remediate(flight_dir=flight_dir)
        after = (sched.flagged_sessions(), set(sched.quarantined_slots))
        outs = [sched.pool_step(_own_step_drives(sched),
                                record=True)["sick"] for _ in range(CONT)]
    return dict(n_anom=n_anom, flagged=flagged, flags=flags, reports=reports,
                after=after, outs=outs)


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_incident_drill(quant, tmp_path):
    """Clean recorded warm-up -> health_checkpoint -> dead input flags the
    session within its hysteresis budget -> remediate (quarantine +
    incident dump + rollback) -> the continuation equals a manual
    evict-at-checkpoint control bit for bit, with no new signature under
    the armed watchdog and the audit dict pinned."""
    a = _sched(quant, health=TH.HealthConfig(**DRILL))
    watch.install()
    watch.reset()
    got = _drill(a, str(tmp_path), AnomalyPreset("dead_input"), None,
                 watch.armed)
    assert watch.violations == 0, watch.violation_signatures
    assert got["flagged"] == ["sick"] and got["n_anom"] <= 10
    assert got["flags"][TH.DETECTORS.index("dead")]
    (report,) = got["reports"]
    assert report["uid"] == "sick"
    assert report["steps_lost"] == a.cfg.timesteps * got["n_anom"]
    assert got["after"] == ([], set())
    assert a.compiled_programs() == DRILL_PROGRAMS

    doc = json.load(open(report["incident"]))
    assert doc["uid"] == "sick" and doc["verdict"] and doc["flagged"]["dead"]
    assert doc["channels"] == list(TH.CHANNELS)
    assert doc["watchdog"]["violations"] == 0
    npz = np.load(os.path.join(str(tmp_path), doc["npz"]))
    assert npz["ring"].shape == (min(WARM + got["n_anom"], 64), 4)

    b = _sched(quant, health=TH.HealthConfig(**DRILL))
    for u in USERS:
        b.admit(u)
    for _ in range(WARM):
        b.pool_step(_own_step_drives(b))
    b.evict("sick")
    b.admit("sick")
    b_outs = [b.pool_step(_own_step_drives(b))["sick"] for _ in range(CONT)]
    for x, y in zip(got["outs"], b_outs):
        assert torch.equal(x, y)
    _assert_trees_equal(a._take(a.pool, a.user_slot["sick"]),
                        b._take(b.pool, b.user_slot["sick"]))


def test_incident_drill_matches_the_jax_scheduler(tmp_path):
    """The same int8 drill through JAX's FleetScheduler (xla, jitted) and
    the port: verdict step, steps lost and continuation bit for bit, the
    incident JSON's keys equal, its ring within 1e-6."""
    jcfg, _ = _cfgs(True)
    j = JFleetScheduler(jcfg, _theta(jcfg), slots=4,
                        health=JH.HealthConfig(**DRILL))
    t = _sched(True, health=TH.HealthConfig(**DRILL))
    jgot = _drill(j, str(tmp_path / "jax"), JAnomalyPreset("dead_input"),
                  j_inject, contextlib.nullcontext)
    tgot = _drill(t, str(tmp_path / "port"), AnomalyPreset("dead_input"),
                  None, contextlib.nullcontext)
    assert tgot["n_anom"] == jgot["n_anom"]
    assert tgot["flagged"] == jgot["flagged"] == ["sick"]
    np.testing.assert_array_equal(tgot["flags"], jgot["flags"])
    (tr,), (jr,) = tgot["reports"], jgot["reports"]
    assert {k: v for k, v in tr.items() if k != "incident"} == \
        {k: v for k, v in jr.items() if k != "incident"}
    for x, y in zip(tgot["outs"], jgot["outs"]):
        np.testing.assert_array_equal(x.numpy(), _np(y))
    tdoc, jdoc = (json.load(open(r["incident"])) for r in (tr, jr))
    assert set(tdoc) == set(jdoc)
    for k in ("uid", "slot", "pos", "channels", "detectors", "verdict",
              "flagged", "streaks", "recorded_steps", "config"):
        assert json.loads(json.dumps(tdoc[k])) == \
            json.loads(json.dumps(jdoc[k])), k
    tnpz = np.load(str(tmp_path / "port" / tdoc["npz"]))
    jnpz = np.load(str(tmp_path / "jax" / jdoc["npz"]))
    assert set(tnpz.files) == set(jnpz.files)
    np.testing.assert_allclose(tnpz["ring"], jnpz["ring"], rtol=RTOL,
                               atol=1e-6)
    for k in ("streaks", "flagged"):
        np.testing.assert_array_equal(tnpz[k], jnpz[k])
    np.testing.assert_allclose(tnpz["wnorm0"], jnpz["wnorm0"], rtol=RTOL)
    _assert_trees_equal(t.fleet, convert.network_state(j.fleet,
                                                       device="cpu"))


# ---- the recompile watchdog --------------------------------------------------

def test_watchdog_is_silent_until_installed():
    w = RecompileWatchdog()
    w.arm()
    w.notify("FleetScheduler.pool_step")
    assert (w.compiles, w.violations) == (0, 0)
    assert w.install() is w and w.install() is w         # idempotent
    w.notify("FleetScheduler.pool_step")
    assert (w.compiles, w.violations) == (1, 1)
    w.disarm()
    w.reset()
    assert (w.compiles, w.violations, w.last_signature) == (0, 0, None)


def test_watchdog_names_a_new_signature_and_ignores_repeats():
    """A new static signature while armed names its entry point; repeated
    calls of a warm entry point never fire; counters reach the registry."""
    sched = _sched(health=TH.HealthConfig())
    watch.install(registry=sched.metrics)
    watch.install()                                    # idempotent
    sched.admit("a")
    drives = {"a": _clean_drive("a", 0)}
    sched.pool_step(drives)                            # warm-up
    watch.reset()
    with watch.armed():
        assert watch.is_armed
        for _ in range(3):
            sched.pool_step(drives)
        assert watch.violations == 0
        sched.pool_step(drives, record=True)
        sched.pool_step(drives, record=True)
    assert not watch.is_armed
    assert watch.violations == 1
    assert watch.violation_signatures == ["FleetScheduler.pool_rollout_record"]
    assert watch.last_signature == "FleetScheduler.pool_rollout_record"
    sched.step(drives)                                 # disarmed: counted
    assert (watch.compiles, watch.violations) == (2, 1)
    snap = sched.metrics.snapshot()
    assert snap["recompiles_after_warmup_total"]["value"] >= 1
    assert snap["compiles_total"]["value"] >= 2


def test_watchdog_reports_a_library_loaded_once(monkeypatch, tmp_path):
    """The kernel loader reports a library's first load in the process as
    ``library:<source>`` and never again."""
    monkeypatch.setattr(_build, "build_all", lambda: {})
    monkeypatch.setattr(_build, "_target", lambda s: tmp_path / s)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(_build, "_libs", {})
    watch.install()
    watch.reset()
    with watch.armed():
        lib = _build.library("recorder.cu")
        assert _build.library("recorder.cu") is lib
    assert watch.violation_signatures == ["library:recorder.cu"]
    assert "recorder.cu" in _build.SOURCES

