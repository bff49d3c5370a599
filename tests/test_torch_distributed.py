"""Sharded session pools of the PyTorch port on CPU shards, mirroring
tests/test_distributed.py, and against the JAX package itself:

  1. placement — `fleet_mesh` bounds, slot s on shard ``s * D // B``, a
     shard count that does not divide the slots refused;
  2. mesh transparency — a one-shard pool is the unmeshed pool bit for bit,
     the telemetry and record variants included;
  3. shard parity — D = 2 and 4 shards (`fleet_mesh(devices=["cpu"] * D)`)
     bit for bit against the unmeshed port pool, float32 and int8;
  4. device loss — `fail_device` / `fail_slots` poison a shard, the poison
     never reaches a survivor and a stranded output is exactly 0, lost
     slots are never admitted, evicted or counted free, `drain_failed`
     re-homes their sessions from the store with `steps_lost` the steps
     after the snapshot; the same churn -> `persist_resident` ->
     `fail_device` -> `drain_failed` script through JAX's unmeshed
     `FleetScheduler` (jitted, xla) gives the same pool: int8 bit for bit,
     float32 within 1e-5;
  5. elastic re-mesh — `save_pool` at D = 4, `load_pool` at D = 2 and
     unmeshed, bit for bit; JAX's `save_pool` files resumed by the port at
     D = 2 and the port's at D = 4 read by JAX's `load_pool`;
  6. session health under a mesh — record parity, quarantine -> rollback,
     and no new static signature under churn, drain and re-mesh;
  7. the LM decode pool at D = 2 giving the unmeshed tokens (dense smoke
     LM), and refusing the moe layout across shards.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import snn as JS
from repro.serving import FleetScheduler as JFleetScheduler
from repro.serving import SessionStore as JSessionStore
from repro_torch import convert
from repro_torch.checkpoint import manager as TM
from repro_torch.core import snn
from repro_torch.core.engine import fleet_spmd
from repro_torch.distributed import (Sharded, elastic_restore, fleet_mesh,
                                     pool_shardings, slot_pspec)
from repro_torch.distributed import sharding as dsh
from repro_torch.obs import HealthConfig
from repro_torch.obs.watchdog import watchdog as watch
from repro_torch.serving import SHARED, FleetScheduler, SessionStore

SIZES = (8, 16, 4)
QUANT = pytest.mark.parametrize("quant", (False, True),
                                ids=("float32", "int8"))
USERS = [f"u{i}" for i in range(6)]

# recording on, every detector off: parity wants the recorder running
# without any verdict-driven divergence
HEALTH_OFF = HealthConfig(z_threshold=1e9, bounds=((-1e9, 1e9),) * 4,
                          dead_floor=-1.0, hysteresis=(9999,) * 4)


def _mesh(d):
    return fleet_mesh(devices=["cpu"] * d)


def _drive(uid, t, n=SIZES[0]):
    """A deterministic drive per (session, time), the same in every
    process (no string hashing)."""
    phase = (sum(map(ord, uid)) % 97) / 97.0
    return np.sin(0.3 * t + phase + np.arange(n)).astype(np.float32) * 1.5


def _cfg(quant):
    cfg = snn.SNNConfig(layer_sizes=SIZES, timesteps=2)
    return snn.quant_config(cfg) if quant else cfg


def _sched(quant, slots=8, d=None, store=None, health=None, theta=None):
    cfg = _cfg(quant)
    if theta is None:
        theta = snn.init_theta(cfg, torch.Generator().manual_seed(0),
                               scale=0.05)
    kw = dict(device="cpu") if d is None else dict(mesh=_mesh(d))
    return FleetScheduler(cfg, theta, slots=slots,
                          store=store if store is not None else
                          SessionStore(), health=health, **kw)


def _leaves(tree):
    return TM.flatten(dsh.gather(tree))[1]


def _assert_outputs_equal(a, b):
    assert a.keys() == b.keys()
    for u in a:
        assert torch.equal(a[u].cpu(), b[u].cpu()), u


def _assert_trees_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _admit_all(pools, users=USERS):
    for s in pools:
        for u in users:
            s.admit(u)


# ---- 1. placement -----------------------------------------------------------


class TestPlacement:
    def test_fleet_mesh_shape_and_axis(self):
        mesh = fleet_mesh(1, device="cpu")
        assert mesh.axis_names == ("data",) and mesh.shape == {"data": 1}
        assert _mesh(4).size == 4
        assert _mesh(4).devices == (torch.device("cpu"),) * 4

    def test_fleet_mesh_bounds(self):
        for n in (0, 2):            # the CPU is one device
            with pytest.raises(ValueError, match="num_devices"):
                fleet_mesh(n, device="cpu")
        with pytest.raises(ValueError):
            fleet_mesh(devices=[])
        visible = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        with pytest.raises(ValueError, match="not visible"):
            fleet_mesh(devices=[f"cuda:{visible}"])
        if visible:
            with pytest.raises(ValueError):
                fleet_mesh(visible + 1)
        else:
            # no card: the default mesh raises rather than falling back
            with pytest.raises(RuntimeError, match="CUDA"):
                fleet_mesh()

    def test_slot_pspec(self):
        assert slot_pspec(0) == ("data",)
        assert slot_pspec(2) == (None, None, "data")
        assert slot_pspec(SHARED) == () and slot_pspec(None) == ()
        assert slot_pspec(True) == ()      # a bool is never a slot axis

    def test_pool_shardings_follow_axes_tree(self):
        sh = pool_shardings(_mesh(2), {"w": (0, 0), "cache": 2,
                                       "clock": SHARED})
        assert sh["w"][0].spec == ("data",) and sh["w"][0].axis == 0
        assert sh["cache"].spec == (None, None, "data")
        assert sh["clock"].spec == () and sh["clock"].axis is None
        x = torch.arange(3 * 2 * 8).reshape(3, 2, 8)
        placed = sh["cache"].place(x)
        assert isinstance(placed, Sharded) and placed.shape == x.shape
        assert [tuple(p.shape) for p in placed.pieces] == [(3, 2, 4)] * 2
        assert torch.equal(placed.gather(), x)
        assert torch.equal(placed.select(2, 5), x[:, :, 5])
        assert sh["clock"].place(x) is x

    def test_contiguous_slot_blocks(self):
        s = _sched(False, slots=8, d=4)
        assert [s.slot_device(i) for i in range(8)] == \
            [i * 4 // 8 for i in range(8)] == [0, 0, 1, 1, 2, 2, 3, 3]
        assert list(s.device_slots(2)) == [4, 5]
        with pytest.raises(ValueError):
            s.device_slots(4)
        w = s.fleet.w[0]
        assert isinstance(w, Sharded) and len(w.pieces) == 4
        assert all(p.shape == (2,) + tuple(w.shape[1:]) for p in w.pieces)
        # the clock is pool-global: one whole tensor
        assert isinstance(s.fleet.t, torch.Tensor)
        assert s.pool_nbytes() == _sched(False, slots=8).pool_nbytes()

    def test_pool_mesh_validation(self):
        with pytest.raises(ValueError, match="divide"):
            _sched(False, slots=6, d=4)
        cfg = _cfg(False)
        th = snn.init_theta(cfg, torch.Generator().manual_seed(0))
        with pytest.raises(ValueError, match="not both"):
            FleetScheduler(cfg, th, slots=4, device="cpu", mesh=_mesh(2))

    def test_fleet_spmd_maps_slots_and_refuses_replicated_outputs(self):
        f = fleet_spmd(lambda x, y, s: (x * s, y + 1), _mesh(2),
                       in_axes=(0, 1, None), out_axes=(0, 1))
        a, b = f(torch.arange(4.0), torch.zeros(3, 4), torch.tensor(2.0))
        assert torch.equal(a.gather(), torch.arange(4.0) * 2)
        assert b.axis == 1 and torch.equal(b.gather(), torch.ones(3, 4))
        with pytest.raises(ValueError, match="slot-mapped"):
            fleet_spmd(lambda x: x, _mesh(2), in_axes=(0,), out_axes=(None,))

    def test_checkpoint_of_a_sharded_tree_is_whole(self, tmp_path):
        tree = {"w": torch.arange(16.0).reshape(8, 2), "t": torch.tensor(3)}
        axes = {"w": 0, "t": SHARED}
        sharded = dsh.shard(tree, pool_shardings(_mesh(4), axes))
        TM.save_checkpoint(str(tmp_path), 1, sharded)
        plain, _, _ = TM.load_checkpoint(str(tmp_path), tree)
        _assert_trees_equal(plain, tree)
        two, step, _ = elastic_restore(
            str(tmp_path), sharded, _mesh(2),
            lambda mesh: pool_shardings(mesh, axes))
        assert step == 1 and len(two["w"].pieces) == 2
        _assert_trees_equal(two, tree)


# ---- 2. and 3. one shard and many, against the unmeshed pool ----------------


@QUANT
@pytest.mark.parametrize("d", (1, 2, 4))
def test_sharded_pool_is_the_unmeshed_pool(quant, d):
    ref, m = _sched(quant), _sched(quant, d=d)
    _admit_all((ref, m))
    for t in range(2):
        dd = {u: _drive(u, t) for u in USERS}
        _assert_outputs_equal(ref.step(dict(dd)), m.step(dict(dd)))
    dd = {u: _drive(u, 5) for u in USERS}
    _assert_outputs_equal(ref.pool_step(dict(dd), timesteps=3),
                          m.pool_step(dict(dd), timesteps=3))
    # churn: evict -> re-admit round trips through the shards
    for s in (ref, m):
        s.evict("u1")
        s.evict("u4")
        s.admit("u4")
        s.admit("x")
        s.admit("u1")
    users = ref.active_users
    dd = {u: _drive(u, 7) for u in users}
    _assert_outputs_equal(ref.control_step(dict(dd)),
                          m.control_step(dict(dd)))
    for variant in ("step", "pool_step"):
        dd = {u: _drive(u, 9) for u in users}
        o1, t1 = getattr(ref, variant)(dict(dd), telemetry=True)
        o2, t2 = getattr(m, variant)(dict(dd), telemetry=True)
        _assert_outputs_equal(o1, o2)
        _assert_trees_equal(t1, t2)
    _assert_trees_equal(ref.pool, m.pool)
    assert ref.compiled_programs() == m.compiled_programs()


@pytest.mark.parametrize("d", (1, 4))
@QUANT
def test_record_parity_and_rollback_under_a_mesh(quant, d):
    """Recording, quarantine and rollback on a meshed pool are those of
    the unmeshed pool bit for bit: the recorder splits over the slot axis,
    the quarantine freeze is the same mask, and the rolled-back session
    resumes the same checkpoint."""
    ref = _sched(quant, health=HEALTH_OFF)
    m = _sched(quant, d=d, health=HEALTH_OFF)
    _admit_all((ref, m))
    for t in range(3):
        dd = {u: _drive(u, t) for u in USERS}
        _assert_outputs_equal(ref.step(dict(dd), record=True),
                              m.step(dict(dd), record=True))
    dd = {u: _drive(u, 4) for u in USERS}
    _assert_outputs_equal(ref.pool_step(dict(dd), timesteps=3, record=True),
                          m.pool_step(dict(dd), timesteps=3, record=True))
    _assert_trees_equal(ref._rec, m._rec)
    assert torch.equal(dsh.host(ref.last_verdict), dsh.host(m.last_verdict))
    if d > 1:
        assert isinstance(m._rec.ring, Sharded)
        assert len(m._rec.ring.pieces) == d
    for s in (ref, m):
        assert s.health_checkpoint() == len(USERS)
        s.quarantine("u2")
    for t in range(5, 7):       # u2 frozen on both pools
        dd = {u: _drive(u, t) for u in USERS}
        _assert_outputs_equal(ref.step(dict(dd), record=True),
                              m.step(dict(dd), record=True))
    ra, rb = ref.rollback("u2"), m.rollback("u2")
    assert ra == rb and ra["steps_lost"] == 2
    for t in range(7, 9):
        dd = {u: _drive(u, t) for u in USERS}
        _assert_outputs_equal(ref.step(dict(dd), record=True),
                              m.step(dict(dd), record=True))
    _assert_trees_equal(ref.pool, m.pool)
    _assert_trees_equal(ref._rec, m._rec)
    assert ref.flagged_sessions() == m.flagged_sessions() == []


# ---- 4. device loss ---------------------------------------------------------


@QUANT
def test_poison_is_isolated_and_stranded_outputs_are_zero(quant):
    ctrl, vict = _sched(quant), _sched(quant, d=2)
    _admit_all((ctrl, vict))
    stranded = vict.fail_device(0, poison=True)
    assert stranded == ["u0", "u1", "u2", "u3"]
    assert vict.stranded_sessions() == stranded
    w = vict.fleet.w[0].pieces[0]
    if quant:
        assert bool((w == 127).all())
    else:
        assert bool(w.isnan().all())
    dd = {u: _drive(u, 0) for u in USERS}
    for variant in ("step", "pool_step"):
        oc, tc = getattr(ctrl, variant)(dict(dd), telemetry=True)
        ov, tv = getattr(vict, variant)(dict(dd), telemetry=True)
        for u in ("u4", "u5"):
            assert torch.equal(ov[u], oc[u])
        for u in stranded:       # masked to exact zeros, not NaN
            assert bool((ov[u] == 0).all()), u
        for x in TM.flatten(tv)[1]:
            assert bool(x.isfinite().all()) and bool((x[:4] == 0).all())
    assert vict.metrics.snapshot()["pool_device_failures_total"]["value"] == 1


def test_lost_slots_are_never_admitted_or_evicted():
    s = _sched(False, slots=2, d=2)
    s.admit("a")
    s.fail_slots([s.user_slot["a"]], poison=True)
    with pytest.raises(RuntimeError, match="drain_failed"):
        s.evict("a")
    with pytest.raises(RuntimeError, match="drain_failed"):
        s.quarantine("a")
    s.admit("b")                       # lands in the surviving slot
    assert s.user_slot["b"] != s.user_slot["a"]
    assert s.free_slots == 0 and s.lost_slots == {0}
    with pytest.raises(RuntimeError, match="full"):
        s.admit("c")
    # LRU eviction never picks the lost slot either
    s2 = _sched(False, slots=2, d=2)
    s2.admit("x")
    s2.admit("y")
    s2.fail_slots([s2.user_slot["x"]], poison=True)
    s2.admit("z", evict_lru=True)      # evicts y, never lost x
    assert "x" in s2.user_slot and "y" not in s2.user_slot


def test_steps_lost_are_the_steps_after_the_snapshot():
    s = _sched(False, d=2)
    s.admit("a")
    for t in range(3):
        s.step({"a": _drive("a", t)})
    s.persist_resident()
    for t in range(3, 7):              # 4 steps past the snapshot
        s.step({"a": _drive("a", t)})
    s.fail_device(0)
    rep = s.drain_failed()
    assert rep == [{"uid": "a", "from_slot": 0, "to_slot": 4,
                    "from_device": 0, "to_device": 1, "steps_lost": 4}]
    assert int(s._steps[s.user_slot["a"]]) == 3   # resumed at the snapshot
    assert s.metrics.snapshot()["pool_drained_sessions_total"]["value"] == 1
    # a never-persisted session restarts from the factory state
    s.admit("b")
    s.step({"a": _drive("a", 9), "b": _drive("b", 0)})
    s.fail_slots([s.user_slot["b"]])
    assert s.drain_failed()[0]["steps_lost"] == 1
    fresh = _sched(False)
    fresh.admit("b")
    got = s.step({"a": _drive("a", 10), "b": _drive("b", 0)})["b"]
    assert torch.equal(got, fresh.step({"b": _drive("b", 0)})["b"])


@pytest.mark.parametrize("durable", (False, True), ids=("ram", "disk"))
def test_drained_sessions_continue_bit_for_bit(durable, tmp_path):
    store = (lambda n: SessionStore(root=str(tmp_path / n))) if durable \
        else (lambda n: SessionStore())
    ctrl = _sched(True, store=store("c"))
    m = _sched(True, d=4, store=store("m"))
    _admit_all((ctrl, m))
    for t in range(2):
        dd = {u: _drive(u, t) for u in USERS}
        _assert_outputs_equal(ctrl.step(dict(dd)), m.step(dict(dd)))
    m.persist_resident()
    stranded = m.fail_device(1, poison=True)
    assert stranded == ["u2", "u3"]
    rep = m.drain_failed()
    assert [(r["uid"], r["from_device"], r["to_device"], r["steps_lost"])
            for r in rep] == [("u2", 1, 3, 0), ("u3", 1, 3, 0)]
    assert m.stranded_sessions() == [] and m.lost_slots == {2, 3}
    for t in range(2, 5):
        dd = {u: _drive(u, t) for u in USERS}
        _assert_outputs_equal(ctrl.step(dict(dd)), m.step(dict(dd)))
        _assert_outputs_equal(ctrl.pool_step(dict(dd)), m.pool_step(dict(dd)))


def test_save_pool_refuses_stranded_sessions_and_other_slot_counts(tmp_path):
    s = _sched(False, d=2)
    s.admit("a")
    s.fail_slots([s.user_slot["a"]])
    with pytest.raises(RuntimeError, match="drain"):
        s.save_pool(str(tmp_path / "a"))
    s.drain_failed()
    s.save_pool(str(tmp_path / "a"))   # a drained pool checkpoints
    other = _sched(False, slots=4, d=2)
    with pytest.raises(ValueError, match="slots|shape mismatch"):
        other.load_pool(str(tmp_path / "a"))


# ---- 5. elastic re-mesh -----------------------------------------------------


@QUANT
def test_elastic_restore_across_shard_counts(quant, tmp_path):
    src = _sched(quant, d=4)
    _admit_all((src,))
    for t in range(3):
        src.step({u: _drive(u, t) for u in USERS})
    src.evict("u3")
    src.save_pool(str(tmp_path))
    for d in (2, None):
        tgt = _sched(quant, d=d)
        tgt.load_pool(str(tmp_path))
        assert tgt.slot_user == src.slot_user
        assert tgt._steps.tolist() == src._steps.tolist()
        _assert_trees_equal(tgt.pool, src.pool)
        dd = {u: _drive(u, 9) for u in src.active_users}
        _assert_outputs_equal(src.pool_step(dict(dd), timesteps=2),
                              tgt.pool_step(dict(dd), timesteps=2))
        _assert_trees_equal(tgt.pool, src.pool)
        src.load_pool(str(tmp_path))   # rewind for the next target


# ---- 6. signatures under churn, drain and re-mesh ---------------------------


def test_no_new_signatures_under_churn_drain_and_remesh(tmp_path):
    m = _sched(False, d=4, health=HEALTH_OFF)
    _admit_all((m,))
    m.step({u: _drive(u, 0) for u in USERS}, record=True)
    m.pool_step({u: _drive(u, 1) for u in USERS}, timesteps=3, record=True)
    m.step({u: _drive(u, 2) for u in USERS})
    m.pool_step({u: _drive(u, 3) for u in USERS}, timesteps=3)
    m.evict("u0")
    m.admit("u0")
    m.persist_resident()
    m.save_pool(str(tmp_path))
    tgt = _sched(False, d=2, health=HEALTH_OFF)
    tgt.load_pool(str(tmp_path))
    tgt.step({u: _drive(u, 2) for u in tgt.active_users}, record=True)
    tgt.evict("u0")
    tgt.admit("u0")
    warm_m, warm_t = m.compiled_programs(), tgt.compiled_programs()
    watch.install()
    watch.reset()
    with watch.armed():
        for t in range(3):
            m.evict("u1")
            m.admit(f"g{t}")
            m.step({u: _drive(u, t) for u in m.active_users}, record=True)
            m.pool_step({u: _drive(u, 50 + t) for u in m.active_users},
                        timesteps=3, record=True)
            m.evict(f"g{t}")
            m.admit("u1")
        m.persist_resident()
        m.fail_device(0)
        m.drain_failed()
        m.step({u: _drive(u, 60) for u in m.active_users}, record=True)
        m.pool_step({u: _drive(u, 61) for u in m.active_users}, timesteps=3)
        tgt.load_pool(str(tmp_path))
        tgt.step({u: _drive(u, 9) for u in tgt.active_users}, record=True)
    assert watch.violations == 0, watch.violation_signatures
    assert m.compiled_programs() == warm_m
    assert tgt.compiled_programs() == warm_t


# ---- against the JAX package ------------------------------------------------


def _jax_sched(quant, slots=8, root=None, theta_seed=3):
    jcfg = JS.SNNConfig(layer_sizes=SIZES, timesteps=2, impl="xla")
    if quant:
        jcfg = JS.quant_config(jcfg)
    jtheta = JS.init_theta(jcfg, jax.random.PRNGKey(theta_seed), scale=0.05)
    return JFleetScheduler(jcfg, jtheta, slots=slots,
                           store=JSessionStore(root=root)), jtheta


def _jax_pair(quant, d, root=None):
    jsched, jtheta = _jax_sched(quant, root=root)
    tsched = _sched(quant, d=d, theta=convert.theta(jtheta, device="cpu"),
                    store=SessionStore(root=root and root + "-port"))
    return jsched, tsched


def _held(got_pool, jsched, quant):
    want = [np.asarray(a) for a in jax.tree.leaves(jsched.fleet)]
    got = [a.numpy() for a in _leaves(got_pool)]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        if quant:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def _held_outputs(got, want, quant):
    assert got.keys() == want.keys()
    for u in got:
        if quant:
            np.testing.assert_array_equal(got[u].numpy(), np.asarray(want[u]))
        else:
            np.testing.assert_allclose(got[u].numpy(), np.asarray(want[u]),
                                       rtol=1e-5, atol=1e-5)


# (window, arrivals, departures) of the churn before the failure
CHURN = [(0, ("a", "b", "c", "d", "e"), ()), (1, ("f",), ("b",)),
         (2, ("b",), ("c",))]


@QUANT
def test_fail_and_drain_script_matches_the_jax_scheduler(quant):
    """Churn -> persist_resident -> a shard lost -> drain_failed through the
    port's D = 4 pool and JAX's unmeshed FleetScheduler (whose own meshed
    pool tests/test_distributed.py pins to it); JAX loses the same slots
    through fail_slots."""
    jsched, tsched = _jax_pair(quant, 4)
    events = {w: (arr, dep) for w, arr, dep in CHURN}
    for window in range(5):
        arr, dep = events.get(window, ((), ()))
        for uid in dep:
            jsched.evict(uid)
            tsched.evict(uid)
        for uid in arr:
            assert jsched.admit(uid) == tsched.admit(uid)
        obs = {u: _drive(u, window) for u in jsched.active_users}
        if window % 2:
            _held_outputs(tsched.step(dict(obs)), jsched.step(dict(obs)),
                          quant)
        else:
            _held_outputs(tsched.pool_step(dict(obs)),
                          jsched.pool_step(dict(obs)), quant)
    assert jsched.persist_resident() == tsched.persist_resident() == 5
    obs = {u: _drive(u, 5) for u in jsched.active_users}
    _held_outputs(tsched.step(dict(obs)), jsched.step(dict(obs)), quant)
    lost = list(tsched.device_slots(1))
    assert tsched.fail_device(1) == jsched.fail_slots(lost)
    trep, jrep = tsched.drain_failed(), jsched.drain_failed()
    assert [(r["uid"], r["from_slot"], r["steps_lost"]) for r in trep] == \
        [(r["uid"], r["from_slot"], r["steps_lost"]) for r in jrep]
    assert all(r["steps_lost"] == 1 for r in trep)
    # b and d (slots 2, 3) land in the first free healthy slots, 5 and 6
    assert [r["to_slot"] for r in trep] == [r["to_slot"] for r in jrep] \
        == [5, 6]
    for window in range(6, 9):
        obs = {u: _drive(u, window) for u in jsched.active_users}
        _held_outputs(tsched.pool_step(dict(obs)),
                      jsched.pool_step(dict(obs)), quant)
        _held(tsched.pool, jsched, quant)
    assert tsched.slot_user == jsched.slot_user
    assert tsched._steps.tolist() == jsched._steps.tolist()


@QUANT
def test_save_pool_checkpoints_interchange_with_jax(quant, tmp_path):
    """A pool JAX saved resumes in the port at D = 2 and goes on equal to
    JAX's own; a pool the port saved at D = 4 loads in JAX's load_pool."""
    jsched, tsched = _jax_pair(quant, 2)
    for u in USERS:
        jsched.admit(u)
    for t in range(3):
        jsched.step({u: _drive(u, t) for u in USERS})
    jsched.evict("u2")
    jsched.save_pool(str(tmp_path / "jax"))
    tsched.load_pool(str(tmp_path / "jax"))
    assert tsched.slot_user == jsched.slot_user
    assert tsched._steps.tolist() == jsched._steps.tolist()
    _held(tsched.pool, jsched, True)   # loaded: the same bits
    for t in range(3, 5):
        obs = {u: _drive(u, t) for u in jsched.active_users}
        _held_outputs(tsched.pool_step(dict(obs)),
                      jsched.pool_step(dict(obs)), quant)
    _held(tsched.pool, jsched, quant)

    port = _sched(quant, d=4, theta=tsched.theta)
    _admit_all((port,))
    for t in range(3):
        port.step({u: _drive(u, t) for u in USERS})
    port.save_pool(str(tmp_path / "port"))
    jload, _ = _jax_sched(quant)
    jload.load_pool(str(tmp_path / "port"))
    assert jload.slot_user == port.slot_user
    _held(port.pool, jload, True)
    obs = {u: _drive(u, 7) for u in USERS}
    _held_outputs(port.pool_step(dict(obs)), jload.pool_step(dict(obs)),
                  quant)


# ---- 7. the LM decode pool ---------------------------------------------------


def _lm(arch):
    from repro_torch.configs import get_smoke
    from repro_torch.models import factory
    cfg = get_smoke(arch).with_(dtype="float32", plastic_adapter=True,
                                adapter_neurons=8, adapter_quant=False)
    model = factory.build(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    params["adapter"]["scale"] = torch.tensor(0.5)
    return model, params


def test_lm_pool_across_shards_gives_the_unmeshed_tokens():
    from repro_torch.serving import LMScheduler
    model, params = _lm("qwen3-4b")
    rng = np.random.RandomState(11)
    prompts = {u: rng.randint(0, model.cfg.vocab, size=5)
               for u in ("u", "v", "w")}
    ref = LMScheduler(model, params, slots=8, max_len=16)
    m = LMScheduler(model, params, slots=8, max_len=16, mesh=_mesh(2))
    for s in (ref, m):
        for u, p in prompts.items():
            s.admit_prompt(u, p)
    assert {u: ref.pending(u) for u in prompts} == \
        {u: m.pending(u) for u in prompts}
    for _ in range(4):
        assert ref.step() == m.step()
    w = {u: np.asarray([ref.pending(u), 3, 5]) for u in prompts}
    la, ta = ref.decode_window(dict(w), telemetry=True)
    lb, tb = m.decode_window(dict(w), telemetry=True)
    for u in prompts:
        assert torch.equal(la[u].argmax(-1), lb[u].argmax(-1))
    _assert_trees_equal(ta, tb)
    assert ref.step() == m.step()
    m.persist_resident()
    m.fail_device(0)
    assert [r["to_device"] for r in m.drain_failed()] == [1, 1, 1]
    for u in prompts:
        ref.evict(u)
    for u in prompts:
        ref.admit(u)
    assert ref.step() == m.step()


def test_moe_lm_pool_refuses_shards():
    from repro_torch.serving import LMScheduler
    model, params = _lm("deepseek-moe-16b")
    with pytest.raises(ValueError, match="8b"):
        LMScheduler(model, params, slots=4, max_len=16, mesh=_mesh(2))
    # one shard is the unmeshed pool
    LMScheduler(model, params, slots=4, max_len=16, mesh=_mesh(1))


# ---- the kernels' plans under a shard ---------------------------------------

H100_SMS = 132


def test_recorder_plans_a_shard_as_its_pool():
    """A shard's recorder takes the whole pool's route and cluster (a
    slot's sum order), with its own tiles: at 8-128-8 in float32, 64 slots
    take clusters of 3 CTAs a slot and a 32-slot shard alone would take
    4.  (int8 sums are exact, and take the tiles route at these sizes.)"""
    from repro_torch.obs import recorder as TR
    nms, f32 = [1024, 1024], torch.float32
    whole = TR.recorder_plan(64, nms, f32, H100_SMS)
    alone = TR.recorder_plan(32, nms, f32, H100_SMS)
    shard = TR.recorder_plan(32, nms, f32, H100_SMS, pool=64)
    assert (whole["route"], whole["cluster"]) == ("cluster", 3)
    assert alone["cluster"] == 4
    assert (shard["route"], shard["cluster"], shard["shares"]) == \
        (whole["route"], whole["cluster"], whole["shares"])
    assert shard["tiles"] == 32 and shard["ctas"] == 32 * 3
    assert shard["pool"] == 64 and alone["pool"] == 32
    # the fleet's 1024-slot shards of 4096 take the tiles route either way
    for dt in (f32, torch.int8):
        assert TR.recorder_plan(1024, nms, dt, H100_SMS, pool=4096)[
            "route"] == TR.recorder_plan(4096, nms, dt, H100_SMS)[
            "route"] == "tiles"
    with pytest.raises(ValueError):
        TR.recorder_plan(64, nms, f32, H100_SMS, pool=32)


def test_fleet_window_plans_a_shard_as_its_pool():
    """The window's warps a stream follow its tile; a shard takes the
    pool's (`fleet_launch(pool=)` passes them as ``warps=``).  8-128-8
    keeps 2 warps at any tile; 16-256-8 takes 4 at 8 streams (tile 8) and
    8 at a 4-stream shard's own tile of 4."""
    from repro_torch.kernels.plasticity import fused
    kw = dict(quant=False, limit=232448)
    for b in (4096, 1024, 8, 3):
        assert fused.fleet_fit((8, 128, 8), b, (True, True), **kw)[
            "warps"] == 2
    whole = fused.fleet_fit((16, 256, 8), 8, (True, True), **kw)
    alone = fused.fleet_fit((16, 256, 8), 4, (True, True), **kw)
    assert (whole["tile"], whole["warps"]) == (8, 4)
    assert (alone["tile"], alone["warps"]) == (4, 8)
    shard = fused.fleet_plan((16, 256, 8), 4, whole["tile"], (True, True),
                             warps=whole["warps"], **kw)
    assert (shard["tile"], shard["warps"], shard["threads"]) == (4, 4, 512)
    with pytest.raises(ValueError, match="warps"):
        fused.fleet_plan((16, 256, 8), 4, 4, (True, True), warps=16, **kw)


def test_pool_plan_scopes_the_pool_batch():
    from repro_torch.kernels.plasticity import kernel as TK
    assert TK.pool_batch(8) == 8
    with TK.pool_plan(4096):
        assert TK.pool_batch(1024) == 4096
        with TK.pool_plan(64):
            assert TK.pool_batch(32) == 64
        assert TK.pool_batch(1024) == 4096
    assert TK.pool_batch(8) == 8
