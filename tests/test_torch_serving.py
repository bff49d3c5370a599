"""Session serving of the PyTorch port (SessionStore, FleetScheduler, the
checkpoint layout) on CPU tensors, mirroring tests/test_serving.py and
tests/test_obs.py, and against the JAX package itself:

  * the same churn script through JAX's ``FleetScheduler(impl="xla")`` and
    the port gives the same int8 pool bit for bit after every window, and
    the same float32 pool within 1e-5;
  * a session persisted by JAX's `SessionStore` restores bit for bit
    through the port's;
  * the metrics snapshot has the same keys after the same events.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import snn as JS
from repro.serving import FleetScheduler as JFleetScheduler
from repro.serving import SessionStore as JSessionStore
from repro.checkpoint import manager as JM
from repro_torch import convert
from repro_torch.checkpoint import manager as TM
from repro_torch.core import snn
from repro_torch.serving import (SHARED, FleetScheduler, SessionStore,
                                 make_slot_ops, slot_put, slot_take,
                                 uniform_axes)

SIZES = (6, 12, 4)
ENTRY_POINTS = {"slot_put", "slot_take", "recorder_reset", "pool_step",
                "pool_rollout", "pool_step_telemetry",
                "pool_rollout_telemetry", "pool_step_record",
                "pool_rollout_record"}


def _drive(uid, t, n=SIZES[0]):
    """A deterministic drive per (session, time): the same in every
    process (no string hashing)."""
    phase = (sum(map(ord, uid)) % 97) / 97.0
    return np.sin(0.3 * t + phase + np.arange(n)).astype(np.float32) * 1.5


def _cfg(quant=False, **kw):
    cfg = snn.SNNConfig(layer_sizes=SIZES, timesteps=2, **kw)
    return snn.quant_config(cfg) if quant else cfg


def _theta(cfg, seed=0):
    return snn.init_theta(cfg, torch.Generator().manual_seed(seed),
                          scale=0.05)


def _sched(quant=False, slots=3, root=None, **kw):
    cfg = _cfg(quant)
    return FleetScheduler(cfg, _theta(cfg), slots=slots,
                          store=SessionStore(root=root), device="cpu", **kw)


def _rand_state(cfg, seed):
    z = snn.init_state(cfg, device="cpu")
    g = torch.Generator().manual_seed(seed)
    if cfg.quant is not None:
        w = tuple(torch.randint(-60, 61, tuple(a.shape), generator=g,
                                dtype=torch.int32).to(torch.int8)
                  for a in z.w)
        return dataclasses.replace(z, w=w, t=torch.tensor(
            7, dtype=torch.int32))
    return dataclasses.replace(z, w=tuple(
        0.3 * torch.randn(tuple(a.shape), generator=g) for a in z.w))


def _leaves(tree):
    return TM.flatten(tree)[1]


def _assert_same(a, b):
    for x, y in zip(_leaves(a), _leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ---- the checkpoint layout -------------------------------------------------

class TestCheckpointLayout:
    @pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
    def test_leaf_paths_are_the_jax_paths(self, quant):
        jcfg = JS.SNNConfig(layer_sizes=SIZES)
        if quant:
            jcfg = JS.quant_config(jcfg)
        jpaths = JM._flatten_with_paths(JS.init_state(jcfg))[0]
        tpaths = TM.flatten(snn.init_state(_cfg(quant), device="cpu"))[0]
        assert tpaths == jpaths
        tree = {"b": [1, (2, 3)], "a": {"c": 4}}
        assert TM.flatten(tree)[0] == JM._flatten_with_paths(tree)[0]

    def test_keep_k_and_async_save(self, tmp_path):
        mgr = TM.CheckpointManager(str(tmp_path), keep=2)
        tree = {"w": torch.arange(6.0).reshape(2, 3), "t": torch.tensor(3)}
        for step in (1, 2, 3):
            mgr.save(step, tree, blocking=step != 3)
        mgr.wait()
        assert mgr.all_steps() == [2, 3] and mgr.latest_step() == 3
        out, step, _ = mgr.restore(tree)
        assert step == 3 and torch.equal(out["w"], tree["w"])

    def test_jax_reads_what_the_port_writes(self, tmp_path):
        st = _rand_state(_cfg(True), 4)
        TM.save_checkpoint(str(tmp_path), 5, st)
        jst = JS.init_state(JS.quant_config(JS.SNNConfig(layer_sizes=SIZES)))
        back, step, _ = JM.load_checkpoint(str(tmp_path), jst)
        assert step == 5
        for a, b in zip(jax.tree.leaves(back), _leaves(st)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# ---- the store (mirrors tests/test_serving.py TestSessionStore) -------------

class TestSessionStore:
    def test_checkout_is_exclusive(self, tmp_path):
        cfg = _cfg()
        store = SessionStore(root=str(tmp_path))
        store.checkin("a", _rand_state(cfg, 1), 5)
        assert "a" in store
        state, step = store.checkout(
            "a", lambda: snn.init_state(cfg, device="cpu"))
        assert step == 5 and "a" not in store

    @pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
    def test_disk_roundtrip_bit_identical(self, quant, tmp_path):
        cfg = _cfg(quant)
        store = SessionStore(root=str(tmp_path))
        st = _rand_state(cfg, 2)
        store.checkin("u", st, 17)
        store._warm.clear()                         # force the disk path
        out, step = store.checkout(
            "u", lambda: snn.init_state(cfg, device="cpu"))
        assert step == 17 and store.restores == 1
        _assert_same(st, out)

    def test_lru_capacity_drops_without_losing_durability(self, tmp_path):
        cfg = _cfg()
        store = SessionStore(root=str(tmp_path), capacity=2)
        for i, uid in enumerate(("a", "b", "c")):
            store.checkin(uid, _rand_state(cfg, i), i)
        assert store.cached == ["b", "c"]
        _, step = store.checkout("a",
                                 lambda: snn.init_state(cfg, device="cpu"))
        assert step == 0 and store.restores == 1

    def test_ram_archive_without_root(self):
        cfg = _cfg()
        store = SessionStore(root=None)
        st = _rand_state(cfg, 3)
        store.checkin("u", st, 4)
        store._warm.clear()
        out, step = store.checkout(
            "u", lambda: snn.init_state(cfg, device="cpu"))
        assert step == 4
        assert torch.equal(st.w[0], out.w[0])
        st.w[0].zero_()                 # the archive holds its own copy
        assert not torch.equal(st.w[0], out.w[0])

    def test_fresh_user_gets_factory_state(self, tmp_path):
        cfg = _cfg()
        store = SessionStore(root=str(tmp_path))
        out, step = store.checkout(
            "new", lambda: snn.init_state(cfg, device="cpu"))
        assert step == 0 and store.creates == 1
        assert all((w == 0).all() for w in out.w)

    @pytest.mark.parametrize("root", (None, "disk"))
    def test_float_session_refused_by_an_int8_pool(self, root, tmp_path):
        store = SessionStore(root=None if root is None else str(tmp_path))
        store.checkin("f", _rand_state(_cfg(False), 1), 3)
        store._warm.clear()
        qcfg = _cfg(True)
        with pytest.raises(ValueError, match="quantize_state"):
            store.checkout("f", lambda: snn.init_state(qcfg, device="cpu"))


# ---- slot copies ------------------------------------------------------------

def test_slot_ops_copy_rows_in_place():
    pool = {"a": torch.zeros(4, 3), "b": torch.zeros(2, 4, dtype=torch.int32),
            "t": torch.tensor(9)}
    axes = {"a": 0, "b": 1, "t": SHARED}
    put, take = make_slot_ops(axes)
    user = {"a": torch.ones(3), "b": torch.tensor([5, 6]),
            "t": torch.tensor(1)}
    rows = pool["a"]
    assert put(pool, 2, user) is pool and pool["a"] is rows
    assert pool["a"][2].tolist() == [1, 1, 1] and pool["a"][1].sum() == 0
    assert pool["b"][:, 2].tolist() == [5, 6] and int(pool["t"]) == 9
    got = take(pool, 2)
    assert got["b"].tolist() == [5, 6] and int(got["t"]) == 0
    pool["a"][2] = 7.0                  # a taken session is a copy
    assert got["a"].tolist() == [1, 1, 1]
    plain = {"x": torch.zeros(3, 2)}
    slot_put(plain, 1, {"x": torch.tensor([1.5, 2.5])})
    assert slot_take(plain, 1)["x"].tolist() == [1.5, 2.5]
    assert uniform_axes(plain) == {"x": 0}


# ---- the scheduler (mirrors tests/test_serving.py TestFleetScheduler) -------

class TestFleetScheduler:
    def test_admit_evict_bookkeeping(self):
        s = _sched()
        assert s.admit("a") == 0 and s.admit("b") == 1
        with pytest.raises(ValueError, match="already in slot"):
            s.admit("a")
        s.evict("a")
        assert s.slot_user[0] is None and s.free_slots == 2
        with pytest.raises(KeyError):
            s.evict("a")
        assert s.admit("c") == 0

    def test_full_pool_raises_or_evicts_lru(self):
        s = _sched(slots=2)
        s.admit("a")
        s.admit("b")
        with pytest.raises(RuntimeError, match="pool is full"):
            s.admit("c")
        slot = s.admit("c", evict_lru=True)
        assert slot == 0 and "a" not in s.user_slot
        assert s.store.known("a")

    def test_step_validates_drive_cover(self):
        s = _sched()
        s.admit("a")
        with pytest.raises(ValueError, match="missing"):
            s.step({})
        with pytest.raises(ValueError, match="not admitted"):
            s.step({"a": np.zeros(6, np.float32),
                    "ghost": np.zeros(6, np.float32)})
        with pytest.raises(ValueError, match="teach signals"):
            s.step({"a": np.zeros(6, np.float32)},
                   teach={"ghost": np.zeros(4, np.float32)})

    @pytest.mark.parametrize("windowed", (False, True),
                             ids=("step", "pool_step"))
    @pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
    def test_evict_restore_different_slot_bit_identical(self, quant,
                                                        windowed, tmp_path):
        """Interrupted == uninterrupted, bit for bit."""
        cfg = _cfg(quant)
        theta = _theta(cfg)
        steps, cut = 8, 4

        def trajectory(interrupt):
            sub = "int" if interrupt else "unint"
            sched = FleetScheduler(
                cfg, theta, slots=2, device="cpu",
                store=SessionStore(root=str(tmp_path / sub)))
            assert sched.admit("probe") == 0
            outs = []
            for t in range(steps):
                if interrupt and t == cut:
                    sched.evict("probe")            # -> disk
                    sched.store._warm.clear()       # force the disk path
                    sched.admit("rival")            # rival takes slot 0
                    sched.step({"rival": _drive("rival", 99)})
                    assert sched.admit("probe") == 1
                d = {u: _drive(u, t) for u in sched.active_users}
                out = sched.pool_step(d) if windowed else sched.step(d)
                outs.append(out["probe"].clone())
            sched.evict("probe")
            final, step = sched.store.checkout(
                "probe", lambda: snn.init_state(cfg, device="cpu"))
            return outs, final, step

        o1, f1, s1 = trajectory(False)
        o2, f2, s2 = trajectory(True)
        assert s1 == s2 == steps * (cfg.timesteps if windowed else 1)
        for a, b in zip(o1, o2):
            assert torch.equal(a, b)
        _assert_same(f1, f2)

    def test_churn_keeps_the_signatures_constant(self):
        s = _sched(slots=3)
        s.admit("w")
        s.step({"w": _drive("w", 0)})
        s.pool_step({"w": _drive("w", 0)})
        s.evict("w")
        s.admit("w")
        s.step({"w": _drive("w", 1)})
        s.evict("w")
        c0 = s.compiled_programs()
        users = [f"u{i}" for i in range(5)]
        for t in range(20):
            uid = users[t % len(users)]
            if uid in s.user_slot:
                s.evict(uid)
            else:
                s.admit(uid, evict_lru=True)
            d = {u: _drive(u, t) for u in s.active_users}
            s.step(d) if t % 2 else s.pool_step(d)
        assert s.compiled_programs() == c0
        assert s.compile_count() == sum(c0.values())

    def test_idle_slots_frozen_bitwise(self):
        s = _sched(slots=3)
        s.admit("a")
        s.admit("b")
        for t in range(4):
            s.step({u: _drive(u, t) for u in s.active_users})
        s.evict("b")
        vacant = s.slot_user.index(None)
        before = [w[vacant].clone() for w in s.fleet.w]
        for t in range(6):
            s.step({"a": _drive("a", 10 + t)})
            s.pool_step({"a": _drive("a", 20 + t)}, telemetry=t % 2 == 0)
        for w, b in zip(s.fleet.w, before):
            assert torch.equal(w[vacant], b)

    def test_teach_routes_to_output_layer(self):
        s = _sched()
        s.admit("a")
        s.admit("b")
        d = {u: _drive(u, 0) for u in ("a", "b")}
        out_plain = s.step(d)
        s2 = _sched()
        s2.admit("a")
        s2.admit("b")
        out_teach = s2.step(d, teach={"a": 5.0 * np.ones(4, np.float32),
                                      "b": np.zeros(4, np.float32)})
        assert not torch.equal(out_plain["a"], out_teach["a"])
        assert torch.equal(out_plain["b"], out_teach["b"])

    def test_control_step_matches_controller_step_solo(self):
        cfg = _cfg()
        theta = _theta(cfg)
        s = FleetScheduler(cfg, theta, slots=1, store=SessionStore(),
                           device="cpu")
        s.admit("solo")
        obs = _drive("solo", 0)
        a_pool = s.control_step({"solo": obs})["solo"]
        ref_state = snn.init_state(cfg, batch=1, fleet=True, device="cpu")
        _, a_ref = snn.controller_step(cfg, ref_state, theta,
                                       torch.from_numpy(obs)[None])
        torch.testing.assert_close(a_pool, a_ref[0], rtol=1e-6, atol=1e-6)

    @pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
    def test_save_load_pool_and_persist_resident(self, quant, tmp_path):
        s = _sched(quant, slots=3, root=str(tmp_path / "store"))
        for uid in ("a", "b"):
            s.admit(uid)
        s.pool_step({u: _drive(u, 0) for u in s.active_users})
        s.save_pool(str(tmp_path / "pool"))
        s2 = _sched(quant, slots=3)
        s2.load_pool(str(tmp_path / "pool"))
        _assert_same(s.fleet, s2.fleet)
        assert s2.user_slot == s.user_slot
        assert s.persist_resident() == 2
        assert s.store.persists == 2 and s.store.cached == []
        st, step = s.store.checkout(
            "a", lambda: snn.init_state(s.cfg, device="cpu"))
        assert step == s.cfg.timesteps and int(st.t) == step

    def test_int8_pool_is_smaller(self):
        """3 bytes saved per synapse and slot, 4 spent per layer and slot
        on the weight scale."""
        syn = SIZES[0] * SIZES[1] + SIZES[1] * SIZES[2]
        saved = _sched(False).pool_nbytes() - _sched(True).pool_nbytes()
        assert saved == 3 * (3 * syn - 4 * 2)

    def test_default_device_is_the_card(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        cfg = _cfg()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            FleetScheduler(cfg, _theta(cfg), slots=2)


# ---- metrics (mirrors tests/test_obs.py TestSchedulerObs) -------------------

class TestSchedulerObs:
    def test_compiled_programs_audit(self):
        s = _sched()
        progs = s.compiled_programs()
        assert set(progs) == ENTRY_POINTS
        assert all(v == 0 for v in progs.values())
        s.admit("u0")
        drives = {"u0": np.ones(6, np.float32)}
        s.step(drives)
        s.step(drives, telemetry=True)
        s.step(drives, telemetry=True)
        progs = s.compiled_programs()
        assert progs["pool_step"] == 1 and progs["pool_step_telemetry"] == 1
        assert progs["pool_rollout_telemetry"] == 0
        s.step(drives, teach={"u0": np.ones(4, np.float32)})
        assert s.compiled_programs()["pool_step"] == 2   # a teaching signal
        assert s.compile_count() == sum(s.compiled_programs().values())

    def test_step_telemetry_records_gauges(self):
        s = _sched(slots=4)
        for u in ("u0", "u1"):
            s.admit(u)
        drives = {u: np.ones(6, np.float32) * 2.0 for u in s.active_users}
        outs, tel = s.step(drives, telemetry=True)
        assert set(outs) == {"u0", "u1"}
        assert tel.occupancy.tolist() == [1.0, 1.0, 0.0, 0.0]
        snap = s.metrics.snapshot()
        assert snap["fleet_occupancy"]["value"] == pytest.approx(0.5)
        for name in ("fleet_spike_rate", "fleet_mean_abs_dw",
                     "fleet_sat_frac"):
            assert name in snap
        assert set(s.step(drives)) == {"u0", "u1"}
        outs, tel = s.pool_step(drives, telemetry=True)
        assert outs["u0"].shape == (2, 4) and float(tel.spike_rate[0]) > 0
        assert tel.spike_rate[2:].eq(0).all()

    def test_pool_lifecycle_counters(self):
        s = _sched()
        s.admit("a")
        s.admit("b")
        s.evict("a")
        snap = s.metrics.snapshot()
        assert snap["pool_admissions_total"]["value"] == 2
        assert snap["pool_evictions_total"]["value"] == 1
        assert snap["pool_occupancy"]["value"] == pytest.approx(1 / 3)
        assert snap["pool_admit_seconds"]["count"] == 2

    def test_store_counters_are_the_source_of_truth(self, tmp_path):
        store = SessionStore(root=str(tmp_path), capacity=1)
        cfg = _cfg()
        s = FleetScheduler(cfg, _theta(cfg), slots=3, store=store,
                           device="cpu")
        s.admit("u0")
        s.admit("u1")
        s.evict("u0")
        s.evict("u1")
        s.admit("u0")               # fell out of the warm cache: disk
        s.admit("u1")               # warm hit
        assert (store.creates, store.persists) == (2, 2)
        assert (store.restores, store.warm_hits) == (1, 1)
        snap = store.metrics.snapshot()
        assert snap["session_store_checkout_seconds"]["count"] == 4
        assert snap["session_store_persist_seconds"]["count"] == 2


# ---- against the JAX package -------------------------------------------------

def _jax_pair(quant, slots, root=None):
    jcfg = JS.SNNConfig(layer_sizes=SIZES, timesteps=2, impl="xla")
    if quant:
        jcfg = JS.quant_config(jcfg)
    jtheta = JS.init_theta(jcfg, jax.random.PRNGKey(3), scale=0.05)
    jsched = JFleetScheduler(jcfg, jtheta, slots=slots,
                             store=JSessionStore(root=root))
    tsched = FleetScheduler(_cfg(quant), convert.theta(jtheta, device="cpu"),
                            slots=slots, device="cpu",
                            store=SessionStore(root=root and root + "-port"))
    return jsched, tsched


# (window, arrivals, departures): fixed admit/evict events of the churn
CHURN = [(0, ("a", "b", "c", "d"), ()), (2, ("e", "f"), ("b",)),
         (3, ("b",), ("a", "d")), (5, ("g", "a"), ("c",)),
         (7, ("d",), ("e", "g")), (8, ("c", "e"), ("f",)),
         (10, ("f",), ("a", "b"))]


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_churn_script_matches_the_jax_scheduler(quant, tmp_path):
    jsched, tsched = _jax_pair(quant, 6, str(tmp_path / "jax"))
    events = dict((w, (arr, dep)) for w, arr, dep in CHURN)
    for window in range(12):
        arr, dep = events.get(window, ((), ()))
        for uid in dep:
            jsched.evict(uid)
            tsched.evict(uid)
        for uid in arr:
            assert jsched.admit(uid) == tsched.admit(uid)
        obs = {u: _drive(u, window) for u in jsched.active_users}
        teach = {u: _drive(u, window + 50, SIZES[-1]) for u in obs} \
            if window % 3 == 1 else None
        if window % 4 == 3:
            jo, jtel = jsched.pool_step(obs, teach=teach, telemetry=True)
            to, ttel = tsched.pool_step(obs, teach=teach, telemetry=True)
            for f in ("spike_rate", "mean_abs_dw", "sat_frac", "occupancy"):
                np.testing.assert_allclose(getattr(ttel, f).numpy(),
                                           np.asarray(getattr(jtel, f)),
                                           rtol=1e-5, atol=1e-5)
        elif window % 4 == 1:
            jo = jsched.step(obs, teach=teach)
            to = tsched.step(obs, teach=teach)
        else:
            jo = jsched.control_step(obs)
            to = tsched.control_step(obs)
        for uid in obs:
            np.testing.assert_allclose(to[uid].numpy(), np.asarray(jo[uid]),
                                       rtol=1e-5, atol=1e-5)
        want = [np.asarray(a) for a in jax.tree.leaves(jsched.fleet)]
        got = [a.numpy() for a in _leaves(tsched.fleet)]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            if quant:
                np.testing.assert_array_equal(a, b)
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    assert tsched.slot_user == jsched.slot_user
    assert tsched._steps.tolist() == jsched._steps.tolist()


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_jax_persisted_session_restores_bit_for_bit(quant, tmp_path):
    jsched, _ = _jax_pair(quant, 3, str(tmp_path / "jax"))
    jsched.admit("u")
    for t in range(3):
        jsched.control_step({"u": _drive("u", t)})
    jsched.evict("u")               # JAX writes <root>/u/step_*/
    jstate, jstep = jsched.store.checkout(
        "u", lambda: JS.init_state(jsched.cfg))
    store = SessionStore(root=str(tmp_path / "jax"))
    cfg = _cfg(quant)
    tstate, tstep = store.checkout(
        "u", lambda: snn.init_state(cfg, device="cpu"), device="cpu")
    assert tstep == jstep == 6 and store.restores == 1
    jl, tl = jax.tree.leaves(jstate), _leaves(tstate)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        assert str(b.dtype).endswith(a.dtype.name)
        np.testing.assert_array_equal(a, b.numpy())
    assert (tl[0] != 0).any()       # the session learned something
    # and it resumes in a port pool from the same store
    tsched = FleetScheduler(cfg, _theta(cfg), slots=2, store=store,
                            device="cpu")
    slot = tsched.admit("u")
    for a, b in zip(_leaves(tsched.fleet), tl):
        if a.ndim == b.ndim + 1:
            assert torch.equal(a[slot], b)


def test_metrics_snapshot_keys_equal_jax(tmp_path):
    jsched, tsched = _jax_pair(False, 3)
    for s in (jsched, tsched):
        s.admit("a")
        s.admit("b")
        s.step({"a": _drive("a", 0), "b": _drive("b", 0)}, telemetry=True)
        s.evict("a")
        s.admit("a")
        s.pool_step({"a": _drive("a", 1), "b": _drive("b", 1)},
                    telemetry=True)
    jsnap, tsnap = jsched.metrics.snapshot(), tsched.metrics.snapshot()
    assert set(tsnap) == set(jsnap)
    for name, m in jsnap.items():
        assert tsnap[name]["type"] == m["type"]
        if m["type"] == "counter":
            assert tsnap[name]["value"] == m["value"], name
