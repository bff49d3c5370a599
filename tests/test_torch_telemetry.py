"""In-band fleet telemetry and the metrics registry of the PyTorch port
against the JAX reference.

The port runs on CPU tensors (the plain versions of the kernels' telemetry
variants); the JAX side runs under ``jax.jit`` with ``impl="xla"`` and, for
the fleet-step kernels and the rollout window, ``"pallas-interpret"``.
Tolerances: int8 state bit for bit, its telemetry within 1e-6 relative (the
raw saturation count of a step exactly; a window's means are divided and
summed in float, which XLA may reorder); float32 state within 1e-5 (the psum is summed
in another order) and its telemetry within 1e-5.  With telemetry off the
state equals the telemetry-on state bit for bit, and vacant slots report
zeros in every field.
"""
import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.core import snn as JS
from repro.kernels.plasticity import kernel as JK
from repro.kernels.plasticity import quant as JQ
from repro.kernels.plasticity import ref as JR
from repro.obs import FleetTelemetry as JFleetTelemetry
from repro_torch import convert
from repro_torch.core import engine as TE
from repro_torch.core import snn as TS
from repro_torch.kernels.plasticity import fused as TF
from repro_torch.kernels.plasticity import kernel as TK
from repro_torch.kernels.plasticity import quant as TQ
from repro_torch.obs import (FleetTelemetry, MetricsRegistry, SAT_FRACTION,
                             record_fleet_telemetry, sat_threshold,
                             sat_threshold_q)

B = 6
ACTIVE = np.array([1, 0, 1, 1, 0, 1], np.int32)
FIELDS = ("spike_rate", "mean_abs_dw", "sat_frac", "occupancy")


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _np(x):
    return np.asarray(jax.device_get(x))


def _check_tel(got, want, quant):
    """Telemetry rows or fields: int8 within 1e-6 relative with the
    saturation column exact, float32 within 1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if quant:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _check_state(got, want, quant):
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        if quant:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


# ---- the fleet-step kernels' telemetry row ----------------------------------

# (N, M, spiking, teach, active): M = 45 and 200 are no multiple of a warp
# or of the JAX tile (128)
STEP_CASES = [(8, 128, True, None, True), (16, 200, True, "per-stream", True),
              (128, 8, False, None, False), (7, 45, False, "shared", True),
              (5, 3, True, None, False)]


def _step_inputs(rng, n, m, quant, teach, active):
    d = {}
    if quant:
        d["x"] = rng.choice([0, 256], (B, n)).astype(np.int32)
        d["w"] = rng.integers(-127, 128, (B, n, m)).astype(np.int8)
        d["v"] = rng.integers(-600, 600, (B, m)).astype(np.int32)
        d["tpre"] = rng.integers(0, 1200, (B, n)).astype(np.int32)
        d["tpost"] = rng.integers(-300, 1200, (B, m)).astype(np.int32)
        d["scale"] = np.where(np.arange(B) % 2 == 0, 1 / 32,
                              1 / 16).astype(np.float32)
        d["seed"] = rng.integers(-2 ** 31, 2 ** 31, B).astype(np.int32)
        tdt, tmag = np.int32, 300
    else:
        d["x"] = (rng.random((B, n)) < 0.4).astype(np.float32)
        d["w"] = rng.uniform(-1, 1, (B, n, m)).astype(np.float32)
        d["v"] = (rng.standard_normal((B, m)) * 0.8).astype(np.float32)
        d["tpre"] = (rng.random((B, n)) * 3).astype(np.float32)
        d["tpost"] = (rng.random((B, m)) * 3).astype(np.float32)
        d["scale"] = d["seed"] = None
        tdt, tmag = np.float32, 0.5
    d["theta"] = (rng.standard_normal((4, n, m)) * 0.02).astype(np.float32)
    shape = {"per-stream": (B, m), "shared": (m,)}.get(teach)
    d["teach"] = None if shape is None else (
        (rng.standard_normal(shape) * tmag).astype(tdt))
    d["active"] = ACTIVE if active else None
    return d


def _jax_step(d, quant, spiking, impl):
    qc = JQ.QuantConfig()
    act = None if d["active"] is None else jnp.asarray(d["active"])
    if quant:
        kw = dict(qcfg=qc, spiking=spiking, active=act, telemetry=True)
        if impl == "xla":
            f = lambda *a: JR.dual_engine_fleet_step_q(
                *a[:7], teach=a[7], seed=a[8], **kw)
        else:
            f = lambda *a: JK.dual_engine_fleet_step_q_pallas(
                *a[:7], teach=a[7], seed=a[8], interpret=True, **kw)
        args = (d["x"], d["w"], d["scale"], d["theta"], d["v"], d["tpre"],
                d["tpost"], d["teach"], d["seed"])
    else:
        kw = dict(spiking=spiking, active=act, telemetry=True)
        if impl == "xla":
            f = lambda *a: JR.dual_engine_fleet_step(*a[:6], teach=a[6], **kw)
        else:
            f = lambda *a: JK.dual_engine_fleet_step_pallas(
                *a[:6], teach=a[6], interpret=True, **kw)
        args = (d["x"], d["w"], d["theta"], d["v"], d["tpre"], d["tpost"],
                d["teach"])
    return [_np(a) for a in jax.jit(f)(*args)]


def _port_step(d, quant, spiking, telemetry=True):
    t = {k: _t(v) for k, v in d.items()}
    if quant:
        out = TK.fleet_step_q(
            t["x"], t["w"], t["scale"], t["theta"], t["v"], t["tpre"],
            t["tpost"], qcfg=TQ.QuantConfig(), spiking=spiking,
            teach=t["teach"], seed=t["seed"], active=t["active"],
            telemetry=telemetry)
    else:
        out = TK.fleet_step(t["x"], t["w"], t["theta"], t["v"], t["tpre"],
                            t["tpost"], spiking=spiking, teach=t["teach"],
                            active=t["active"], telemetry=telemetry)
    return [a.numpy() for a in out]


# interpret mode only at the small shapes (it runs the kernel body in Python)
STEP_IMPL_CASES = [(c, impl) for c in STEP_CASES
                   for impl in ("xla", "pallas-interpret")
                   if impl == "xla" or c[0] * c[1] <= 2000]


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
@pytest.mark.parametrize("case,impl", STEP_IMPL_CASES,
                         ids=lambda c: c if isinstance(c, str)
                         else f"{c[0]}x{c[1]}")
def test_fleet_step_telemetry_row_matches_jax(case, impl, quant):
    n, m, spiking, teach, active = case
    d = _step_inputs(np.random.default_rng(n * m + quant), n, m, quant,
                     teach, active)
    want = _jax_step(d, quant, spiking, impl)
    got = _port_step(d, quant, spiking)
    assert len(got) == 5 and got[4].shape == (B, 3)
    assert got[4].dtype == np.float32
    _check_state(got[:4], want[:4], quant)
    _check_tel(got[4], want[4], quant)
    if quant:
        np.testing.assert_array_equal(got[4][:, 2], want[4][:, 2])
    if active:
        assert (got[4][ACTIVE == 0] == 0).all()
    off = _port_step(d, quant, spiking, telemetry=False)
    for a, b in zip(off, got[:4]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_fleet_step_telemetry_row_is_the_numpy_oracle(quant):
    """The raw row re-derived in numpy from the step's own outputs."""
    n, m = 9, 37
    d = _step_inputs(np.random.default_rng(5), n, m, quant, None, True)
    ev, v, _, w1, raw = _port_step(d, quant, True)
    qc = TQ.QuantConfig()
    act = ACTIVE.astype(np.float64)[:, None]
    if quant:
        want_ev = np.abs(ev).sum(1) / qc.one
        want_dw = (np.abs(w1.astype(np.int64) - d["w"]).sum((1, 2))
                   * d["scale"])
        sat = np.abs(v) >= sat_threshold_q(1.0, qc)
    else:
        want_ev = np.abs(ev).sum(1)
        want_dw = np.abs(w1 - d["w"]).sum((1, 2))
        sat = np.abs(v) >= np.float32(sat_threshold(1.0))
    want = np.stack([want_ev, want_dw, sat.sum(1)], 1) * act
    np.testing.assert_allclose(raw, want, rtol=1e-5, atol=1e-6)
    assert sat_threshold_q(1.0, qc) == round(SAT_FRACTION * qc.one)


# ---- engine.layer_step ------------------------------------------------------

def _layer_state(d, mod, quant):
    arr = (lambda a: a) if mod is JE else _t
    return mod.LayerState(w=arr(d["w"]), v=arr(d["v"]),
                          trace_pre=arr(d["tpre"]),
                          trace_post=arr(d["tpost"]),
                          theta=arr(d["theta"]),
                          w_scale=arr(d["scale"]) if quant else None)


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
@pytest.mark.parametrize("case", STEP_CASES[:4],
                         ids=lambda c: f"{c[0]}x{c[1]}")
def test_layer_step_telemetry_matches_jax(case, quant):
    n, m, spiking, teach, active = case
    d = _step_inputs(np.random.default_rng(7 * n + m), n, m, quant, teach,
                     active)
    qc = (JQ.QuantConfig(), TQ.QuantConfig()) if quant else (None, None)
    kw = dict(spiking=spiking, trace_decay=0.75 if quant else 0.8)
    jp = JE.EngineParams(quant=qc[0], **kw)
    tp = TE.EngineParams(quant=qc[1], **kw)
    act = d["active"]

    def f(w, v, tpre, tpost, th, sc, x, te, a, sd):
        st = JE.LayerState(w=w, v=v, trace_pre=tpre, trace_post=tpost,
                           theta=th, w_scale=sc)
        ns, out, tel = JE.layer_step(st, x, params=jp, impl="xla", teach=te,
                                     active=a, seed=sd, telemetry=True)
        return ns.w, ns.v, ns.trace_post, out, tel
    jw, jv, jtp, jout, jtel = jax.jit(f)(
        d["w"], d["v"], d["tpre"], d["tpost"], d["theta"], d["scale"],
        d["x"], d["teach"], act, d["seed"])
    ns, out, tel = TE.layer_step(_layer_state(d, TE, quant), _t(d["x"]),
                                 params=tp, teach=_t(d["teach"]),
                                 active=_t(act), seed=_t(d["seed"]),
                                 telemetry=True)
    _check_state([ns.w, ns.v, ns.trace_post, out],
                 [_np(a) for a in (jw, jv, jtp, jout)], quant)
    for f_ in FIELDS:
        _check_tel(getattr(tel, f_).numpy(), _np(getattr(jtel, f_)), quant)
        assert getattr(tel, f_).dtype == torch.float32
    if act is not None:
        for f_ in FIELDS:
            assert (getattr(tel, f_).numpy()[act == 0] == 0).all(), f_
    ns0, out0 = TE.layer_step(_layer_state(d, TE, quant), _t(d["x"]),
                              params=tp, teach=_t(d["teach"]),
                              active=_t(act), seed=_t(d["seed"]))
    for a, b in zip((ns0.w, ns0.v, ns0.trace_post, out0),
                    (ns.w, ns.v, ns.trace_post, out)):
        assert torch.equal(a, b)


def test_telemetry_is_a_fleet_contract():
    st = TE.LayerState(w=torch.zeros(4, 3), v=torch.zeros(3),
                       trace_pre=torch.zeros(4), trace_post=torch.zeros(3),
                       theta=torch.zeros(4, 4, 3))
    with pytest.raises(ValueError, match="fleet-mode"):
        TE.layer_step(st, torch.zeros(4), telemetry=True)
    net = TE.NetworkState(w=(torch.zeros(4, 3),), v=(torch.zeros(3),),
                          trace=(torch.zeros(4), torch.zeros(3)),
                          t=torch.zeros((), dtype=torch.int32))
    with pytest.raises(ValueError, match="fleet-mode"):
        TE.rollout(net, [torch.zeros(4, 4, 3)], torch.zeros(2, 4),
                   params=TE.EngineParams(), telemetry=True)


# ---- engine.rollout ----------------------------------------------------------

SIZES = (6, 20, 4)


def _net(rng, quant):
    n_layers = len(SIZES) - 1
    if quant:
        w = [rng.integers(-40, 41, (B, SIZES[i], SIZES[i + 1])
                          ).astype(np.int8) for i in range(n_layers)]
        v = [rng.integers(-300, 300, (B, m)).astype(np.int32)
             for m in SIZES[1:]]
        tr = [rng.integers(0, 900, (B, n)).astype(np.int32) for n in SIZES]
        scale = [np.where(np.arange(B) % 2 == 0, 1 / 32, 1 / 16
                          ).astype(np.float32) for _ in range(n_layers)]
    else:
        w = [np.round(rng.uniform(-0.5, 0.5, (B, SIZES[i], SIZES[i + 1]))
                      * 64).astype(np.float32) / 64 for i in range(n_layers)]
        v = [rng.uniform(-0.5, 0.9, (B, m)).astype(np.float32)
             for m in SIZES[1:]]
        tr = [rng.uniform(0, 2, (B, n)).astype(np.float32) for n in SIZES]
        scale = []
    return types.SimpleNamespace(w=tuple(w), v=tuple(v), trace=tuple(tr),
                                 t=np.int32(2 ** 31 - 5 if quant else 0),
                                 w_scale=tuple(scale))


def _rollout_case(quant, k, teach):
    rng = np.random.default_rng(31 * k + quant)
    net = _net(rng, quant)
    theta = [(rng.standard_normal((4, SIZES[i], SIZES[i + 1])) * 0.03
              ).astype(np.float32) for i in range(len(SIZES) - 1)]
    if quant:
        drives = rng.integers(-512, 512, (k, B, SIZES[0])).astype(np.int32)
        tch = rng.integers(-300, 300, (k, B, SIZES[-1])).astype(np.int32)
    else:
        drives = (np.round(rng.standard_normal((k, B, SIZES[0])) * 16) / 16
                  ).astype(np.float32)
        tch = (rng.standard_normal((k, B, SIZES[-1])) * 0.4
               ).astype(np.float32)
    return net, theta, drives, (tch if teach else None)


def _params(quant, mod):
    qc = (JQ.QuantConfig() if mod is JE else TQ.QuantConfig()) \
        if quant else None
    kw = dict(quant=qc, trace_decay=0.75 if quant else 0.8)
    return [mod.EngineParams(spiking=i < len(SIZES) - 2, **kw)
            for i in range(len(SIZES) - 1)]


def _jax_rollout(net, theta, drives, teach, active, quant, impl):
    params = _params(quant, JE)

    def f(w, v, tr, t, sc, th, dr, te, act):
        st = JE.NetworkState(w=w, v=v, trace=tr, t=t, w_scale=sc)
        st, outs, tel = JE.rollout(st, th, dr, params=params, impl=impl,
                                   teach=te, active=act, telemetry=True)
        return st.w, st.v, st.trace, outs, tel
    w, v, tr, outs, tel = jax.jit(f)(net.w, net.v, net.trace, net.t,
                                     net.w_scale, theta, drives, teach,
                                     active)
    return [_np(a) for a in (*w, *v, *tr, outs)], tel


def _port_rollout(net, theta, drives, teach, active, quant, telemetry=True):
    st = convert.network_state(net, device="cpu")
    res = TE.rollout(st, convert.theta(theta, device="cpu"), _t(drives),
                     params=_params(quant, TE), teach=_t(teach),
                     active=_t(active), telemetry=telemetry)
    st, outs = res[0], res[1]
    return [a.numpy() for a in (*st.w, *st.v, *st.trace, outs)], res[2:]


@pytest.mark.parametrize("active", (True, False), ids=("masked", "full"))
@pytest.mark.parametrize("teach", (False, True), ids=("free", "taught"))
@pytest.mark.parametrize("k", (1, 4, 7))
@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_rollout_telemetry_matches_jax(quant, k, teach, active):
    net, theta, drives, tch = _rollout_case(quant, k, teach)
    act = ACTIVE if active else None
    want, jtel = _jax_rollout(net, theta, drives, tch, act, quant, "xla")
    got, (tel,) = _port_rollout(net, theta, drives, tch, act, quant)
    _check_state(got, want, quant)
    for f_ in FIELDS:
        _check_tel(getattr(tel, f_).numpy(), _np(getattr(jtel, f_)), quant)
    assert float(tel.spike_rate.max()) > 0.0      # the drive makes spikes
    if active:
        for f_ in FIELDS:
            assert (getattr(tel, f_).numpy()[ACTIVE == 0] == 0).all(), f_
    off, rest = _port_rollout(net, theta, drives, tch, act, quant,
                              telemetry=False)
    assert rest == ()
    for a, b in zip(off, got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_rollout_telemetry_matches_jax_pallas_interpret(quant):
    net, theta, drives, tch = _rollout_case(quant, 3, True)
    want, jtel = _jax_rollout(net, theta, drives, tch, ACTIVE, quant,
                              "pallas-interpret")
    got, (tel,) = _port_rollout(net, theta, drives, tch, ACTIVE, quant)
    _check_state(got, want, quant)
    for f_ in FIELDS:
        # the JAX kernel is held to its xla oracle within 2e-4
        # (tests/test_obs.py); its fixed-point row sums in another order
        np.testing.assert_allclose(getattr(tel, f_).numpy(),
                                   _np(getattr(jtel, f_)), atol=2e-4)


def test_rollout_plain_telemetry_refuses_shared_weights():
    with pytest.raises(ValueError, match="fleet-mode"):
        TF.rollout_plain(torch.zeros(2, 1, 3), [torch.zeros(3, 2)],
                         [torch.zeros(4, 3, 2)], [torch.zeros(1, 2)],
                         [torch.zeros(1, 3), torch.zeros(1, 2)],
                         spiking=[True], plastic=[True], telemetry=True)


# ---- snn.timestep / snn.rollout_window ---------------------------------------

def _cfgs(quant):
    kw = dict(layer_sizes=SIZES, timesteps=3, plastic=True)
    jc, tc = JS.SNNConfig(**kw), TS.SNNConfig(**kw)
    if quant:
        jc, tc = JS.quant_config(jc), TS.quant_config(tc)
    return jc, tc


def _snn_case(quant, seed):
    rng = np.random.default_rng(seed)
    jc, tc = _cfgs(quant)
    jstate = JS.init_state(jc, batch=B, fleet=True)
    theta = [(rng.standard_normal((4, SIZES[i], SIZES[i + 1])) * 0.05
              ).astype(np.float32) for i in range(len(SIZES) - 1)]
    drive = (rng.standard_normal((B, SIZES[0])) * 2.5).astype(np.float32)
    teach = (rng.standard_normal((B, SIZES[-1])) * 0.5).astype(np.float32)
    seeds = rng.integers(0, 1000, B).astype(np.int32)
    return jc, tc, jstate, theta, drive, teach, seeds


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_snn_timestep_telemetry_matches_jax(quant):
    jc, tc, jstate, theta, drive, teach, seeds = _snn_case(quant, 3)
    f = jax.jit(lambda st, th, d, te, a, s: JS.timestep(
        jc, st, th, d, teach=te, active=a, seed=s, telemetry=True))
    tstate = convert.network_state(jstate, device="cpu")
    tth = convert.theta(theta, device="cpu")
    for step in range(3):       # the state carries over: weights move
        jstate, jout, jtel = f(jstate, theta, drive, teach, ACTIVE,
                               seeds + step)
        tstate, tout, tel = TS.timestep(tc, tstate, tth, _t(drive),
                                        teach=_t(teach), active=_t(ACTIVE),
                                        seed=_t(seeds + step),
                                        telemetry=True)
        want = [_np(a) for a in (*jstate.w, *jstate.v, *jstate.trace, jout)]
        got = [a.numpy() for a in (*tstate.w, *tstate.v, *tstate.trace,
                                   tout)]
        _check_state(got, want, quant)
        for f_ in FIELDS:
            _check_tel(getattr(tel, f_).numpy(), _np(getattr(jtel, f_)),
                       quant)
            assert (getattr(tel, f_).numpy()[ACTIVE == 0] == 0).all()
    assert float(tel.mean_abs_dw.max()) > 0.0


@pytest.mark.parametrize("quant", (False, True), ids=("float32", "int8"))
def test_snn_rollout_window_telemetry_matches_jax(quant):
    jc, tc, jstate, theta, drive, teach, seeds = _snn_case(quant, 4)
    drives = np.stack([drive, -drive, 0.5 * drive])
    jst, jouts, jtel = jax.jit(lambda st, th, d, te, a, s: JS.rollout_window(
        jc, st, th, d, teach=te, active=a, seed=s, telemetry=True))(
        jstate, theta, drives, teach, ACTIVE, seeds)
    args = (tc, convert.network_state(jstate, device="cpu"),
            convert.theta(theta, device="cpu"), _t(drives))
    kw = dict(teach=_t(teach), active=_t(ACTIVE), seed=_t(seeds))
    tst, touts, tel = TS.rollout_window(*args, telemetry=True, **kw)
    want = [_np(a) for a in (*jst.w, *jst.v, *jst.trace, jouts)]
    got = [a.numpy() for a in (*tst.w, *tst.v, *tst.trace, touts)]
    _check_state(got, want, quant)
    for f_ in FIELDS:
        _check_tel(getattr(tel, f_).numpy(), _np(getattr(jtel, f_)), quant)
    off = TS.rollout_window(*args, **kw)
    assert len(off) == 2
    for a, b in zip((*off[0].w, *off[0].v, *off[0].trace, off[1]),
                    (*tst.w, *tst.v, *tst.trace, touts)):
        assert torch.equal(a, b)


def test_convert_fleet_telemetry():
    jt = JFleetTelemetry(*(jnp.arange(3, dtype=jnp.float32) * (i + 1)
                           for i in range(4)))
    tt = convert.fleet_telemetry(jt, device="cpu")
    for f_ in FIELDS:
        np.testing.assert_array_equal(getattr(tt, f_).numpy(),
                                      _np(getattr(jt, f_)))
        assert getattr(tt, f_).dtype == torch.float32


# ---- the metrics registry (mirrors tests/test_obs.py) ------------------------

class TestMetricsRegistry:
    def test_counter_monotonic(self):
        reg = MetricsRegistry()
        c = reg.counter("admissions_total", "h")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        with pytest.raises(ValueError):
            c.inc(-1)
        assert reg.counter("admissions_total") is c

    def test_gauge_set_add(self):
        g = MetricsRegistry().gauge("occupancy")
        g.set(0.5)
        g.add(0.25)
        assert g.value == 0.75

    def test_histogram_buckets_and_percentiles(self):
        h = MetricsRegistry().histogram("lat", buckets=(0.01, 0.1, 1.0))
        for v in (0.005, 0.05, 0.05, 0.5, 5.0):
            h.observe(v)
        assert h.count == 5 and h.sum == pytest.approx(5.605)
        assert h.mean == pytest.approx(5.605 / 5)
        assert h.percentile(50) == 0.05
        snap = h.snapshot()
        assert snap["buckets"] == {"0.01": 1, "0.1": 3, "1": 4}
        assert snap["p50"] == 0.05

    def test_histogram_time_context(self):
        reg = MetricsRegistry()
        with reg.timer("block_seconds"):
            pass
        h = reg.histogram("block_seconds")
        assert h.count == 1 and h.sum >= 0.0

    def test_kind_conflict_raises(self):
        reg = MetricsRegistry()
        reg.counter("x_total")
        with pytest.raises(TypeError):
            reg.gauge("x_total")

    def test_snapshot_schema_and_to_json(self, tmp_path):
        reg = MetricsRegistry()
        reg.counter("a_total").inc()
        reg.gauge("b").set(2)
        reg.histogram("c").observe(0.5)
        snap = reg.snapshot()
        assert snap["a_total"] == {"type": "counter", "value": 1.0}
        assert snap["b"] == {"type": "gauge", "value": 2.0}
        assert snap["c"]["type"] == "histogram" and snap["c"]["count"] == 1
        path = tmp_path / "m.json"
        reg.to_json(str(path))
        assert json.loads(path.read_text()) == json.loads(json.dumps(snap))

    def test_prometheus_text(self):
        reg = MetricsRegistry()
        reg.counter("req_total", "requests").inc(3)
        reg.histogram("lat", buckets=(0.1, 1.0)).observe(0.05)
        text = reg.prometheus_text()
        assert "# TYPE req_total counter" in text
        assert "req_total 3" in text
        assert '# TYPE lat histogram' in text
        assert 'lat_bucket{le="0.1"} 1' in text
        assert 'lat_bucket{le="+Inf"} 1' in text
        assert "lat_count 1" in text

    def test_exports_equal_the_jax_registry(self):
        """The same events give the same snapshot and Prometheus text as
        the JAX package's registry: the names, buckets and formats are a
        schema."""
        from repro.obs import MetricsRegistry as JRegistry
        regs = (MetricsRegistry(), JRegistry())
        for reg in regs:
            reg.counter("req_total", "requests").inc(3)
            reg.gauge("occ", "occupancy").set(0.25)
            h = reg.histogram("lat_seconds", "latency")
            for v in (2e-4, 0.004, 0.7, 40.0):
                h.observe(v)
        assert regs[0].snapshot() == regs[1].snapshot()
        assert regs[0].prometheus_text() == regs[1].prometheus_text()


class TestRecordFleetTelemetry:
    def test_active_weighted_means(self):
        reg = MetricsRegistry()
        tel = FleetTelemetry(
            spike_rate=torch.tensor([0.2, 0.4, 0.0, 0.6]),
            mean_abs_dw=torch.tensor([1e-3, 2e-3, 0.0, 3e-3]),
            sat_frac=torch.tensor([0.1, 0.2, 0.0, 0.3]),
            occupancy=torch.tensor([1.0, 1.0, 0.0, 1.0]))
        vals = record_fleet_telemetry(reg, tel)
        assert vals["fleet_spike_rate"] == pytest.approx(0.4)
        assert vals["fleet_mean_abs_dw"] == pytest.approx(2e-3)
        assert vals["fleet_sat_frac"] == pytest.approx(0.2, abs=1e-7)
        assert vals["fleet_occupancy"] == pytest.approx(0.75)
        assert reg.gauge("fleet_spike_rate").value == pytest.approx(0.4)

    def test_empty_fleet_is_zero(self):
        reg = MetricsRegistry()
        vals = record_fleet_telemetry(reg, FleetTelemetry.zeros(3),
                                      prefix="adapter")
        assert vals == {"adapter_spike_rate": 0.0,
                        "adapter_mean_abs_dw": 0.0,
                        "adapter_sat_frac": 0.0,
                        "adapter_occupancy": 0.0}
