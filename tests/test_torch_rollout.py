"""The port's fused rollout window against the JAX reference.

`repro_torch.core.engine.rollout` on CPU tensors (the plain K-loop of the
rollout kernel) against `repro.core.engine.rollout(impl="xla")` under
``jax.jit``.  int8 is held BIT for bit for every K; float32 within
rtol = atol = 1e-5 for K <= 4 at controller widths (drives and weights are
grid-valued, so the first step's psums are exact in any summation order).
"""
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.kernels.plasticity import quant as JQ
from repro_torch import convert
from repro_torch.core import engine as TE
from repro_torch.core.plasticity import fma32
from repro_torch.kernels.plasticity import fused as TF
from repro_torch.kernels.plasticity import kernel as TK
from repro_torch.kernels.plasticity import quant as TQ

B = 5
ACTIVE = np.array([1, 1, 0, 1, 0], np.int32)
SIZES = {1: (6, 4), 2: (8, 32, 4)}


def _net(rng, sizes, quant, t0):
    n_layers = len(sizes) - 1
    if quant:
        w = [rng.integers(-40, 41, (B, sizes[i], sizes[i + 1])
                          ).astype(np.int8) for i in range(n_layers)]
        v = [rng.integers(-300, 300, (B, m)).astype(np.int32)
             for m in sizes[1:]]
        tr = [rng.integers(0, 900, (B, n)).astype(np.int32) for n in sizes]
        scale = [np.where(np.arange(B) % 2 == 0, 1 / 32, 1 / 16
                          ).astype(np.float32) for _ in range(n_layers)]
    else:
        w = [np.round(rng.uniform(-0.5, 0.5, (B, sizes[i], sizes[i + 1]))
                      * 64).astype(np.float32) / 64 for i in range(n_layers)]
        v = [rng.uniform(-0.5, 0.9, (B, m)).astype(np.float32)
             for m in sizes[1:]]
        tr = [rng.uniform(0, 2, (B, n)).astype(np.float32) for n in sizes]
        scale = []
    return types.SimpleNamespace(w=tuple(w), v=tuple(v), trace=tuple(tr),
                                 t=np.int32(t0), w_scale=tuple(scale))


def _case(rng, quant, k, n_layers, teach):
    sizes = SIZES[n_layers]
    net = _net(rng, sizes, quant, 2 ** 31 - 9 if quant else 0)
    theta = [(rng.standard_normal((4, sizes[i], sizes[i + 1])) * 0.02
              ).astype(np.float32) for i in range(n_layers)]
    if quant:
        drives = rng.integers(-512, 512, (k, B, sizes[0])).astype(np.int32)
        tch = rng.integers(-200, 200, (k, B, sizes[-1])).astype(np.int32)
    else:
        drives = (np.round(rng.standard_normal((k, B, sizes[0])) * 16) / 16
                  ).astype(np.float32)
        tch = (rng.standard_normal((k, B, sizes[-1])) * 0.3
               ).astype(np.float32)
    tch = {None: None, "per-step": tch, "held": tch[0]}[teach]
    return net, theta, drives, tch


def _params(quant, n_layers, mod):
    qc = (JQ.QuantConfig() if mod is JE else TQ.QuantConfig()) \
        if quant else None
    kw = dict(v_th=1.0, v_reset=0.0, w_clip=4.0, plastic=True, quant=qc,
              tau_m=2.0, trace_decay=0.75 if quant else 0.8)
    return [mod.EngineParams(spiking=i < n_layers - 1, **kw)
            for i in range(n_layers)]


def _jax_rollout(net, theta, drives, teach, active, quant, n_layers):
    params = _params(quant, n_layers, JE)

    def f(w, v, tr, t, sc, th, dr, te, act):
        st = JE.NetworkState(w=w, v=v, trace=tr, t=t, w_scale=sc)
        st, outs = JE.rollout(st, th, dr, params=params, impl="xla",
                              teach=te, active=act)
        return st.w, st.v, st.trace, st.t, outs
    w, v, tr, t, outs = jax.jit(f)(net.w, net.v, net.trace, net.t,
                                   net.w_scale, theta, drives, teach, active)
    return [np.asarray(a) for a in (*w, *v, *tr, outs)], int(t)


def _torch_rollout(net, theta, drives, teach, active, quant, n_layers):
    st = convert.network_state(net, device="cpu")
    as_t = lambda a: None if a is None else torch.from_numpy(np.array(a))
    st, outs = TE.rollout(st, convert.theta(theta, device="cpu"),
                          as_t(drives), params=_params(quant, n_layers, TE),
                          teach=as_t(teach), active=as_t(active))
    return [a.numpy() for a in (*st.w, *st.v, *st.trace, outs)], int(st.t)


ROLLOUT_CASES = [(m, k, n_layers, teach)
                 for m, ks in (("float32", (1, 4)), ("int8", (1, 4, 16)))
                 for k in ks for n_layers in (1, 2)
                 for teach in ((None,) if n_layers == 1 else ("per-step",))
                 ] + [("int8", 4, 1, "held"), ("float32", 4, 1, "held")]


@pytest.mark.parametrize("mode,k,n_layers,teach", ROLLOUT_CASES)
def test_rollout_matches_jax(mode, k, n_layers, teach):
    quant = mode == "int8"
    rng = np.random.default_rng(100 * k + 10 * n_layers + quant)
    net, theta, drives, tch = _case(rng, quant, k, n_layers, teach)
    want, t_j = _jax_rollout(net, theta, drives, tch, ACTIVE, quant, n_layers)
    got, t_t = _torch_rollout(net, theta, drives, tch, ACTIVE, quant,
                              n_layers)
    assert t_j == t_t
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        if quant:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_k1_equals_one_layer_step_per_layer(mode):
    """A one-step window is exactly the per-event path: the input trace
    update, then `layer_step` layer by layer with fold_seed(t, i)."""
    quant = mode == "int8"
    rng = np.random.default_rng(7)
    net, theta, drives, _ = _case(rng, quant, 1, 2, None)
    st = convert.network_state(net, device="cpu")
    th = convert.theta(theta, device="cpu")
    x = torch.from_numpy(drives[0])
    act = torch.from_numpy(ACTIVE)
    params = _params(quant, 2, TE)
    fused, outs = TE.rollout(st, th, x[None], params=params, active=act)
    tr = list(st.trace)
    if quant:
        tr0 = TQ.trace_update_q(tr[0], x, params[0].quant)
    else:
        tr0 = fma32(0.8, tr[0], x)
    tr[0] = torch.where(act.bool()[:, None], tr0, tr[0])
    for i in range(2):
        layer = TE.LayerState(st.w[i], st.v[i], tr[i], tr[i + 1], th[i],
                              st.w_scale[i] if quant else None)
        layer, x = TE.layer_step(
            layer, x, params=params[i], active=act,
            seed=TQ.fold_seed(st.t, i) if quant else None)
        assert torch.equal(layer.w, fused.w[i])
        assert torch.equal(layer.v, fused.v[i])
        assert torch.equal(layer.trace_post, fused.trace[i + 1])
        tr[i + 1] = layer.trace_post
    assert torch.equal(tr[0], fused.trace[0])
    assert torch.equal(x, outs[0])


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_inactive_slots_bit_frozen_across_window(mode):
    quant = mode == "int8"
    rng = np.random.default_rng(8)
    net, theta, drives, tch = _case(rng, quant, 16, 2, "per-step")
    got, _ = _torch_rollout(net, theta, drives, tch, ACTIVE, quant, 2)
    before = [*net.w, *net.v, *net.trace]
    off = ACTIVE == 0
    for a, b in zip(before, got):
        np.testing.assert_array_equal(np.asarray(a)[off], b[off])
    assert not got[-1][:, off].any()                   # outputs zeroed
    assert any(not np.array_equal(np.asarray(a)[~off], b[~off])
               for a, b in zip(before, got))


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_shared_weight_window_matches_jax(mode):
    """Shared weights (N, M) with batched activations, against the JAX
    oracle."""
    quant = mode == "int8"
    rng = np.random.default_rng(12)
    net, theta, drives, _ = _case(rng, quant, 4, 1, None)
    net.w = tuple(w[0] for w in net.w)
    net.w_scale = tuple(s[0] for s in net.w_scale)
    want, _ = _jax_rollout(net, theta, drives, None, None, quant, 1)
    got, _ = _torch_rollout(net, theta, drives, None, None, quant, 1)
    for a, b in zip(want, got):
        if quant:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


SHARED_CASES = [(m, k, batched) for m, ks in (("float32", (1, 4)),
                                              ("int8", (1, 4, 8)))
                for k in ks for batched in (False, True)]


@pytest.mark.parametrize("mode,k,batched", SHARED_CASES)
def test_shared_window_matches_pallas_interpret(mode, k, batched):
    """The shared-weight window (the grid-(1,) mode of the TPU rollout
    kernel, run by the Pallas interpreter) on a 2-layer net with a held
    teaching current; unbatched state goes through the B = 1 promotion.
    int8 from t = 2**31 - 9, so seed + k wraps inside the window."""
    quant = mode == "int8"
    rng = np.random.default_rng(300 + 10 * k + 2 * batched + quant)
    net, theta, drives, tch = _case(rng, quant, k, 2, "held")
    net.w = tuple(w[0] for w in net.w)
    net.w_scale = tuple(s[0] for s in net.w_scale)
    if not batched:
        net.v = tuple(v[0] for v in net.v)
        net.trace = tuple(t[0] for t in net.trace)
        drives, tch = drives[:, 0], tch[0]
    params = _params(quant, 2, JE)

    def f(w, v, tr, t, sc, th, dr, te):
        st = JE.NetworkState(w=w, v=v, trace=tr, t=t, w_scale=sc)
        st, outs = JE.rollout(st, th, dr, params=params,
                              impl="pallas-interpret", teach=te)
        return st.w, st.v, st.trace, outs
    w, v, tr, outs = jax.jit(f)(net.w, net.v, net.trace, net.t, net.w_scale,
                                theta, drives, tch)
    want = [np.asarray(a) for a in (*w, *v, *tr, outs)]
    got, _ = _torch_rollout(net, theta, drives, tch, None, quant, 2)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        if quant:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)


def _bad_calls():
    """(name, callable) pairs, each of which must raise ValueError."""
    rng = np.random.default_rng(0)
    net, theta, drives, _ = _case(rng, True, 2, 2, None)
    st = convert.network_state(net, device="cpu")
    th = convert.theta(theta, device="cpu")
    dr = torch.from_numpy(drives)
    p = _params(True, 2, TE)
    pf = _params(False, 2, TE)
    act = torch.from_numpy(ACTIVE)
    layer = st.layer(0, th[0])
    x0 = dr[0]
    yield "params count", lambda: TE.rollout(st, th, dr, params=p[:1])
    yield "non-uniform tau", lambda: TE.rollout(
        st, th, dr, params=[p[0], TE.EngineParams(tau_m=4.0, quant=p[0].quant,
                                                   trace_decay=0.75)])
    yield "theta count", lambda: TE.rollout(st, th[:1], dr, params=p)
    yield "drives rank", lambda: TE.rollout(st, th, dr[0, 0], params=p)
    yield "fleet drives", lambda: TE.rollout(st, th, dr[:, 0], params=p)
    yield "K = 0", lambda: TE.rollout(st, th, dr[:0], params=p)
    yield "drives B", lambda: TE.rollout(st, th, dr[:, :2], params=p)
    yield "active shape", lambda: TE.rollout(st, th, dr, params=p,
                                             active=act[:2])
    yield "quant drives dtype", lambda: TE.rollout(st, th, dr.float(),
                                                   params=p)
    yield "quant teach dtype", lambda: TE.rollout(
        st, th, dr, params=p, teach=torch.zeros(B, 4))
    yield "teach rank", lambda: TE.rollout(
        st, th, dr, params=p, teach=torch.zeros(2, 2, B, 4, dtype=torch.int32))
    yield "quant tau", lambda: TE.rollout(
        st, th, dr, params=TE.EngineParams(tau_m=3.0, quant=p[0].quant,
                                           trace_decay=0.75))
    yield "quant decay", lambda: TE.rollout(
        st, th, dr, params=TE.EngineParams(quant=p[0].quant))
    yield "quant x dtype", lambda: TE.layer_step(layer, x0.float(),
                                                 params=p[0])
    yield "fleet x shape", lambda: TE.layer_step(layer, x0[:2], params=p[0])
    yield "fleet v shape", lambda: TE.layer_step(
        TE.LayerState(layer.w, layer.v[0], layer.trace_pre, layer.trace_post,
                      layer.theta, layer.w_scale), x0, params=p[0])
    yield "layer active shape", lambda: TE.layer_step(
        layer, x0, params=p[0], active=act[:3])
    yield "active on shared weights", lambda: TE.layer_step(
        TE.LayerState(layer.w[0].float(), layer.v.float(),
                      layer.trace_pre.float(), layer.trace_post.float(),
                      layer.theta), x0.float(), params=pf[0], active=act)
    yield "active on shared rollout", lambda: TE.rollout(
        TE.NetworkState(w=tuple(w[0].float() for w in st.w),
                        v=tuple(v.float() for v in st.v),
                        trace=tuple(t.float() for t in st.trace), t=st.t),
        th, dr.float(), params=pf, active=act)


BAD = list(_bad_calls())


@pytest.mark.parametrize("name", [n for n, _ in BAD])
def test_value_error_contracts(name):
    fn = dict(BAD)[name]
    with pytest.raises(ValueError):
        fn()


# The fleet window's plan at the 8-128-8 controller, B = 4096, block_b = 8,
# on 132 SMs holding one CTA each, by hand.  A tile of 8 streams, each run by
# 2 warps (its widest layer's 1024 synapses over 16 a thread): 512
# threads.  A state buffer in the compute types holds w (8 x 128 and
# 128 x 8), v (128 and 8) and the traces (8, 128, 8), each 16-byte
# aligned, in fixed point also the two scales and the seed (16 bytes); the
# bus 2 x 128 floats; the spare buffer's two mbarriers 16 bytes; the rules
# (4 x 2048 coefficients) resident behind their own mbarrier (16 bytes).
_STATE_F32 = 2 * 4096 + (512 + 32) + (32 + 512 + 32)          # 9312
_STATE_I8 = 2 * 1024 + (512 + 32) + (32 + 512 + 32) + 16      # 3184
_RAW_BF16 = 2 * 2048 + (256 + 16) + (16 + 256 + 16)           # 4656
FLEET_PLANS = {
    # dtype: (w_bytes, s_bytes, theta_bytes, quant, buffers, theta bytes,
    #         state, spare)
    "float32": (4, 4, 4, False, "double", 32768, _STATE_F32, _STATE_F32),
    "int8": (1, 4, 4, True, "double", 32768, _STATE_I8, _STATE_I8),
    # the next stream lands raw (bf16) beside the float32 state buffer
    "bfloat16": (2, 2, 2, False, "staged", 16384, _STATE_F32, _RAW_BF16),
}


@pytest.mark.parametrize("dtype,telemetry", [
    ("float32", False), ("int8", False), ("bfloat16", False),
    ("float32", True), ("int8", True)])
def test_shared_memory_plan(dtype, telemetry):
    """The fleet kernel's plan pinned at 8-128-8: tile, warps a stream,
    per-role shared memory, the rules' route and the persistent grid.  The
    telemetry variant keeps its accumulators in registers, so its plan is
    its twin's (only the occupancy query, a stated 1 here, could differ)."""
    wb, sb, tb, quant, buffers, th, state, spare = FLEET_PLANS[dtype]
    plan = TF.fleet_plan((8, 128, 8), 4096, 8, (True, True), quant=quant,
                         limit=TK.DEFAULT_SMEM_LIMIT, w_bytes=wb,
                         s_bytes=sb, theta_bytes=tb, sms=132, occupancy=1)
    slot = state + spare + 1024 + 16
    assert plan == dict(
        tile=8, warps=2, threads=512, buffers=buffers, theta="smem",
        role_smem=dict(theta=th, state=state, spare=spare, bus=1024,
                       barriers=16, slot=slot),
        smem=16 + th + 8 * slot, ctas_per_sm=1, ctas=132)
    # more CTAs than tiles: the grid is the tiles
    few = TF.fleet_plan((8, 128, 8), 100, 8, (True, True), quant=quant,
                        limit=TK.DEFAULT_SMEM_LIMIT, w_bytes=wb,
                        s_bytes=sb, theta_bytes=tb, sms=132, occupancy=2)
    assert few["ctas"] == 13 and few["ctas_per_sm"] == 2


def test_fleet_plan_routes_and_raises():
    """Where two buffers a stream do not fit, one does; where the rules do
    not fit either, they are read through L2; where nothing fits, the plan
    raises — the kernel never falls back.  float32 at 8-128-8: 10 streams
    double-buffered with resident rules (229424 bytes), 11 single-buffered
    (146480), 20 single-buffered with the rules in L2 (206736), 23 too
    many (237744 > 232448); 33 streams need more than 1024 threads."""
    kw = dict(quant=False, limit=TK.DEFAULT_SMEM_LIMIT)
    net = ((8, 128, 8), 4096)
    expect = {10: ("double", "smem", 2, 229424),
              11: ("single", "smem", 2, 146480),
              20: ("single", "l2", 1, 206736)}
    for bb, (buffers, theta, warps, smem) in expect.items():
        plan = TF.fleet_plan(*net, bb, (True, True), **kw)
        assert (plan["buffers"], plan["theta"], plan["warps"],
                plan["smem"]) == (buffers, theta, warps, smem), bb
    # a non-plastic layer keeps no rule: layer 0's alone fits beside 20
    half = TF.fleet_plan(*net, 20, (True, False), **kw)
    assert (half["theta"], half["role_smem"]["theta"]) == ("smem", 16384)
    assert TF.fleet_plan(*net, 8, (False, False), **kw)[
        "role_smem"]["theta"] == 0
    for bb in (23, 33):
        with pytest.raises(ValueError, match="block_b"):
            TF.fleet_plan(*net, bb, (True, True), **kw)
    # one stream wider than shared memory
    with pytest.raises(ValueError, match="shared memory"):
        TF.fleet_plan((8, 2048, 64), 16, 1, (True, True), **kw)


# The fleet plan of the rule search's controller, 11-128-2 (position's
# observation and torques, the paper's 128 hidden), by hand.  Tile 8; the
# widest layer 11 x 128 = 1408 synapses wants ceil(1408 / 512) = 3 warps a
# stream, a power of two capped at 1024 / (32 x 8) = 4: 4 warps, 1024
# threads.  A state buffer: w 5632 + 1024, v 512 + 8 -> 16, traces 44 -> 48,
# 512, 8 -> 16 (7760); the bus 2 x 128 floats (1024), the spare buffer's
# mbarriers 16: a slot 7760 + 7760 + 1024 + 16 = 16560.  The rules, 4 x
# (1408 + 256) coefficients (26624 bytes), stay resident behind their
# mbarrier (16); a weight-trained window (no layer plastic) keeps none.  One
# tile a CTA: B = 8 (one candidate's train tasks) is one CTA, B = 72 (the
# eval tasks) 9, B = 384 (24 pairs x 8 tasks, weight-trained) 48.
_SEARCH_SLOT = 7760 + 7760 + 1024 + 16


@pytest.mark.parametrize("plastic", (True, False),
                         ids=("plastic", "weight-trained"))
@pytest.mark.parametrize("batch,ctas", ((8, 1), (72, 9), (384, 48)))
def test_fleet_plan_at_the_rule_search_width(batch, ctas, plastic):
    plan = TF.fleet_plan((11, 128, 2), batch, 8, (plastic, plastic),
                         quant=False, limit=TK.DEFAULT_SMEM_LIMIT, sms=132,
                         occupancy=1)
    th = 26624 if plastic else 0
    assert plan == dict(
        tile=8, warps=4, threads=1024, buffers="double", theta="smem",
        role_smem=dict(theta=th, state=7760, spare=7760, bus=1024,
                       barriers=16, slot=_SEARCH_SLOT),
        smem=16 + th + 8 * _SEARCH_SLOT, ctas_per_sm=1, ctas=ctas)


# The shared-weight window's plan at 784-1024-10, B = 1, on 132 SMs, by
# hand.  Layer 0 (N = 784) takes 128 CTAs of 8 columns, layer 1 (N = 1024,
# M = 10) 3 of 4: starting from one column a CTA, the layer whose doubled
# share N * 2c is least doubles until 1024 / c0 + 10 / c1 <= 132 (784 * 2
# < 1024 * 2 < 784 * 4 < 1024 * 4 < 784 * 8).  Every role holds, beside its
# slabs: membranes and post traces 2 * 16-aligned(4c), the input trace or
# pre traces and the staged events 2 * 4N, the pre means 4N, the post sums
# 128, the partial sums 16 warps * 8 rows * 32 * 4 = 16384, two mbarriers
# 16 and 128 bytes of alignment slack.
_ROLE0 = 2 * 32 + 2 * 3136 + 3136 + 128 + 16384 + 16 + 128     # 26128
_ROLE1 = 2 * 16 + 2 * 4096 + 4096 + 128 + 16384 + 16 + 128     # 28976
SHARED_PLANS = {
    # theta (4N, M) of layer 0: 13 TMA boxes (3136 rows / 256, rounded up)
    # of 242 rows rounded to a multiple of 128 / (c * 4) = 4 -> 244, i.e.
    # 13 * 244 rows of 32 bytes; w 4 boxes of 196 rows.  Layer 1's rows of
    # 40 bytes are no multiple of 16: cp.async in 8-byte pieces.
    "float32": (4, 4, [("tma", 16, 196), ("cp.async", 8, 0)],
                [("tma", 16, 244), ("cp.async", 8, 0)],
                [13 * 244 * 32 + 784 * 32 + _ROLE0,
                 4096 * 16 + 1024 * 16 + _ROLE1]),
    # int8 w: 8-byte rows of the owned block (no TMA box), and layer 1's
    # rows of 10 bytes take the 4-byte words covering them (2 a row),
    # repacked into the int8 slab; theta float32 as above
    "int8": (1, 4, [("cp.async", 8, 0), ("cp.async words", 4, 0)],
             [("tma", 16, 244), ("cp.async", 8, 0)],
             [13 * 244 * 32 + 784 * 8 + _ROLE0,
              4096 * 16 + 1024 * 4 + 1024 * 8 + _ROLE1]),
    # bf16: boxes of 16-byte rows, so rows a multiple of 8 (w 200, theta
    # 248); the w slab float32 on chip beside its bf16 stage (4 * 200
    # rows); layer 1's 20-byte rows in 4-byte pieces
    "bfloat16": (2, 2, [("tma", 16, 200), ("cp.async", 4, 0)],
                 [("tma", 16, 248), ("cp.async", 4, 0)],
                 [13 * 248 * 16 + 784 * 32 + 800 * 16 + _ROLE0,
                  4096 * 8 + 1024 * 16 + 1024 * 8 + _ROLE1]),
    "bfloat16, float32 rule": (
        2, 4, [("tma", 16, 200), ("cp.async", 4, 0)],
        [("tma", 16, 244), ("cp.async", 8, 0)],
        [13 * 244 * 32 + 784 * 32 + 800 * 16 + _ROLE0,
         4096 * 16 + 1024 * 16 + 1024 * 8 + _ROLE1]),
}


@pytest.mark.parametrize("mode", list(SHARED_PLANS))
def test_shared_window_plan_at_mnist_width(mode):
    """The pipelined shared-weight window's plan at the online learner's
    784-1024-10: CTAs and columns per layer, copy routes (layer 1 never
    TMA), each role's shared memory and the bus depth, pinned by hand."""
    w_bytes, th_bytes, w_routes, th_routes, role = SHARED_PLANS[mode]
    plan = TF.shared_plan((784, 1024, 10), 1, (True, True), mode == "int8",
                          132, TK.DEFAULT_SMEM_LIMIT, w_bytes, th_bytes)
    assert plan["ctas"] == [128, 3] and plan["cols"] == [8, 4]
    assert plan["w"] == w_routes and plan["theta"] == th_routes
    assert plan["w"][1][0] != "tma" and plan["theta"][1][0] != "tma"
    assert plan["role_smem"] == role and plan["smem"] == max(role)
    assert plan["bus_depth"] == TF.SHARED_BUS_DEPTH == 32
    for i, (n, c) in enumerate(((784, 8), (1024, 4))):
        assert TF.shared_smem_bytes(
            n, c, 1, mode == "int8", w_bytes, th_bytes, plan["w"][i],
            plan["theta"][i]) == role[i]


def test_shared_window_plan_raises_without_room():
    """Layers that cannot all be co-resident raise (no lockstep fallback):
    784-1024-10 needs 33 CTAs of 32 columns, more than 8 SMs; a batch
    whose staged rows overflow a CTA raises too; a rule that does not fit
    beside the slab is read through L2 instead."""
    with pytest.raises(ValueError, match="co-resident"):
        TF.shared_plan((784, 1024, 10), 1, (True, True), False, 8,
                       TK.DEFAULT_SMEM_LIMIT)
    with pytest.raises(ValueError, match="shared memory"):
        TF.shared_plan((784, 1024, 10), 64, (True, True), False, 132,
                       TK.DEFAULT_SMEM_LIMIT)
    plan = TF.shared_plan((784, 1024, 10), 1, (True, True), False, 132,
                          120_000)
    assert plan["theta"][0] == ("l2", 0, 0) and plan["smem"] <= 120_000


@pytest.mark.parametrize("rows,m,c,e,want", [
    (784, 1024, 8, 4, ("tma", 16, 196)),       # float32 w of layer 0
    (784, 1024, 16, 1, ("tma", 16, 200)),      # int8, 16 columns
    (96, 48, 2, 4, ("cp.async", 8, 0)),        # 8-byte spans
    (1024, 10, 4, 2, ("cp.async", 4, 0)),      # bf16 rows of 20 bytes
    (1024, 10, 4, 1, ("cp.async words", 4, 0)),  # int8 rows of 10 bytes
    (40, 100, 1, 1, ("cp.async words", 4, 0)),   # one int8 column
    (600, 64, 4, 4, ("tma", 16, 200)),         # 3 boxes of 200 rows
])
def test_shared_window_copy_route(rows, m, c, e, want):
    assert TF.shared_route(rows, m, c, e) == want



# ---- bfloat16 windows ---------------------------------------------------------

BF16_STEP = 2.0 ** -7     # one bf16 rounding step at magnitudes below 2


def _bf16_case(rng, fleet, k):
    """8-32-4 net, bf16 state, weights, rules, drives and a per-step
    teaching current; fleet weights (B, N, M) or shared (N, M)."""
    import jax.numpy as jnp
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16))
    sizes = SIZES[2]
    lead = (B,) if fleet else ()
    net = types.SimpleNamespace(
        w=tuple(bf(rng.uniform(-0.5, 0.5, lead + (sizes[i], sizes[i + 1])))
                for i in range(2)),
        v=tuple(bf(rng.uniform(-0.5, 0.9, (B, m))) for m in sizes[1:]),
        trace=tuple(bf(rng.uniform(0, 2, (B, n))) for n in sizes),
        t=np.int32(0), w_scale=())
    theta = [bf(rng.standard_normal((4, sizes[i], sizes[i + 1])) * 0.02)
             for i in range(2)]
    drives = bf(np.round(rng.standard_normal((k, B, sizes[0])) * 16) / 16)
    teach = bf(rng.standard_normal((k, B, sizes[-1])) * 0.3)
    return net, theta, drives, teach


def _jax_window(net, theta, drives, teach, active, impl, telemetry=False):
    import jax.numpy as jnp
    params = _params(False, 2, JE)

    def f(w, v, tr, th, dr, te, act):
        st = JE.NetworkState(w=w, v=v, trace=tr, t=jnp.int32(0))
        res = JE.rollout(st, th, dr, params=params, impl=impl, teach=te,
                         active=act, telemetry=telemetry)
        st = res[0]
        tel = ([] if not telemetry else
               [jnp.stack([res[2].spike_rate, res[2].mean_abs_dw,
                           res[2].sat_frac], 1)])
        return [*st.w, *st.v, *st.trace, res[1], *tel]
    return [np.asarray(a, np.float32) for a in jax.jit(f)(
        net.w, net.v, net.trace, theta, drives, teach, active)]


def _torch_window(net, theta, drives, teach, active, telemetry=False):
    st = convert.network_state(net, device="cpu")
    as_t = lambda a: None if a is None else convert.tensor(a, "cpu")
    res = TE.rollout(st, convert.theta(theta, device="cpu"), as_t(drives),
                     params=_params(False, 2, TE), teach=as_t(teach),
                     active=as_t(active), telemetry=telemetry)
    st = res[0]
    got = [*st.w, *st.v, *st.trace, res[1]]
    assert all(g.dtype == torch.bfloat16 for g in got)
    tel = ([] if not telemetry else
           [torch.stack([res[2].spike_rate, res[2].mean_abs_dw,
                         res[2].sat_frac], 1)])
    return [g.float().numpy() for g in got + tel]


def _max_diff(xs, ys):
    return max(float(np.abs(x - y).max()) for x, y in zip(xs, ys))


@pytest.mark.parametrize("fleet", (True, False), ids=("fleet", "shared"))
@pytest.mark.parametrize("k", (1, 4, 8))
def test_bf16_window_matches_the_kernel_contract(fleet, k):
    """A bfloat16 window of the plain rollout carries float32 for all K
    steps and rounds once at write-back, as the TPU kernel does: against
    `rollout_pallas` run by the Pallas interpreter within one bf16 step
    (measured: bit for bit), and against the scanned per-step oracle
    (``impl="xla"``, which rounds every step) within JAX's own
    xla-vs-interpreter spread on the same inputs plus that step."""
    rng = np.random.default_rng(700 + 10 * k + fleet)
    net, theta, drives, teach = _bf16_case(rng, fleet, k)
    active = ACTIVE if fleet else None
    pal = _jax_window(net, theta, drives, teach, active, "pallas-interpret")
    xla = _jax_window(net, theta, drives, teach, active, "xla")
    got = _torch_window(net, theta, drives, teach, active)
    for a, g in zip(pal, got):
        np.testing.assert_allclose(g, a, rtol=BF16_STEP, atol=BF16_STEP)
    spread = _max_diff(xla, pal)
    assert _max_diff(got, xla) <= spread + BF16_STEP
    if fleet:
        off = ACTIVE == 0
        before = [*net.w, *net.v, *net.trace]
        for a, g in zip(before, got):
            np.testing.assert_array_equal(g[off], np.asarray(a, np.float32)
                                          [off])


def test_bf16_window_telemetry_matches_the_kernel_contract():
    """The fleet window's telemetry row in bfloat16 (float32 window means)
    against the interpreted TPU kernel within 1e-6 relative, as float32
    window rows are held."""
    rng = np.random.default_rng(777)
    net, theta, drives, teach = _bf16_case(rng, True, 4)
    pal = _jax_window(net, theta, drives, teach, ACTIVE, "pallas-interpret",
                      telemetry=True)
    got = _torch_window(net, theta, drives, teach, ACTIVE, telemetry=True)
    np.testing.assert_allclose(got[-1], pal[-1], rtol=1e-6, atol=1e-7)
    assert not got[-1][ACTIVE == 0].any()


def test_bf16_trace_stays_bf16_and_equals_jax():
    """Queue 3 fault 1: a bfloat16 input trace stays bfloat16 through
    `snn.timestep` (equal to jitted JAX's per-event path at step 2, bit for
    bit) and through `snn.rollout_window` (equal to JAX's window run by the
    interpreted TPU kernel, bit for bit)."""
    import jax.numpy as jnp
    from repro.core import snn as JS
    from repro_torch.core import snn as TS
    bf = jnp.bfloat16
    cfg_j = JS.SNNConfig(layer_sizes=(8, 128, 8), dtype=bf,
                         impl="pallas-interpret")
    cfg_t = TS.SNNConfig(layer_sizes=(8, 128, 8), dtype=torch.bfloat16)
    rng = np.random.default_rng(16)
    theta = [np.asarray(jnp.asarray(rng.standard_normal((4, n, m)) * 0.02,
                                    bf)) for n, m in ((8, 128), (128, 8))]
    obs = np.asarray(jnp.asarray(rng.standard_normal((2, 4, 8)), bf))
    th_t = convert.theta(theta, "cpu")
    obs_t = convert.tensor(obs, "cpu")
    cfg_x = JS.SNNConfig(layer_sizes=(8, 128, 8), dtype=bf, impl="xla")
    step = jax.jit(lambda s, o: JS.timestep(cfg_x, s, theta, o)[0])
    js = JS.init_state(cfg_x, batch=4, fleet=True)
    ts = TS.init_state(cfg_t, batch=4, fleet=True, device="cpu")
    for i in range(2):
        js = step(js, obs[i])
        ts, _ = TS.timestep(cfg_t, ts, th_t, obs_t[i])
    assert ts.trace[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(ts.trace[0].float().numpy(),
                                  np.asarray(js.trace[0], np.float32))
    win = jax.jit(lambda s, d: JS.rollout_window(cfg_j, s, theta, d)[0])
    jw = win(JS.init_state(cfg_j, batch=4, fleet=True), obs)
    tw, _ = TS.rollout_window(
        cfg_t, TS.init_state(cfg_t, batch=4, fleet=True, device="cpu"),
        th_t, obs_t)
    assert tw.trace[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(tw.trace[0].float().numpy(),
                                  np.asarray(jw.trace[0], np.float32))


def test_convert_carries_bf16_state_and_rule_bit_for_bit():
    """A bfloat16 `NetworkState` and rule built by the JAX package reach the
    port as bfloat16 tensors with the same bits."""
    import jax.numpy as jnp
    from repro.core import snn as JS
    cfg = JS.SNNConfig(layer_sizes=(8, 128, 8), dtype=jnp.bfloat16)
    theta = JS.init_theta(cfg, jax.random.PRNGKey(4), scale=0.02)
    st = JS.init_state(cfg, batch=3, fleet=True)
    st = JE.NetworkState(
        w=tuple(jax.random.normal(jax.random.PRNGKey(i), w.shape, w.dtype)
                for i, w in enumerate(st.w)),
        v=st.v, trace=tuple(t + 0.3 for t in st.trace), t=st.t,
        w_scale=st.w_scale)
    got = convert.network_state(st, device="cpu")
    got_th = convert.theta(theta, device="cpu")
    bits = lambda a: np.asarray(a).view(np.uint16)
    for a, g in zip((*st.w, *st.v, *st.trace, *theta),
                    (*got.w, *got.v, *got.trace, *got_th)):
        assert g.dtype == torch.bfloat16 and tuple(g.shape) == a.shape
        np.testing.assert_array_equal(g.view(torch.int16).numpy()
                                      .view(np.uint16), bits(a))
    assert int(got.t) == int(st.t)
