"""Fleet-mode `layer_step` of the PyTorch port against the JAX reference.

The JAX side is `repro.core.engine.layer_step(impl="xla")` under
``jax.jit``; the port runs on CPU tensors, i.e. the plain version of the
fleet-step kernels.  The fixed-point datapath is held BIT for bit (events,
membranes, traces, weights); float32 within rtol = atol = 1e-5, the
tolerance of tests/test_fleet.py:168 (the psum is summed in another order).
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import engine as JE
from repro.kernels.plasticity import quant as JQ
from repro_torch.core import engine as TE
from repro_torch.kernels.plasticity import kernel as TK
from repro_torch.kernels.plasticity import quant as TQ

B = 6


# (N, M, spiking, teach, active): M = 200 is not a multiple of 128
CASES = [
    (6, 2, True, None, None),
    (8, 128, True, None, "mask"),
    (16, 200, True, "per-stream", None),
    (128, 8, False, None, "mask"),
    (12, 5, False, "shared", "mask"),
]


def _inputs(rng, n, m, quant, teach, active):
    d = {}
    if quant:
        d["x"] = rng.choice([0, 256], (B, n)).astype(np.int32)
        d["w"] = rng.integers(-127, 128, (B, n, m)).astype(np.int8)
        d["v"] = rng.integers(-600, 600, (B, m)).astype(np.int32)
        d["tpre"] = rng.integers(0, 1200, (B, n)).astype(np.int32)
        d["tpost"] = rng.integers(-300, 1200, (B, m)).astype(np.int32)
        # heterogeneous per-slot scales and per-session seeds
        d["scale"] = np.where(np.arange(B) % 2 == 0, 1 / 32,
                              1 / 16).astype(np.float32)
        d["seed"] = rng.integers(-2 ** 31, 2 ** 31, B).astype(np.int32)
        tdt, tmag = np.int32, 300
    else:
        d["x"] = (rng.random((B, n)) < 0.4).astype(np.float32)
        d["w"] = rng.uniform(-1, 1, (B, n, m)).astype(np.float32)
        d["v"] = rng.standard_normal((B, m)).astype(np.float32)
        d["tpre"] = (rng.random((B, n)) * 3).astype(np.float32)
        d["tpost"] = (rng.random((B, m)) * 3).astype(np.float32)
        d["scale"] = d["seed"] = None
        tdt, tmag = np.float32, 0.5
    d["theta"] = (rng.standard_normal((4, n, m)) * 0.02).astype(np.float32)
    shape = {"per-stream": (B, m), "shared": (m,)}.get(teach)
    d["teach"] = None if shape is None else (
        (rng.standard_normal(shape) * tmag).astype(tdt))
    d["active"] = (None if active is None
                   else np.array([1, 0, 1, 1, 0, 1], np.int32))
    return d


def _params(quant, spiking):
    kw = dict(v_th=1.0, v_reset=0.0, w_clip=4.0, plastic=True,
              spiking=spiking)
    if quant:
        qj = JQ.QuantConfig()
        kw.update(tau_m=qj.tau_m, trace_decay=qj.decay)
        return (JE.EngineParams(quant=qj, **kw),
                TE.EngineParams(quant=TQ.QuantConfig(), **kw))
    kw.update(tau_m=2.0, trace_decay=0.8)
    return JE.EngineParams(**kw), TE.EngineParams(**kw)


def _jax_step(d, params):
    def f(w, v, tpre, tpost, theta, scale, x, teach, active, seed):
        st = JE.LayerState(w=w, v=v, trace_pre=tpre, trace_post=tpost,
                           theta=theta, w_scale=scale)
        st, out = JE.layer_step(st, x, params=params, impl="xla",
                                teach=teach, active=active, seed=seed)
        return st.w, st.v, st.trace_post, out
    return [np.asarray(a) for a in jax.jit(f)(
        d["w"], d["v"], d["tpre"], d["tpost"], d["theta"], d["scale"],
        d["x"], d["teach"], d["active"], d["seed"])]


def _torch_step(d, params):
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in d.items()}
    st = TE.LayerState(w=t["w"], v=t["v"], trace_pre=t["tpre"],
                       trace_post=t["tpost"], theta=t["theta"],
                       w_scale=t["scale"])
    st, out = TE.layer_step(st, t["x"], params=params, teach=t["teach"],
                            active=t["active"], seed=t["seed"])
    return [a.numpy() for a in (st.w, st.v, st.trace_post, out)]


@pytest.mark.parametrize("mode", ("float32", "int8"))
@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}x{c[1]}-"
                         f"{'spk' if c[2] else 'readout'}-teach{c[3]}-"
                         f"{c[4] or 'all'}")
def test_layer_step_matches_jax(mode, case):
    n, m, spiking, teach, active = case
    quant = mode == "int8"
    rng = np.random.default_rng(n * 1000 + m)
    d = _inputs(rng, n, m, quant, teach, active)
    pj, pt = _params(quant, spiking)
    want = _jax_step(d, pj)
    got = _torch_step(d, pt)
    for name, a, b in zip(("w", "v", "trace_post", "out"), want, got):
        assert a.dtype == b.dtype, name
        if quant:
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5,
                                       err_msg=name)
    if active is not None:
        off = d["active"] == 0
        np.testing.assert_array_equal(got[0][off], d["w"][off])
        assert not got[3][off].any()


def test_heterogeneous_per_slot_scales_move_membranes():
    """Equal payloads under scales 1/32 and 1/16 must give DIFFERENT
    membranes (the per-slot scale reaches the current) and the port must
    equal JAX bit for bit on both slots."""
    rng = np.random.default_rng(9)
    d = _inputs(rng, 8, 16, True, None, None)
    for k in ("x", "w", "v", "tpre", "tpost", "seed"):
        d[k] = np.broadcast_to(d[k][:1], d[k].shape).copy()
    d["x"][:] = 256
    d["v"][:] = 0
    pj, pt = _params(True, True)
    want, got = _jax_step(d, pj), _torch_step(d, pt)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(a, b)
    v = got[1]
    assert not np.array_equal(v[0], v[1]), "scale did not reach the membrane"


def test_kernel_wrapper_takes_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version; a tensor on another device
    raises rather than running anything silently."""
    rng = np.random.default_rng(3)
    d = _inputs(rng, 4, 3, False, None, None)
    t = {k: torch.from_numpy(v) for k, v in d.items() if v is not None}
    args = (t["x"], t["w"], t["theta"], t["v"], t["tpre"], t["tpost"])
    for a, b in zip(TK.fleet_step(*args), TK.fleet_step_plain(*args)):
        assert torch.equal(a, b)
    meta = tuple(a.to("meta") for a in args)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TK.fleet_step(*meta)



# (B, N, M) of tests/test_fleet.py:134, the bf16 shapes of the JAX kernel
BF16_SHAPES = [(1, 8, 8), (4, 32, 48), (2, 100, 130), (8, 128, 128),
               (3, 17, 257)]


def _bf16(a):
    """numpy float32 -> numpy bfloat16 (round to nearest even)."""
    return np.asarray(jax.numpy.asarray(a, jax.numpy.bfloat16))


@pytest.mark.parametrize("b,n,m", BF16_SHAPES)
def test_layer_step_bf16_matches_jax_bitwise(b, n, m):
    """bfloat16 state, weights and rule: the plain fleet step (float32
    arithmetic, one rounding per output) equals jitted JAX ``impl="xla"``
    bit for bit, in bfloat16, with the teaching current and slot mask."""
    from repro_torch import convert
    rng = np.random.default_rng(b * 131 + n + m)
    d = dict(x=(rng.random((b, n)) < 0.5).astype(np.float32),
             w=rng.standard_normal((b, n, m)) * 0.1,
             v=rng.standard_normal((b, m)) * 0.1,
             tpre=rng.random((b, n)), tpost=rng.random((b, m)),
             theta=rng.standard_normal((4, n, m)) * 0.01,
             teach=rng.standard_normal((b, m)) * 0.5)
    d = {k: _bf16(v) for k, v in d.items()}
    d.update(scale=None, seed=None,
             active=(np.arange(b) % 3 != 1).astype(np.int32))
    pj, pt = _params(False, True)
    want = _jax_step(d, pj)
    t = {k: None if v is None else convert.tensor(v, "cpu")
         for k, v in d.items()}
    st = TE.LayerState(w=t["w"], v=t["v"], trace_pre=t["tpre"],
                       trace_post=t["tpost"], theta=t["theta"])
    st, out = TE.layer_step(st, t["x"], params=pt, teach=t["teach"],
                            active=t["active"])
    for name, a, g in zip(("w", "v", "trace_post", "out"), want,
                          (st.w, st.v, st.trace_post, out)):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(a, np.float32),
                                      err_msg=name)


def test_float_kernels_take_float32_or_bfloat16_only():
    """The float kernels' dtype contract, checked before any launch: every
    state operand float32, or every one bfloat16; the rule in the state's
    dtype or float32; float16, float64 and mixes raise."""
    f32 = torch.zeros(2)
    bf = f32.to(torch.bfloat16)
    assert TK.float_dtype("k", [("x", f32), ("w", f32)], [f32]) \
        == torch.float32
    assert TK.float_dtype("k", [("x", bf), ("w", bf)], [bf, f32, None]) \
        == torch.bfloat16
    for ops, thetas in (([("x", f32.half())], ()),
                        ([("x", f32.double())], ()),
                        ([("x", f32), ("w", bf)], ()),
                        ([("x", bf), ("w", f32)], ()),
                        ([("x", f32)], [bf]),
                        ([("x", bf)], [f32.half()])):
        with pytest.raises(ValueError):
            TK.float_dtype("k", ops, thetas)


# The fleet-step kernels' launch on a 132-SM card with 227 KB a CTA:
# (B, N, M, dtype) -> (warps, tile, buffers, rule route, shared memory,
# CTAs at one CTA an SM).  The controller's layers at B = 4096 take, in
# float, two warps a stream in double-buffered tiles of 8 streams, in int8
# one wave of 32 single-buffered one-warp streams a CTA, the rule resident
# in both; the LM adapter's 128 x 128 at B = 4 takes 32 warps a stream (16
# in int8), the rule through L2; 600 adapter-sized streams are more than a
# wave and are double-buffered.
PLAN_CASES = [
    ((4096, 8, 128, "float32"), (2, 8, "double", "smem", 103824, 132)),
    ((4096, 128, 8, "float32"), (2, 8, "double", "smem", 99984, 132)),
    ((4096, 8, 128, "int8"), (1, 32, "single", "smem", 101392, 128)),
    ((4096, 128, 8, "bfloat16"), (2, 8, "double", "smem", 50320, 132)),
    ((4, 128, 128, "float32"), (32, 1, "single", "l2", 68512, 4)),
    ((4, 128, 128, "int8"), (16, 1, "single", "l2", 19168, 4)),
    ((4, 128, 128, "bfloat16"), (32, 1, "single", "l2", 34720, 4)),
    ((2117, 8, 48, "int8"), (1, 17, "single", "smem", 24112, 125)),
    ((600, 128, 128, "float32"), (32, 1, "double", "l2", 136096, 132)),
    ((600, 128, 128, "int8"), (16, 2, "double", "l2", 75184, 132)),
]
BYTES = {"float32": (4, 4, 4), "bfloat16": (2, 2, 2), "int8": (1, 4, 4)}


@pytest.mark.parametrize("case,want", PLAN_CASES,
                         ids=lambda c: "-".join(map(str, c))
                         if isinstance(c[0], int) and len(c) == 4 else None)
def test_fleet_step_plan_pins_the_launch(case, want):
    b, n, m, kind = case
    wb, sb, tb = BYTES[kind]
    plan = TK.fleet_step_plan(b, n, m, True, sms=132, w_bytes=wb,
                              s_bytes=sb, theta_bytes=tb, occupancy=1)
    assert (plan["warps"], plan["tile"], plan["buffers"], plan["theta"],
            plan["smem"], plan["ctas"]) == want
    assert plan["threads"] == 32 * plan["warps"] * plan["tile"] <= 1024
    roles = plan["role_smem"]
    assert plan["smem"] == 16 + roles["theta"] + plan["tile"] * roles["slot"]
    assert plan["smem"] <= TK.DEFAULT_SMEM_LIMIT


def test_fleet_step_plan_routes_and_refusals():
    """A frozen layer keeps no rule; a rule that would take more than a
    quarter of shared memory goes through L2; a stream that does not fit
    one CTA raises rather than falling back."""
    kw = dict(sms=132, occupancy=1)
    assert TK.fleet_step_plan(64, 8, 128, False, **kw)["theta"] == "l2"
    assert TK.fleet_step_plan(64, 96, 192, True, **kw)["theta"] == "l2"
    assert TK.fleet_step_plan(64, 32, 96, True, **kw)["theta"] == "smem"
    with pytest.raises(ValueError, match="shared memory"):
        TK.fleet_step_plan(4, 256, 256, True, **kw)
    # the persistent grid: every CTA an SM holds, fewer where tiles run out
    plan = TK.fleet_step_plan(4096, 8, 128, True, sms=132, occupancy=2)
    assert (plan["ctas_per_sm"], plan["ctas"]) == (2, 264)
    plan = TK.fleet_step_plan(1000, 8, 128, True, sms=132, occupancy=2)
    assert (plan["ctas_per_sm"], plan["ctas"]) == (2, -(-1000 // 8))


def test_fleet_step_scalars_and_masks_need_no_device_op():
    """Scalar scales and seeds travel in the argument struct, a bool or
    uint8 slot mask is read as it is; (B,) operands and other masks are
    checked and converted."""
    dev = torch.device("cpu")
    assert TK.stream_scalar(None, 4, torch.int32, dev) == (None, 0, 0)
    assert TK.stream_scalar(0.03125, 4, torch.float32, dev) == (
        None, 0, 0.03125)
    t, stride, _ = TK.stream_scalar(torch.tensor(0.5), 4, torch.float32, dev)
    assert stride == 0 and t.ndim == 0 and float(t) == 0.5
    per = torch.arange(4, dtype=torch.int32)
    t, stride, _ = TK.stream_scalar(per, 4, torch.int32, dev)
    assert stride == 1 and t is per
    with pytest.raises(ValueError):
        TK.stream_scalar(per, 5, torch.int32, dev)
    # a number seed is held to int32 as the plain version holds it: a
    # fraction truncated, a value outside int32 refused by both
    assert TK.stream_scalar(7.9, 4, torch.int32, dev) == (None, 0, 7)
    d = _inputs(np.random.default_rng(5), 8, 16, True, None, None)
    for seed in (2 ** 31, -2 ** 31 - 1):
        with pytest.raises(RuntimeError, match="overflow"):
            TK.stream_scalar(seed, 4, torch.int32, dev)
        with pytest.raises(RuntimeError, match="overflow"):
            TK.fleet_step_q_plain(
                *(torch.from_numpy(d[k]) for k in (
                    "x", "w", "scale", "theta", "v", "tpre", "tpost")),
                qcfg=TQ.QuantConfig(), seed=seed)
    for mask in (torch.tensor([True, False, True]),
                 torch.tensor([1, 0, 2], dtype=torch.uint8)):
        assert TK.active_mask(mask, 3, dev) is mask
    got = TK.active_mask(torch.tensor([3, 0, -1]), 3, dev)
    assert got.dtype == torch.uint8 and got.tolist() == [1, 0, 1]
