"""The port's shared-weight dual-engine step against the JAX reference.

`repro_torch.core.engine.layer_step` with shared weights ``w (N, M)`` on CPU
tensors (the plain versions of the shared-step kernels, reached through
their wrappers) against `repro.core.engine.layer_step` with
``impl="pallas-interpret"`` (the TPU kernels #4 and #5 run by the Pallas
interpreter) under ``jax.jit``.  int8 is held bit for bit; float32 within
rtol = atol = 1e-5 (events are spikes and weights grid-valued, so psums are
exact in any summation order).
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

# (B, N, M); B = None is unbatched (N,) state.  M = 257 and 130 leave a
# ragged last tile in the TPU kernel's 128-column grid.
SHAPES = [(1, 8, 8), (3, 17, 257), (2, 100, 130), (None, 24, 40)]


def _inputs(rng, b, n, m, quant, teach):
    bs = () if b is None else (b,)
    if quant:
        d = dict(x=rng.choice([0, 256], bs + (n,)).astype(np.int32),
                 w=rng.integers(-127, 128, (n, m)).astype(np.int8),
                 v=rng.integers(-600, 600, bs + (m,)).astype(np.int32),
                 tpre=rng.integers(0, 1200, bs + (n,)).astype(np.int32),
                 tpost=rng.integers(-300, 1200, bs + (m,)).astype(np.int32),
                 teach=rng.integers(-300, 300, bs + (m,)).astype(np.int32),
                 scale=np.float32(1 / 16))
    else:
        d = dict(x=(rng.random(bs + (n,)) < 0.4).astype(np.float32),
                 w=(np.round(rng.uniform(-1, 1, (n, m)) * 64) / 64
                    ).astype(np.float32),
                 v=rng.standard_normal(bs + (m,)).astype(np.float32),
                 tpre=(rng.random(bs + (n,)) * 3).astype(np.float32),
                 tpost=(rng.random(bs + (m,)) * 3).astype(np.float32),
                 teach=(rng.standard_normal(bs + (m,)) * 0.5
                        ).astype(np.float32),
                 scale=None)
    d["theta"] = (rng.standard_normal((4, n, m)) * 0.02).astype(np.float32)
    if not teach:
        d["teach"] = None
    return d


def _params(mod, quant, plastic, spiking):
    qc = (JQ.QuantConfig() if mod is JE else TQ.QuantConfig()) \
        if quant else None
    return mod.EngineParams(tau_m=2.0, trace_decay=0.75 if quant else 0.8,
                            plastic=plastic, spiking=spiking, quant=qc)


def _jax_step(d, quant, plastic, spiking, seed):
    params = _params(JE, quant, plastic, spiking)

    def f(w, v, tpre, tpost, theta, scale, x, teach):
        layer = JE.LayerState(w=w, v=v, trace_pre=tpre, trace_post=tpost,
                              theta=theta, w_scale=scale)
        layer, out = JE.layer_step(layer, x, params=params,
                                   impl="pallas-interpret", teach=teach,
                                   seed=seed if quant else None)
        return out, layer.w, layer.v, layer.trace_post
    return [np.asarray(a) for a in jax.jit(f)(
        d["w"], d["v"], d["tpre"], d["tpost"], d["theta"], d["scale"],
        d["x"], d["teach"])]


def _torch_step(d, quant, plastic, spiking, seed):
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in d.items()}
    layer = TE.LayerState(w=t["w"], v=t["v"], trace_pre=t["tpre"],
                          trace_post=t["tpost"], theta=t["theta"],
                          w_scale=t["scale"])
    layer, out = TE.layer_step(layer, t["x"],
                               params=_params(TE, quant, plastic, spiking),
                               teach=t["teach"],
                               seed=seed if quant else None)
    return [a.numpy() for a in (out, layer.w, layer.v, layer.trace_post)]


CASES = [(mode, shape, teach, plastic, spiking)
         for mode in ("float32", "int8") for shape in SHAPES
         for teach, plastic, spiking in ((False, True, True),
                                         (True, True, False),
                                         (True, False, True))]


@pytest.mark.parametrize("mode,shape,teach,plastic,spiking", CASES,
                         ids=[f"{c[0]}-{c[1]}-teach{int(c[2])}-"
                              f"plastic{int(c[3])}-spiking{int(c[4])}"
                              for c in CASES])
def test_shared_step_matches_jax(mode, shape, teach, plastic, spiking):
    quant = mode == "int8"
    rng = np.random.default_rng(sum(x or 0 for x in shape) + 7 * teach)
    d = _inputs(rng, *shape, quant, teach)
    seed = np.int32(2 ** 31 - 2)
    want = _jax_step(d, quant, plastic, spiking, seed)
    got = _torch_step(d, quant, plastic, spiking, seed)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        if quant:
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    if not plastic:
        np.testing.assert_array_equal(got[1], d["w"])


def test_shared_wrappers_take_the_plain_version_on_cpu():
    """On CPU tensors the wrappers ARE their plain versions and launch
    nothing."""
    rng = np.random.default_rng(3)
    d = _inputs(rng, 2, 9, 5, True, True)
    t = {k: None if v is None else torch.from_numpy(np.array(v))
         for k, v in d.items()}
    args = (t["x"], t["w"], t["scale"], t["theta"], t["v"], t["tpre"],
            t["tpost"])
    kw = dict(qcfg=TQ.QuantConfig(), teach=t["teach"], seed=5)
    launches = TK.shared_step_q.launches
    for a, b in zip(TK.shared_step_q(*args, **kw),
                    TK.shared_step_q_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert TK.shared_step_q.launches == launches
    with pytest.raises(ValueError):
        TK.shared_step_q(*(a.to("meta") for a in args), **kw)


# (B, N, M) of tests/test_engine.py:54, the bf16 shapes of the JAX kernel
BF16_SHAPES = [(1, 8, 8), (4, 32, 48), (2, 100, 130), (8, 128, 128),
               (3, 17, 257)]


@pytest.mark.parametrize("b,n,m", BF16_SHAPES)
@pytest.mark.parametrize("impl", ("xla", "pallas-interpret"))
def test_shared_step_bf16_matches_jax_bitwise(b, n, m, impl):
    """bfloat16 state, weights and rule (the inputs of tests/test_engine.py
    :_layer): the plain shared step equals jitted JAX bit for bit, on the
    oracle and on the TPU kernel #4 run by the Pallas interpreter."""
    import jax.numpy as jnp
    from repro_torch import convert
    rng = np.random.default_rng(b * 997 + n + m)
    d = dict(x=(rng.random((b, n)) < 0.5).astype(np.float32),
             w=rng.standard_normal((n, m)) * 0.1,
             v=rng.standard_normal((b, m)) * 0.1,
             tpre=rng.random((b, n)), tpost=rng.random((b, m)),
             theta=rng.standard_normal((4, n, m)) * 0.01)
    d = {k: np.asarray(jnp.asarray(v, jnp.bfloat16)) for k, v in d.items()}

    def f(w, v, tpre, tpost, theta, x):
        layer = JE.LayerState(w=w, v=v, trace_pre=tpre, trace_post=tpost,
                              theta=theta)
        layer, out = JE.layer_step(layer, x, params=JE.EngineParams(),
                                   impl=impl)
        return out, layer.w, layer.v, layer.trace_post
    want = jax.jit(f)(d["w"], d["v"], d["tpre"], d["tpost"], d["theta"],
                      d["x"])
    t = {k: convert.tensor(v, "cpu") for k, v in d.items()}
    layer = TE.LayerState(w=t["w"], v=t["v"], trace_pre=t["tpre"],
                          trace_post=t["tpost"], theta=t["theta"])
    layer, out = TE.layer_step(layer, t["x"], params=TE.EngineParams())
    for name, a, g in zip(("out", "w", "v", "trace_post"), want,
                          (out, layer.w, layer.v, layer.trace_post)):
        assert g.dtype == torch.bfloat16, name
        np.testing.assert_array_equal(g.float().numpy(),
                                      np.asarray(a, np.float32),
                                      err_msg=name)


# The shared-step kernels' launch on a 132-SM card with 227 KB a CTA:
# (B, N, M, dtype) -> (columns of a tile, weights of a piece, CTAs of a
# cluster, CTAs, threads, w's route, the rule's route, the rule held,
# input rows staged, shared memory).  At 784 -> 1024 a tile is one or two
# 16-byte pieces of w wide (8 columns in float, 128 CTAs of 512 threads),
# the rule resident in 7 TMA chunks; int8's 16-column tiles split the
# fan-in over a 2-CTA cluster.  The readout (M = 10, rows not in 16-byte
# pieces, its planes in whole ones) takes one tile of the whole row and
# cuts its fan-in across an 8-CTA cluster, each plane's block one bulk
# copy.  Rows of 130 or 257 elements go by cp.async pieces of the widest
# width that divides them; bf16 rows of 514 bytes take no copy engine: w
# by plain loads, the rule through L2.
STEP_PLANS = [
    ((1, 784, 1024, "float32"),
     (8, 4, 1, 128, 512, "tma", "tma",
      "resident", True, 136096)),
    ((8, 784, 1024, "float32"),
     (8, 4, 1, 128, 512, "tma", "tma",
      "resident", True, 180448)),
    ((1, 1024, 10, "float32"),
     (16, 1, 8, 8, 512, "bulk", "bulk",
      "resident", True, 35152)),
    ((8, 1024, 10, "float32"),
     (16, 1, 8, 8, 512, "bulk", "bulk",
      "resident", True, 43216)),
    ((3, 17, 257, "float32"),
     (4, 1, 2, 130, 128, "cp.async", "cp.async",
      "resident", True, 2432)),
    ((2, 100, 130, "float32"),
     (4, 1, 4, 132, 128, "cp.async", "cp.async",
      "resident", True, 3808)),
    ((1, 784, 1024, "bfloat16"),
     (8, 8, 1, 128, 512, "tma", "tma",
      "resident", True, 70240)),
    ((8, 784, 1024, "bfloat16"),
     (8, 8, 1, 128, 512, "tma", "tma",
      "resident", True, 92640)),
    ((1, 1024, 10, "bfloat16"),
     (16, 1, 8, 8, 512, "bulk", "bulk",
      "resident", True, 21840)),
    ((8, 1024, 10, "bfloat16"),
     (16, 1, 8, 8, 512, "bulk", "bulk",
      "resident", True, 26320)),
    ((3, 17, 257, "bfloat16"),
     (8, 1, 3, 99, 128, "l2", "l2",
      "l2", True, 1616)),
    ((2, 100, 130, "bfloat16"),
     (8, 1, 7, 119, 128, "cp.async", "cp.async",
      "resident", True, 2736)),
    ((1, 784, 1024, "int8"),
     (16, 16, 2, 128, 512, "tma", "tma",
      "resident", True, 124848)),
    ((8, 784, 1024, "int8"),
     (16, 16, 2, 128, 512, "tma", "tma",
      "resident", True, 147696)),
    ((1, 1024, 10, "int8"),
     (16, 1, 8, 8, 512, "bulk", "bulk",
      "resident", True, 31312)),
    ((8, 1024, 10, "int8"),
     (16, 1, 8, 8, 512, "bulk", "bulk",
      "resident", True, 39376)),
    ((3, 17, 257, "int8"),
     (16, 1, 3, 51, 128, "l2", "cp.async",
      "resident", True, 5008)),
    ((2, 100, 130, "int8"),
     (16, 1, 7, 63, 128, "l2", "cp.async",
      "resident", True, 7120)),
]


@pytest.mark.parametrize("case,want", STEP_PLANS,
                         ids=["-".join(map(str, c)) for c, _ in STEP_PLANS])
def test_shared_step_plan_pins_the_launch(case, want):
    b, n, m, dtype = case
    plan = TK.shared_step_plan(b, n, m, True, dtype, sms=132,
                               theta_bf16=dtype == "bfloat16", occupancy=1)
    assert (plan["cols"], plan["vec"], plan["split"], plan["ctas"],
            plan["threads"], plan["w"][0], plan["theta"][0], plan["rule"],
            plan["stage_x"], plan["smem"]) == want
    # the grid: tiles of the columns times the fan-in's shares, each share
    # a multiple of 8 rows (16 for a bulk copy) and the last one what is
    # left
    assert plan["tiles"] == -(-m // plan["cols"])
    assert plan["ctas"] == plan["tiles"] * plan["split"] <= 132
    assert plan["rows"] % (16 if "bulk" in (plan["w"][0], plan["theta"][0])
                           else 8) == 0
    assert (plan["split"] - 1) * plan["rows"] < n <= plan["split"] \
        * plan["rows"]
    assert plan["cols"] % plan["vec"] == 0 \
        and plan["cols"] // plan["vec"] <= 32
    assert plan["chunks"] == -(-plan["rows"] // plan["chunk_rows"])
    assert plan["stages"] == (plan["chunks"] if plan["rule"] == "resident"
                              else 0)
    assert plan["smem"] == sum(plan["role_smem"].values()) + 128 \
        <= TK.DEFAULT_SMEM_LIMIT
    assert plan["ctas_per_sm"] == 1


def test_shared_step_plan_rings_refusals_and_routes():
    """A rule too large for shared memory streams through a ring of chunks
    (the w slab stays resident); a frozen layer keeps no rule; w that does
    not fit even split over the largest cluster raises rather than falling
    back; so do a dtype with no kernel and a bf16 rule beside float32."""
    plan = TK.shared_step_plan(1, 4096, 1024, True, "float32", sms=132)
    assert (plan["rule"], plan["stages"], plan["chunks"]) == ("ring", 5, 32)
    assert plan["smem"] <= TK.DEFAULT_SMEM_LIMIT
    plan = TK.shared_step_plan(1, 784, 1024, False, "float32", sms=132)
    assert (plan["rule"], plan["theta"], plan["stages"]) == (
        "none", ("none", 0), 0)
    assert plan["smem"] == 136096 - 100352 - 48       # no rule, 1 mbarrier
    with pytest.raises(ValueError, match="shared memory"):
        TK.shared_step_plan(1, 200_000, 1024, True, "float32", sms=132)
    with pytest.raises(ValueError):
        TK.shared_step_plan(1, 8, 8, True, "float16", sms=132)
    with pytest.raises(ValueError):
        TK.shared_step_plan(1, 8, 8, True, "float32", sms=132,
                            theta_bf16=True)
    # the routes: 16-byte rows by TMA, one contiguous block by bulk copy,
    # else the widest cp.async piece, else no copy engine
    assert TK.step_route(784, 1024, 8, 4, 128) == ("tma", 16)
    assert TK.step_route(1024, 10, 16, 1, 1) == ("bulk", 16)
    assert TK.step_route(1024, 10, 4, 4, 3) == ("cp.async", 8)
    assert TK.step_route(1024, 10, 8, 2, 2) == ("cp.async", 4)
    assert TK.step_route(17, 257, 8, 2, 33) == ("l2", 0)


class _Ops(torch.utils._python_dispatch.TorchDispatchMode):
    """Every ATen op a block of code runs."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


class _Entry:
    """A kernel entry point that records its argument struct."""

    def __init__(self):
        self.calls = []

    def __call__(self, args, stream):
        self.calls.append(args._obj)
        return 0


@pytest.mark.parametrize("scale,seed", [
    (0.03125, 7), (torch.tensor(0.03125), torch.tensor(7, dtype=torch.int32))],
    ids=["numbers", "0-d tensors"])
def test_shared_step_scalars_and_teach_need_no_device_op(monkeypatch, scale,
                                                         seed):
    """A number or 0-d scale and seed travel by value or pointer in the
    argument struct and a contiguous (B, M) teach of the kernel's type is
    read as it is: the wrapper runs no op beside the kernel but the
    outputs' allocation.  A (M,) teach is converted."""
    rng = np.random.default_rng(9)
    d = _inputs(rng, 2, 24, 40, True, True)
    t = {k: torch.from_numpy(np.array(v)) for k, v in d.items()
         if v is not None}
    plan = TK.shared_step_plan(2, 24, 40, True, "int8", sms=132)
    entry = _Entry()
    monkeypatch.setattr(TK, "shared_step_launch", lambda *a, **k: plan)
    monkeypatch.setattr(TK._build, "library",
                        lambda src: type("Lib", (), {"shared_step_q": entry}))
    monkeypatch.setattr(TK, "stream_of", lambda t: 0)
    kw = dict(state_dt=torch.int32, plastic=True, spiking=True, w_clip=4.0,
              scale=scale, seed=seed, teach=t["teach"],
              q=TK.q_params(TQ.QuantConfig(), 1.0, 0.0, batch=2))
    args = (t["x"], t["w"], t["theta"], t["v"], t["tpre"], t["tpost"])
    with _Ops() as seen:
        TK._launch_shared("shared_step_q", *args, **kw)
    # a number is held to the plain version's type on the host, through a
    # tensor that never leaves the CPU (torch.as_tensor(val, dtype).item())
    host = {"aten.lift_fresh", "aten._local_scalar_dense"} \
        if not torch.is_tensor(scale) else set()
    assert set(seen.ops) <= {"aten.empty", "aten.empty_like"} | host, \
        seen.ops
    a = entry.calls[-1]
    assert a.teach == t["teach"].data_ptr()
    if torch.is_tensor(scale):
        assert (a.scale, a.seed) == (scale.data_ptr(), seed.data_ptr())
    else:
        assert (a.scale, a.seed, a.scale_val, a.seed_val) == (
            None, None, 0.03125, 7)
    assert (a.cols, a.split, a.smem) == (plan["cols"], plan["split"],
                                         plan["smem"])
    kw["teach"] = t["teach"][0]                   # (M,): expanded
    with _Ops() as seen:
        TK._launch_shared("shared_step_q", *args, **kw)
    assert "aten.expand" in seen.ops
    assert TK.teach_operand(t["teach"], 2, 40, torch.int32,
                            torch.device("cpu")) is t["teach"]
