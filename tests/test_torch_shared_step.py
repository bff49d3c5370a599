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
