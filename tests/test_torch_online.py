"""Online learning in the port against the JAX reference: `classify_window`,
`quantize_state`, the rate-encoding contract, the rule and compression
helpers, and the slice as a whole — the predict-then-learn protocol of
``benchmarks/mnist_throughput.py`` (Table II) on a narrowed network.

The JAX side runs under ``jax.jit`` with ``impl="pallas-interpret"`` (the
shared-mode rollout kernel run by the Pallas interpreter); the port runs on
CPU tensors (the kernels' plain versions).  int8 is held bit for bit;
float32 within rtol = atol = 1e-5 where a window's psums are exact.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plasticity as JP
from repro.core import snn as JS
from repro.data import mnist as JM
from repro.optim import compression as JC
from repro_torch import convert
from repro_torch.core import plasticity as TP
from repro_torch.core import snn as TS
from repro_torch.optim import compression as TC

SIZES = (784, 32, 10)
# the hand-set rule of mnist_throughput.online_accuracy: (a, b, g, d)
COEFFS = ((0.010, 0.004, -0.0030, -0.0010), (0.050, -0.002, -0.0050, -0.0005))


def _cfgs(quant, impl="pallas-interpret"):
    kw = dict(layer_sizes=SIZES, timesteps=4, trace_decay=0.8,
              spiking_readout=True, plastic=True, w_clip=1.0)
    jc = JS.SNNConfig(impl=impl, **kw)
    tc = TS.SNNConfig(**kw)
    if quant:
        jc, tc = JS.quant_config(jc), TS.quant_config(tc)
    return jc, tc


def _rule():
    th = []
    for i, c in enumerate(COEFFS):
        shp = (SIZES[i], SIZES[i + 1])
        th.append(np.stack([np.full(shp, v, np.float32) for v in c]))
    return th


def _stream(n):
    imgs, labels = JM.mnist_batch(jax.random.PRNGKey(0), n)
    return np.array(imgs).reshape(n, -1), np.array(labels)


def _jax_protocol(jc, theta, imgs, labels):
    theta = [jnp.asarray(t) for t in theta]

    @jax.jit
    def step(state, x, label):
        _, scores = JS.classify_window(jc, state, theta, x)
        teach = 2.0 * jax.nn.one_hot(label, SIZES[-1])
        state, _ = JS.classify_window(jc, state, theta, x, teach=teach)
        return state, scores
    state = JS.init_state(jc)
    preds, states, scores = [], [], []
    for x, label in zip(imgs, labels):
        state, s = step(state, x, label)
        preds.append(int(jnp.argmax(s)))
        scores.append(np.asarray(s))
        states.append(state)
    return preds, states, scores


def _torch_protocol(tc, theta, imgs, labels):
    theta = [torch.from_numpy(t) for t in theta]
    state = TS.init_state(tc, device="cpu")
    preds, states, scores = [], [], []
    for x, label in zip(imgs, labels):
        x = torch.from_numpy(x)
        _, s = TS.classify_window(tc, state, theta, x)
        teach = 2.0 * torch.nn.functional.one_hot(
            torch.tensor(int(label)), SIZES[-1]).float()
        state, _ = TS.classify_window(tc, state, theta, x, teach=teach)
        preds.append(int(torch.argmax(s)))
        scores.append(s.numpy())
        states.append(state)
    return preds, states, scores


def _leaves(state):
    return [np.asarray(a) for a in (*state.w, *state.v, *state.trace)]


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_online_stream_matches_jax(mode):
    """The slice as a whole: 6 digits of predict-then-learn at 784-32-10,
    T = 4, from zero weights."""
    quant = mode == "int8"
    jc, tc = _cfgs(quant)
    imgs, labels = _stream(6)
    theta = _rule()
    jp, js, jsc = _jax_protocol(jc, theta, imgs, labels)
    tp, ts, tsc = _torch_protocol(tc, theta, imgs, labels)
    if quant:
        assert jp == tp
        for a, b in zip(js, ts):
            for x, y in zip(_leaves(a), _leaves(b)):
                np.testing.assert_array_equal(x, y)
        assert np.abs(_leaves(ts[-1])[0]).max() > 0     # the rule learned
    else:
        assert jp[:2] == tp[:2]
        np.testing.assert_allclose(tsc[0], jsc[0], rtol=1e-5, atol=1e-5)
        for x, y in zip(_leaves(js[0]), _leaves(ts[0])):
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ("float32", "int8"))
def test_classify_window_matches_jax(mode):
    """One window on a random state, batched B = 3, with a teaching
    current (grid-valued weights and images: exact psums)."""
    quant = mode == "int8"
    jc, tc = _cfgs(quant)
    rng = np.random.default_rng(4)
    b = 3
    w = [np.round(rng.uniform(-0.5, 0.5, (SIZES[i], SIZES[i + 1])) * 32) / 32
         for i in range(2)]
    fstate = types.SimpleNamespace(
        w=tuple(a.astype(np.float32) for a in w),
        v=tuple(rng.uniform(0, 0.9, (b, m)).astype(np.float32)
                for m in SIZES[1:]),
        trace=tuple(np.round(rng.uniform(0, 2, (b, n)) * 16)
                    .astype(np.float32) / 16 for n in SIZES),
        t=np.int32(2 ** 31 - 2), w_scale=())
    x = (np.round(rng.uniform(0, 1, (b, SIZES[0])) * 8) / 8
         ).astype(np.float32)
    teach = (2.0 * np.eye(SIZES[-1], dtype=np.float32)[[1, 4, 7]])
    theta = [(rng.standard_normal((4, SIZES[i], SIZES[i + 1])) * 0.01
              ).astype(np.float32) for i in range(2)]
    jstate = JS.NetworkState(*(jax.tree.map(jnp.asarray, getattr(fstate, f))
                               for f in ("w", "v", "trace", "t", "w_scale")))
    tstate = convert.network_state(fstate, device="cpu")
    if quant:
        jstate, tstate = JS.quantize_state(jc, jstate), \
            TS.quantize_state(tc, tstate)
    jst, jscores = jax.jit(lambda s, th, x, te: JS.classify_window(
        jc, s, th, x, teach=te))(jstate, theta, x, teach)
    tst, tscores = TS.classify_window(
        tc, tstate, convert.theta(theta, "cpu"), torch.from_numpy(x),
        teach=torch.from_numpy(teach))
    assert int(tst.t) == int(jst.t)
    for a, c in zip(_leaves(jst) + [np.asarray(jscores)],
                    _leaves(tst) + [tscores.numpy()]):
        assert a.shape == c.shape and a.dtype == c.dtype
        if quant:
            np.testing.assert_array_equal(a, c)
        else:
            np.testing.assert_allclose(c, a, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fleet", (False, True))
def test_quantize_state_matches_jax(fleet):
    rng = np.random.default_rng(9)
    b = 4
    lead = (b,) if fleet else ()
    fstate = types.SimpleNamespace(
        w=tuple(rng.uniform(-5, 5, lead + (SIZES[i], SIZES[i + 1]))
                .astype(np.float32) for i in range(2)),
        v=tuple(rng.uniform(-2, 2, (b, m)).astype(np.float32)
                for m in SIZES[1:]),
        trace=tuple(rng.uniform(0, 5, (b, n)).astype(np.float32)
                    for n in SIZES),
        t=np.int32(17), w_scale=())
    jc, tc = _cfgs(True)
    jq = JS.quantize_state(jc, JS.NetworkState(
        *(jax.tree.map(jnp.asarray, getattr(fstate, f))
          for f in ("w", "v", "trace", "t", "w_scale"))))
    tq = TS.quantize_state(tc, convert.network_state(fstate, device="cpu"))
    for a, c in zip([*jq.w, *jq.v, *jq.trace, *jq.w_scale],
                    [*tq.w, *tq.v, *tq.trace, *tq.w_scale]):
        a = np.asarray(a)
        assert a.shape == tuple(c.shape) and a.dtype == c.numpy().dtype
        np.testing.assert_array_equal(a, c.numpy())
    with pytest.raises(ValueError, match="cfg.quant"):
        TS.quantize_state(_cfgs(False)[1], tq)


def test_rate_encoding_needs_a_generator():
    tc = dataclasses.replace(_cfgs(False)[1], encoding="rate")
    st = TS.init_state(tc, device="cpu")
    th = [torch.from_numpy(t) for t in _rule()]
    obs = torch.linspace(-1, 1, SIZES[0])
    for call in (lambda: TS.encode(tc, obs),
                 lambda: TS.encode_window(tc, obs),
                 lambda: TS.classify_window(tc, st, th, obs),
                 lambda: TS.controller_step(tc, st, th, obs)):
        with pytest.raises(ValueError, match="torch.Generator"):
            call()
    gen = torch.Generator().manual_seed(0)
    x = TS.encode(tc, obs, gen)
    assert set(x.unique().tolist()) <= {-1.0, 0.0, 1.0}
    assert (x * obs >= 0).all()                      # spikes carry the sign
    # a window draws what K successive encode calls draw
    win = TS.encode_window(tc, obs, torch.Generator().manual_seed(1), k=3)
    g = torch.Generator().manual_seed(1)
    assert torch.equal(win, torch.stack([TS.encode(tc, obs, g)
                                         for _ in range(3)]))
    st2, scores = TS.classify_window(tc, st, th, obs,
                                     torch.Generator().manual_seed(2))
    assert scores.shape == (SIZES[-1],) and int(st2.t) == tc.timesteps
    # current encoding needs none
    assert torch.equal(TS.encode(_cfgs(False)[1], obs), obs)


@pytest.mark.parametrize("batched", (False, True))
def test_apply_plasticity_matches_jax(batched):
    rng = np.random.default_rng(12)
    n, m = 30, 20
    bs = (5,) if batched else ()
    w = rng.uniform(-1, 1, (n, m)).astype(np.float32)
    th = (rng.standard_normal((4, n, m)) * 0.3).astype(np.float32)
    pre = rng.uniform(0, 3, bs + (n,)).astype(np.float32)
    post = rng.uniform(0, 3, bs + (m,)).astype(np.float32)
    jcfg = JP.PlasticityConfig(n_pre=n, n_post=m, w_clip=0.9)
    tcfg = TP.PlasticityConfig(n_pre=n, n_post=m, w_clip=0.9)
    want = jax.jit(lambda *a: (JP.delta_w(*a[1:]),
                               JP.apply_plasticity(*a, jcfg)))(
        w, th, pre, post)
    t = [torch.from_numpy(a) for a in (w, th, pre, post)]
    got = (TP.delta_w(*t[1:]), TP.apply_plasticity(*t, tcfg))
    for a, c in zip(want, got):
        np.testing.assert_allclose(c.numpy(), np.asarray(a), rtol=1e-5,
                                   atol=1e-6)
    assert float(got[1].abs().max()) <= 0.9


@pytest.mark.parametrize("scale", (None, 2.0 ** -5))
def test_compress_int8_matches_jax(scale):
    x = np.random.default_rng(2).uniform(-6, 6, (40, 30)).astype(np.float32)
    qj, sj = jax.jit(lambda a: JC.compress_int8(a, scale=scale))(x)
    qt, st = TC.compress_int8(torch.from_numpy(x), scale=scale)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj) and st.dtype == torch.float32
    np.testing.assert_array_equal(TC.decompress_int8(qt, st).numpy(),
                                  np.asarray(JC.decompress_int8(qj, sj)))
