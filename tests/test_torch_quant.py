"""Fixed-point helpers of the PyTorch port, bitwise against the JAX reference.

The JAX side always runs under ``jax.jit``: XLA contracts the dw sum into
fused multiply-adds there, and the port reproduces the compiled form."""
import jax
import numpy as np
import pytest
import torch

from repro.kernels.plasticity import quant as JQ
from repro_torch.kernels.plasticity import quant as TQ

QC_J, QC_T = JQ.QuantConfig(), TQ.QuantConfig()


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _same(a, b):
    a, b = _np(a), _np(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def _t(x):
    return torch.from_numpy(np.array(x))


def test_to_fixed_and_back_round_half_even():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(4096) * 3,
        (np.arange(-64, 64) + 0.5) / QC_J.one,       # exact ties
    ]).astype(np.float32)
    q = jax.jit(lambda a: JQ.to_fixed(a, QC_J))(x)
    _same(q, TQ.to_fixed(_t(x), QC_T))
    _same(jax.jit(lambda a: JQ.from_fixed(a, QC_J))(q),
          TQ.from_fixed(_t(q), QC_T))


@pytest.mark.parametrize("spiking", (True, False))
def test_neuron_and_trace_update(spiking):
    rng = np.random.default_rng(1)
    v = rng.integers(-5000, 5000, 8192).astype(np.int32)
    i = rng.integers(-5000, 5000, 8192).astype(np.int32)
    ev_j, vo_j = jax.jit(lambda a, b: JQ.neuron_update_q(
        a, b, QC_J, 1.0, 0.0, spiking))(v, i)
    ev_t, vo_t = TQ.neuron_update_q(_t(v), _t(i), QC_T, 1.0, 0.0, spiking)
    _same(ev_j, ev_t)
    _same(vo_j, vo_t)
    tp = rng.integers(-4000, 4000, 8192).astype(np.int32)  # negative: >> is
    _same(jax.jit(lambda a, b: JQ.trace_update_q(a, b, QC_J))(tp, ev_j),
          TQ.trace_update_q(_t(tp), ev_t, QC_T))            # arithmetic


def test_current_fx():
    rng = np.random.default_rng(2)
    acc = rng.integers(-2 ** 24, 2 ** 24, 8192).astype(np.int32)
    scale = rng.choice([1 / 32, 1 / 16, 0.0371], 8192).astype(np.float32)
    _same(jax.jit(lambda a, s: JQ.current_fx(a, s, QC_J))(acc, scale),
          TQ.current_fx(_t(acc), _t(scale), QC_T))


def test_dw_contracted_form_128x128():
    """The fp32 dw from integer reductions, bit for bit on 128 x 128 (the
    form XLA compiles; plain IEEE evaluation differs on ~a quarter)."""
    rng = np.random.default_rng(3)
    hebb = (rng.integers(-3000, 3000, (128, 128)) * 37).astype(np.int32)
    pre = rng.integers(-3000, 3000, 128).astype(np.int32)
    post = rng.integers(-3000, 3000, 128).astype(np.int32)
    th = (rng.standard_normal((4, 128, 128)) * 0.01).astype(np.float32)
    want = jax.jit(lambda h, p, q, t: JQ.dw_from_int_reductions(
        h, p, q, t, 1, QC_J))(hebb, pre, post, th)
    got = TQ.dw_from_int_reductions(_t(hebb), _t(pre), _t(post), _t(th), 1,
                                    QC_T)
    _same(want, got)


def test_uniform_hash_full_uint32_range_and_negative_seeds():
    rng = np.random.default_rng(4)
    idx = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31, 16384),        # all of uint32
        [0, 1, -1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    f = jax.jit(JQ.uniform_hash)
    for seed in (0, 7, -1, -2 ** 31, 2 ** 31 - 1, 123456789, -987654321):
        _same(f(np.int32(seed), idx),
              TQ.uniform_hash(torch.tensor(seed, dtype=torch.int32), _t(idx)))


@pytest.mark.parametrize("stoch", (True, False))
def test_round_steps(stoch):
    rng = np.random.default_rng(5)
    steps = (rng.standard_normal(8192) * 4).astype(np.float32)
    seeds = rng.integers(-2 ** 31, 2 ** 31, 8192).astype(np.int32)
    idx = rng.integers(0, 2 ** 20, 8192).astype(np.int32)
    qj, qt = (JQ.QuantConfig(stoch_round=stoch),
              TQ.QuantConfig(stoch_round=stoch))
    _same(jax.jit(lambda s, a, b: JQ.round_steps(s, a, b, qj))(
        steps, seeds, idx), TQ.round_steps(_t(steps), _t(seeds), _t(idx), qt))


@pytest.mark.parametrize("w_clip", (4.0, 3.0, 0.7))
def test_qclip(w_clip):
    scale = np.array([1 / 32, 1 / 16, 0.03, 1e-3, 0.5], np.float32)
    _same(jax.jit(lambda s: JQ.qclip(w_clip, s))(scale),
          TQ.qclip(w_clip, _t(scale)))


def test_fold_seed_past_int32_wrap():
    """seed * 1000003 overflows int32 from t ~ 2148 on; both wrap."""
    seeds = np.concatenate([np.arange(0, 40), np.arange(2140, 2160),
                            [5000, 10 ** 6, 2 ** 31 - 1, -1, -2 ** 31]
                            ]).astype(np.int32)
    f = jax.jit(JQ.fold_seed, static_argnums=1)
    for layer in (0, 1, 3):
        _same(f(seeds, layer), TQ.fold_seed(_t(seeds), layer))
    assert int(TQ.fold_seed(torch.tensor(5000, dtype=torch.int32), 1)) \
        == int(f(np.int32(5000), 1)) == 705047705
