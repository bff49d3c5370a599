"""The port's attention (`kernels.attention.attention`) against the JAX
reference.

On CPU tensors the wrapper takes its plain version (`ref.mha`, float32
math).  The JAX side runs the TPU kernel `flash_attention_pallas` in the
Pallas interpreter and the plain ``impl="xla"`` oracle, both under
``jax.jit``, on the same numpy-seeded inputs.  float32 within
rtol = atol = 1e-5; bfloat16 within rtol 2e-2, atol 2e-3 (the JAX
package's own bound for its kernel, ``tests/test_kernels.py``).  A row
with no visible key is exactly 0, as in the Pallas kernel; the ``xla``
oracle spreads such a row over V, so it is held only on the other rows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import attention as j_attention
from repro_torch import convert
from repro_torch.kernels.attention import attention, ref
from repro_torch.kernels.attention import kernel as TK

# (B, Sq, Skv, H, HKV, D, causal, kv_len)
CASES = {
    "gqa-ragged": (2, 200, 200, 4, 2, 64, True, None),
    "q-offset": (1, 5, 150, 4, 2, 32, True, None),
    "kv-len": (2, 130, 130, 4, 1, 64, True, 100),
    "kv-len-acausal": (1, 37, 161, 4, 2, 32, False, 90),
    "masked-rows": (1, 40, 30, 4, 2, 32, True, None),   # Sq > Skv
}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}


@functools.lru_cache(maxsize=None)
def _jax_attention(impl, causal, kv_len):
    return jax.jit(functools.partial(
        j_attention, causal=causal, kv_len=kv_len, impl=impl,
        interpret=impl == "pallas"))


def _inputs(case, dtype):
    b, sq, skv, h, hkv, d, _, _ = CASES[case]
    rng = np.random.default_rng(sq * 1000 + skv)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    arrays = [jnp.asarray(rng.standard_normal(s), jdt)
              for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]
    return arrays, [convert.tensor(np.asarray(a), "cpu") for a in arrays]


def _visible_rows(case):
    _, sq, skv, _, _, _, causal, kv_len = CASES[case]
    return ref.mask(sq, skv, causal=causal, kv_len=kv_len,
                    device="cpu").any(-1).numpy()


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("case", sorted(CASES))
def test_attention_matches_jax(case, dtype):
    *_, causal, kv_len = CASES[case]
    jargs, targs = _inputs(case, dtype)
    launches = TK.flash_attention.launches
    got = attention(*targs, causal=causal, kv_len=kv_len)
    assert TK.flash_attention.launches == launches        # CPU: no launch
    assert got.dtype == targs[0].dtype and got.shape == targs[0].shape
    got = got.float().numpy()
    pallas = np.asarray(_jax_attention("pallas", causal, kv_len)(*jargs),
                        np.float32)
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    rows = _visible_rows(case)
    xla = np.asarray(_jax_attention("xla", causal, kv_len)(*jargs),
                     np.float32)
    np.testing.assert_allclose(got[:, rows], xla[:, rows], **TOL[dtype])
    # no visible key: exactly zero, as the kernel gives
    assert (got[:, ~rows] == 0).all()


def test_masked_rows_case_has_rows_without_keys():
    assert not _visible_rows("masked-rows").all()
    assert _visible_rows("masked-rows").any()


def test_scale_and_layout_follow_the_reference():
    """An explicit ``scale`` and inputs read through strides (q, k, v cut
    from one packed projection) give the contiguous inputs' result."""
    rng = np.random.default_rng(3)
    b, s, h, hkv, d = 2, 24, 4, 2, 32
    packed = torch.from_numpy(
        rng.standard_normal((b, s, h + 2 * hkv, d)).astype(np.float32))
    q, k, v = packed[:, :, :h], packed[:, :, h:h + hkv], packed[:, :, h + hkv:]
    assert not q.is_contiguous()
    got = attention(q, k, v, scale=0.1)
    want = _jax_attention("xla", True, None)(
        jnp.asarray(q.contiguous().numpy()) * (0.1 * d ** 0.5),
        jnp.asarray(k.contiguous().numpy()),
        jnp.asarray(v.contiguous().numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
