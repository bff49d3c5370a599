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

The card's bf16 kernel multiplies P V on the tensor cores, which take P in
bf16.  `_emulate` repeats its arithmetic in torch (128-key blocks, online
softmax in log2 units, P split into bf16 P_hi + P_lo, float32 sums) and is
held against both JAX references at the same bf16 tolerance, with V at
unit and at 8x scale; a single bf16 P leaves that tolerance at 8x scale,
which is why the kernel splits P.
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
    # the head widths of the repo's configs beside 64 and 128: the smoke
    # configs' 16, 24 (qwen1.5-32b's 5 heads) and 32, and zamba2-7b's 112
    "d16-gqa": (2, 70, 70, 4, 2, 16, True, None),
    "d24": (1, 50, 50, 5, 5, 24, True, None),
    "d32-gqa4": (2, 90, 90, 8, 2, 32, True, None),
    "d112": (1, 130, 130, 4, 4, 112, True, None),
    "d112-decode": (2, 1, 45, 4, 4, 112, True, None),
}
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-3)}
# the kernel's head width at GQA 4:1, for the split-P emulation
SPLIT_CASES = {"d128-gqa4": (2, 300, 300, 8, 2, 128, True, None)}


@functools.lru_cache(maxsize=None)
def _jax_attention(impl, causal, kv_len):
    return jax.jit(functools.partial(
        j_attention, causal=causal, kv_len=kv_len, impl=impl,
        interpret=impl == "pallas"))


def _inputs(case, dtype, v_scale=1.0):
    b, sq, skv, h, hkv, d, _, _ = {**CASES, **SPLIT_CASES}[case]
    rng = np.random.default_rng(sq * 1000 + skv)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    arrays = [jnp.asarray(rng.standard_normal(s) * scale, jdt)
              for s, scale in (((b, sq, h, d), 1.0), ((b, skv, hkv, d), 1.0),
                               ((b, skv, hkv, d), v_scale))]
    return arrays, [convert.tensor(np.asarray(a), "cpu") for a in arrays]


def _visible_rows(case):
    _, sq, skv, _, _, _, causal, kv_len = {**CASES, **SPLIT_CASES}[case]
    return ref.mask(sq, skv, causal=causal, kv_len=kv_len,
                    device="cpu").any(-1).numpy()


def _emulate(q, k, v, *, causal, kv_len, split=True, block=128):
    """The bf16 kernel's arithmetic in torch: per 128-key block, scores in
    float32 scaled by scale * log2(e), masked to -inf, an online max and
    row sum of the unrounded P (exp2), O rescaled and then given
    bf16(P) V and, if ``split``, bf16(P - bf16(P)) V, both in float32;
    O / l rounded once to bf16 (0 where l = 0)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    c = torch.tensor(d ** -0.5, dtype=torch.float32) * np.float32(np.log2(
        np.e))
    qg = q.float().reshape(b, sq, hkv, g, d)
    vis = ref.mask(sq, skv, causal=causal, kv_len=kv_len, device="cpu")
    m = torch.full((b, hkv, g, sq), -1e30)
    l = torch.zeros((b, hkv, g, sq))
    o = torch.zeros((b, hkv, g, sq, d))
    for k0 in range(0, skv, block):
        kb, vb = k[:, k0:k0 + block].float(), v[:, k0:k0 + block].float()
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kb) * c
        s = torch.where(vis[:, k0:k0 + block], s, -torch.inf)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        o = o * alpha[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", hi, vb)
        if split:
            lo = (p - hi).bfloat16().float()
            o = o + torch.einsum("bhgqk,bkhd->bhgqd", lo, vb)
        m = m_new
    o = o / torch.where(l == 0, torch.ones_like(l), l)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).bfloat16()


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


SPLIT_P = [(case, 1.0) for case in sorted(CASES)] + [
    ("d128-gqa4", 1.0), ("d128-gqa4", 8.0)]


@pytest.mark.parametrize("case,v_scale", SPLIT_P)
def test_split_p_emulation_matches_jax(case, v_scale):
    """The bf16 kernel's split-P arithmetic against the Pallas kernel and
    the ``xla`` oracle within the bf16 tolerance, V at unit and 8x scale."""
    *_, causal, kv_len = {**CASES, **SPLIT_CASES}[case]
    jargs, targs = _inputs(case, "bfloat16", v_scale)
    got = _emulate(*targs, causal=causal, kv_len=kv_len).float().numpy()
    pallas = np.asarray(_jax_attention("pallas", causal, kv_len)(*jargs),
                        np.float32)
    np.testing.assert_allclose(got, pallas, **TOL["bfloat16"])
    rows = _visible_rows(case)
    xla = np.asarray(_jax_attention("xla", causal, kv_len)(*jargs),
                     np.float32)
    np.testing.assert_allclose(got[:, rows], xla[:, rows], **TOL["bfloat16"])
    assert (got[:, ~rows] == 0).all()


def test_single_bf16_p_leaves_the_tolerance_at_8x_scale():
    """Why the kernel splits P: with P rounded once to bf16 before P V, V at
    8x scale puts elements outside the bf16 tolerance of the Pallas
    kernel; the split P (above) keeps them all inside."""
    *_, causal, kv_len = SPLIT_CASES["d128-gqa4"]
    jargs, targs = _inputs("d128-gqa4", "bfloat16", 8.0)
    pallas = np.asarray(_jax_attention("pallas", causal, kv_len)(*jargs),
                        np.float32)
    single = _emulate(*targs, causal=causal, kv_len=kv_len,
                      split=False).float().numpy()
    outside = ~np.isclose(single, pallas, **TOL["bfloat16"])
    assert outside.mean() > 1e-4, outside.mean()
