"""Plain PyTorch attention: the plain versions of ``csrc/flash_attention.cu``
(`mha`, and `mha_lse` with the row log-sum-exp a backward needs) and of
``csrc/flash_attention_bwd.cu`` (`mha_bwd`).

Layouts: q (B, Sq, H, D); k/v (B, Skv, HKV, D); HKV divides H, and query
head h reads KV head ``h // (H / HKV)``.  Scores, softmax and the PV
product run in float32; the output is cast to q's dtype.

It computes what the Pallas kernel computes (``repro``'s
``kernels/attention/kernel.py``): masked scores are -1e30, the
probabilities are multiplied by the mask, and a row with no visible key
gives exactly 0.  (``repro``'s plain ``ref.mha`` spreads such a row
uniformly over V instead; on every row with a visible key the two agree.)
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def mask(sq: int, skv: int, *, causal: bool, kv_len: Optional[int],
         device) -> torch.Tensor:
    """(Sq, Skv) bool: key j is visible to query i.  Queries are the LAST
    Sq positions of the key sequence (``q_offset = Skv - Sq``)."""
    ki = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        qi = torch.arange(sq, device=device)[:, None] + (skv - sq)
        m = m & (ki <= qi)
    if kv_len is not None:
        m = m & (ki < kv_len)
    return m


def _scores(q, k, causal, scale, kv_len):
    """Grouped scaled scores (B, HKV, G, Sq, Skv) in float32 with masked
    entries at NEG_INF, the mask, and the scale."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    vis = mask(sq, skv, causal=causal, kv_len=kv_len, device=q.device)
    return torch.where(vis, s, torch.full_like(s, NEG_INF)), vis, scale


def mha_lse(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
            kv_len: Optional[int] = None):
    """`mha` and the float32 row log-sum-exp of the scaled scores over the
    visible keys, lse (B, H, Sq): max + log(sum exp(s - max)), +inf for a
    row with no visible key."""
    b, sq, h, d = q.shape
    s, vis, _ = _scores(q, k, causal, scale, kv_len)
    mx = s.amax(-1, keepdim=True)
    p = torch.exp(s - mx) * vis
    den = p.sum(-1, keepdim=True)
    lse = torch.where(den > 0, mx + torch.log(den),
                      torch.full_like(den, float("inf")))
    p = p / torch.where(den == 0, torch.ones_like(den), den)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return (out.reshape(b, sq, h, d).to(q.dtype),
            lse.reshape(b, h, sq))


def mha(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
        kv_len: Optional[int] = None):
    return mha_lse(q, k, v, causal=causal, scale=scale, kv_len=kv_len)[0]


def mha_bwd(q, k, v, o, lse, do, *, causal: bool = True,
            scale: Optional[float] = None, kv_len: Optional[int] = None):
    """The gradient of `mha` at (q, k, v) for the output gradient ``do``,
    from the forward's output ``o`` and row log-sum-exp ``lse`` (B, H, Sq):
    P = exp(s - lse) on the visible keys, delta = rowsum(do * o),
    dS = P (do v^T - delta), dq = scale dS k, dk = scale dS^T q,
    dv = P^T do, in float32; each KV head's dk and dv sum over its
    group's query heads.  Returns (dq, dk, dv) in the inputs' dtypes."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    g = h // hkv
    s, vis, scale = _scores(q, k, causal, scale, kv_len)
    lse_g = lse.float().reshape(b, hkv, g, sq, 1)
    p = torch.where(vis, torch.exp(s - lse_g), torch.zeros_like(s))
    dog = do.float().reshape(b, sq, hkv, g, d)
    delta = (dog * o.float().reshape(b, sq, hkv, g, d)).sum(-1)
    dv = torch.einsum("bhgqk,bqhgd->bkhd", p, dog)
    dp = torch.einsum("bqhgd,bkhd->bhgqk", dog, v.float())
    ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None])
    dq = torch.einsum("bhgqk,bkhd->bqhgd", ds, k.float()) * scale
    dk = torch.einsum("bhgqk,bqhgd->bkhd", ds,
                      q.float().reshape(b, sq, hkv, g, d)) * scale
    return (dq.reshape(b, sq, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))
