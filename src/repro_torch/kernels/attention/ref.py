"""Plain PyTorch attention: the plain version of ``csrc/flash_attention.cu``.

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


def mha(q, k, v, *, causal: bool = True, scale: Optional[float] = None,
        kv_len: Optional[int] = None):
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    g = h // hkv
    scale = scale if scale is not None else d ** -0.5
    qg = q.float().reshape(b, sq, hkv, g, d)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    vis = mask(sq, skv, causal=causal, kv_len=kv_len, device=q.device)
    s = torch.where(vis, s, torch.full_like(s, NEG_INF))
    p = torch.exp(s - s.amax(-1, keepdim=True)) * vis
    den = p.sum(-1, keepdim=True)
    p = p / torch.where(den == 0, torch.ones_like(den), den)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(b, sq, h, d).to(q.dtype)
