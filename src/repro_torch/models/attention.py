"""GQA attention block: plan, the full-sequence update (prefill) and the
cached decode update.  Each returns the block's update before its residual
add: the caller adds it, since the MLP's norm after the block reads the
sum before it rounds (`models.transformer._ffn`).

Grouped KV heads, optional QKV bias, optional per-head q/k RMSNorm (qwen3)
and RoPE, as in the JAX package.  Prefill attention goes through
`kernels.attention.attention` (the hand-written flash kernel on a CUDA
tensor); one-token decode attention is plain torch, as it is an einsum in
the JAX package too.

With ``cfg.kv_quant`` the cache holds int8 codes and one float32 scale per
(stream, position, KV head): `quantize_kv` / `dequantize_kv`, the JAX
package's XLA ops written as the same torch ops (round half to even, then
clip to +-127).  Decode writes the new row's codes and scales, then attends
over the cache dequantised to ``cfg.adtype``, as the JAX package does.

The port writes the decode cache IN PLACE: `decode_update` stores the new
position into the ``(B, Smax, KV, HD)`` cache tensors it is given (the JAX
package's ``decode_step`` returns updated copies).  Its index is a scalar
(every stream at one length, the lockstep batch) or per slot, ``(B,)``
(the continuous-batching pool of `serving.lm.LMScheduler`, whose streams
sit at different lengths); ``active (B,)`` leaves a vacant slot's cache
rows bit for bit as they were, by selecting the old row, so that no shape
and no host read depends on the occupancy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.attention import attention as attn_op
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDesc, rms_norm, rope


def plan(cfg: ModelConfig, stack: int = 0) -> dict:
    """Parameter plan for one attention block (stacked `stack` deep if >0)."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def desc(shape, **kw):
        return ParamDesc((stack, *shape) if stack else shape,
                         dtype=cfg.dtype, **kw)

    p = {
        "wq": desc((d, h * hd), fan_in=d),
        "wk": desc((d, kv * hd), fan_in=d),
        "wv": desc((d, kv * hd), fan_in=d),
        "wo": desc((h * hd, d), fan_in=h * hd),
        "norm": desc((d,), init="ones"),
    }
    if cfg.qkv_bias:
        p["bq"] = desc((h * hd,), init="zeros")
        p["bk"] = desc((kv * hd,), init="zeros")
        p["bv"] = desc((kv * hd,), init="zeros")
    if cfg.qk_norm:
        p["q_norm"] = desc((hd,), init="ones")
        p["k_norm"] = desc((hd,), init="ones")
    return p


def _qkv(params, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"].to(q.dtype)
        k = k + params["bk"].to(k.dtype)
        v = v + params["bv"].to(v.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    q, k = rope(q, k, positions, cfg.rope_theta)
    return q, k, v


def update(params, x, cfg: ModelConfig, positions=None):
    """Full-sequence causal attention (prefill).  x (B,S,D) ->
    (the block's update attn (B,S,D), before the residual add;
    (k, v) each (B,S,KV,HD))."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device)[None, :]
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q, k, v = _qkv(params, h, cfg, positions)
    o = attn_op(q, k, v, causal=True)
    return o.reshape(b, s, -1) @ params["wo"], (k, v)


def quantize_kv(x):
    """Symmetric int8 over the head_dim axis.  x (..., HD) ->
    (codes int8 (..., HD), scale float32 (...,)), scale = max(amax, 1e-6)
    / 127.  Jitted, XLA turns that division into a product with float32
    1/127, which rounds differently in ~6% of the scales: so does this."""
    xf = x.float()
    scale = torch.clamp_min(xf.abs().amax(-1), 1e-6) * (1.0 / 127.0)
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q, scale, dtype=torch.bfloat16):
    return (q.float() * scale[..., None]).to(dtype)


def _write_at(cache, row, index, active=None):
    """Write one new position of every stream, ``row (B,1,...)``, into the
    ``(B,Smax,...)`` cache, in place: at the scalar ``index`` for every
    stream, or at each stream's own position for a ``(B,)`` index.  Under
    ``active (B,)`` a vacant stream's row is written back as it was, at
    position 0 (a lost slot's index is garbage)."""
    if index.ndim == 0 and active is None:
        cache.index_copy_(1, index.reshape(1).long(), row.to(cache.dtype))
        return cache
    b = cache.shape[0]
    rows = torch.arange(b, device=cache.device)
    idx = index.long().expand(b)
    new = row[:, 0].to(cache.dtype)
    if active is not None:
        idx = torch.where(active.to(torch.bool), idx, 0)
        mask = active.to(torch.bool).reshape((b,) + (1,) * (new.ndim - 1))
        new = torch.where(mask, new, cache[rows, idx])
    cache[rows, idx] = new
    return cache


def decode_update(params, x, cache_k, cache_v, index, cfg: ModelConfig,
                  active=None, scale_k=None, scale_v=None):
    """One-token cached attention.  x (B,1,D); cache (B,Smax,KV,HD),
    written in place at ``index``: a 0-d int tensor (every stream at the
    same length) or ``(B,)`` (per slot), the number of positions already
    resident.  ``active (B,)`` freezes vacant slots' cache rows.  Given
    ``scale_k`` / ``scale_v`` (B,Smax,KV) float32, the cache is int8 and
    they take the new row's scales, gated the same way.
    Returns the update (B,1,D), before the residual add."""
    b = x.shape[0]
    positions = (index.reshape(1, 1).expand(b, 1) if index.ndim == 0
                 else index[:, None])
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    q, k, v = _qkv(params, h, cfg, positions)
    if scale_k is not None:
        for cache, scale, row in ((cache_k, scale_k, k), (cache_v, scale_v,
                                                          v)):
            codes, sc = quantize_kv(row)
            _write_at(cache, codes, index, active)
            _write_at(scale, sc, index, active)
        cache_k = dequantize_kv(cache_k, scale_k, cfg.adtype)
        cache_v = dequantize_kv(cache_v, scale_v, cfg.adtype)
    else:
        _write_at(cache_k, k, index, active)
        _write_at(cache_v, v, index, active)
    o = _decode_attend(q, cache_k, cache_v, index, cfg)
    return o.reshape(b, 1, -1) @ params["wo"]


def _decode_attend(q, k, v, index, cfg: ModelConfig):
    """q (B,1,H,HD) against the whole cache, positions above ``index``
    (scalar, or each stream's own) masked.  Products of the storage-dtype
    operands accumulate in float32 (the JAX package's
    ``preferred_element_type``); the probabilities are cast to the cache
    dtype before the PV product, as there."""
    b, _, h, hd = q.shape
    smax, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) \
        * (hd ** -0.5)
    pos = torch.arange(smax, device=q.device)
    valid = (pos <= index if index.ndim == 0
             else (pos[None, :] <= index[:, None])[:, None, None, None, :])
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return o.reshape(b, 1, h, hd).to(q.dtype)
