"""Decoder-only LM as a sequence of SEGMENTS, each a stack of identical
blocks:

  dense    — GQA attention + SwiGLU MLP   (qwen3 and the other dense archs)
  dense_ff — dense with an override FFN width (deepseek-moe's first layer)
  moe      — GQA attention + routed-expert FFN (deepseek-moe, grok-1;
             `models.moe`)
  ssm      — Mamba2 SSD block             (mamba2; the hybrid's remainder)
  zsuper   — one SHARED attention + MLP block, then ``attn_every - 1``
             Mamba2 blocks (zamba2; the shared block's parameters live
             once at the top level, as ``shared_attn`` and ``shared_mlp``)

The parameters keep the JAX package's tree: ``segments`` is a list of
segments whose leaves are stacked over the segment's layers (a zsuper's
Mamba2 leaves twice: super-block, then inner block), and where the JAX
package scans over a stack the port runs a Python loop over it.

Entry points:
  plan / init                        — parameter plan and random init
  forward                            — full-sequence logits (or hidden);
                                       ``remat=True`` recomputes each block
                                       in the backward
  loss_fn                            — next-token cross entropy (the
                                       training loss of the dense, ssm and
                                       hybrid layouts)
  cache_plan / init_cache / prefill / decode_step — serving with a KV cache
                                       per attention block (int8 codes and
                                       float32 scales with ``kv_quant``)
                                       and an SSD state and conv window per
                                       Mamba2 block
  decode_rollout                     — K known tokens per stream: the
                                       backbone token by token, the adapter
                                       once over the window

The decode cache's ``index`` is a scalar for a lockstep batch, or one
position per stream (``per_slot_index=True``) for the continuous-batching
pool (`serving.lm.LMScheduler`), whose decode takes an ``active (B,)`` slot
mask: a vacant slot's whole cache row (K/V, SSM and conv state, index,
adapter state) stays bit for bit as it was, and its token takes no expert
capacity in a MoE layer (`moe.apply`'s ``token_mask``).
"""
from __future__ import annotations

from typing import Any

import dataclasses

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.snn import resolve_device
from repro_torch.models import attention, moe as moe_mod, plastic, \
    ssm as ssm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (ParamDesc, cross_entropy,
                                       init_from_plan, map_plan,
                                       param_count, rms_norm, swiglu)


def segments(cfg: ModelConfig) -> list[tuple[str, int]]:
    if cfg.layout == "dense":
        return [("dense", cfg.n_layers)]
    if cfg.layout == "moe":
        fd = cfg.moe.first_dense
        return ([("dense_ff", fd)] if fd else []) + [("moe",
                                                       cfg.n_layers - fd)]
    if cfg.layout == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.layout == "hybrid":
        per = cfg.ssm.attn_every
        n_super = cfg.n_layers // per
        rem = cfg.n_layers - n_super * per
        return [("zsuper", n_super)] + ([("ssm", rem)] if rem else [])
    raise ValueError(f"unknown layout {cfg.layout!r}")


def _stack_plan(plan, n: int):
    """The plan with a stacking dim of ``n`` before every leaf's shape."""
    return map_plan(lambda d: dataclasses.replace(d, shape=(n, *d.shape)),
                    plan)


def _mlp_plan(cfg: ModelConfig, d_ff: int, stack: int = 0) -> dict:
    d = cfg.d_model

    def desc(shape, **kw):
        return ParamDesc((stack, *shape) if stack else shape,
                         dtype=cfg.dtype, **kw)

    return {
        "norm": desc((d,), init="ones"),
        "w_gate": desc((d, d_ff), fan_in=d),
        "w_up": desc((d, d_ff), fan_in=d),
        "w_down": desc((d_ff, d), fan_in=d_ff),
    }


def _segment_plan(cfg: ModelConfig, kind: str, count: int) -> dict:
    if kind == "ssm":
        return ssm_mod.plan(cfg, stack=count)
    if kind == "zsuper":
        inner = cfg.ssm.attn_every - 1
        return {"ssm": _stack_plan(ssm_mod.plan(cfg, stack=inner), count)}
    if kind == "moe":
        return {"attn": attention.plan(cfg, stack=count),
                "moe": moe_mod.plan(cfg, stack=count)}
    d_ff = cfg.moe.first_dense_ff if kind == "dense_ff" else cfg.d_ff
    return {"attn": attention.plan(cfg, stack=count),
            "mlp": _mlp_plan(cfg, d_ff, stack=count)}


def plan(cfg: ModelConfig) -> dict:
    d, v = cfg.d_model, cfg.vocab
    p: dict[str, Any] = {
        "embed": ParamDesc((v, d), scale=1.0, fan_in=d, dtype=cfg.dtype),
        "segments": [_segment_plan(cfg, k, n) for k, n in segments(cfg)],
        "final_norm": ParamDesc((d,), init="ones", dtype=cfg.dtype),
    }
    if cfg.layout == "hybrid":
        p["shared_attn"] = attention.plan(cfg)
        p["shared_mlp"] = _mlp_plan(cfg, cfg.d_ff)
    if not cfg.tie_embeddings:
        p["lm_head"] = ParamDesc((d, v), fan_in=d, dtype=cfg.dtype)
    if cfg.plastic_adapter:
        p["adapter"] = plastic.plan(cfg)
    return p


def init(cfg: ModelConfig, generator: torch.Generator):
    return init_from_plan(plan(cfg), generator)


def _layer(seg: dict, i) -> dict:
    """Layer ``i`` (an index or a tuple of them) of a stacked segment
    (views, no copies)."""
    return {k: _layer(t, i) if isinstance(t, dict) else t[i]
            for k, t in seg.items()}


def _head_w(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _shared(params, cfg: ModelConfig):
    """The hybrid's shared attention + MLP block, in a dense block's tree
    (the same tensors for every super-block, never copied)."""
    if cfg.layout != "hybrid":
        return None
    return {"attn": params["shared_attn"], "mlp": params["shared_mlp"]}


def _ffn(p, x, o, cfg: ModelConfig, token_mask=None):
    """The residual add of the block's attention update ``o``, then its
    FFN: the MLP, or in a MoE block the routed experts (``token_mask``
    keeps a vacant slot's token out of their capacity).  The norm reads
    the sum before it rounds to x's dtype: under jax.jit XLA upcasts the
    bf16 sum straight into the norm's float32."""
    s = x.float() + o                    # o promotes to float32 exactly
    x = s.to(x.dtype)
    f = p["moe"] if "moe" in p else p["mlp"]
    h = rms_norm(s, f["norm"], cfg.norm_eps).to(x.dtype)
    if "moe" in p:
        return moe_mod.apply(f, x, h, cfg, token_mask=token_mask)
    return x + swiglu(h, f["w_gate"], f["w_up"], f["w_down"])


def _dense(p, h, cfg: ModelConfig):
    """Attention + MLP (or MoE FFN): (h, (k, v))."""
    o, kv = attention.update(p["attn"], h, cfg)
    return _ffn(p, h, o, cfg), kv


def _remat(fn):
    """``fn(h, p)`` run under `torch.utils.checkpoint`: the block keeps
    only its input for the backward and recomputes the rest there, as
    ``jax.checkpoint`` with ``nothing_saveable`` does."""
    return lambda h, p: checkpoint(fn, h, p, use_reentrant=False)


def _ssm_block(p, h, cfg: ModelConfig):
    """A Mamba2 block: (h, (final SSD state, conv tail))."""
    h, state, conv = ssm_mod.apply(p, h, cfg)
    return h, (state, conv)


def forward(params, inputs, cfg: ModelConfig, *, collect_cache=None,
            head: bool = True, remat: bool = False):
    """inputs: tokens (B,S) int (or embeddings (B,S,D) for
    ``input_mode="embeddings"``).  Returns logits (B,S,V), or with
    ``head=False`` the final normed hidden state (B,S,D).
    ``collect_cache(segment, layer, *leaves)``, if given, receives every
    block's cache leaves as they are made: the keys and values (B,S,KV,HD)
    of an attention block, the final SSD state (B,H,S,P) and the raw conv
    tail (B,<=W-1,C) of a Mamba2 block.  In a zsuper segment the shared
    block reports at ``layer = i`` and its j-th Mamba2 block at
    ``layer = (i, j)``.

    ``remat`` runs every block under `_remat` (training; no cache is
    collected then): each dense block, each Mamba2 block and each use of
    a zsuper's shared block.  A stacked leaf's layer is ``leaf[i]``, so
    the segments' leaves may also be lists of per-layer tensors, a
    zsuper's Mamba2 leaves lists of lists (the training step's per-layer
    leaves, `launch.steps`)."""
    if remat and collect_cache is not None:
        raise ValueError("remat recomputes the blocks in the backward; it "
                         "collects no cache")
    if cfg.input_mode == "embeddings" and inputs.ndim == 3:
        h = inputs.to(cfg.adtype)
    else:
        h = params["embed"][inputs]
    shared = _shared(params, cfg)

    def keep(*a):
        if collect_cache is not None:
            collect_cache(*a)

    def dense_block(h, p):
        return _dense(p, h, cfg)

    def ssm_block(h, p):
        return _ssm_block(p, h, cfg)

    if remat:
        dense_block, ssm_block = _remat(dense_block), _remat(ssm_block)
    for seg_idx, (kind, count) in enumerate(segments(cfg)):
        seg = params["segments"][seg_idx]
        for i in range(count):
            p = _layer(seg, i)
            if kind == "ssm":
                h, leaves = ssm_block(h, p)
                keep(seg_idx, i, *leaves)
                continue
            h, kv = dense_block(h, shared if kind == "zsuper" else p)
            keep(seg_idx, i, *kv)
            if kind == "zsuper":
                for j in range(cfg.ssm.attn_every - 1):
                    h, leaves = ssm_block(h, _layer(p["ssm"], j))
                    keep(seg_idx, (i, j), *leaves)
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    if not head:
        return h
    return h @ _head_w(params, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """batch: {"inputs": tokens (B,S) or embeddings (B,S,D), "labels":
    (B,S) int, -1 = pad}.  The mean next-token NLL over the labels that
    are not pads, in float32.  With ``cfg.remat`` every block is
    recomputed in the backward, as the JAX package's ``nothing_saveable``
    policy does."""
    logits = forward(params, batch["inputs"], cfg, remat=cfg.remat)
    labels = batch["labels"]
    mask = (labels >= 0).float()
    return cross_entropy(logits, labels.clamp_min(0), mask)


# ---------------------------------------------------------------------------
# Serving: cache plan, prefill, decode
# ---------------------------------------------------------------------------


def cache_plan(cfg: ModelConfig, batch: int, max_len: int,
               per_slot_index: bool = False) -> dict:
    """The decode cache: per segment a ``(L, B, max_len, KV, HD)`` K and V
    (dense, dense_ff, moe), a ``(L, B, H, S, P)`` float32 SSD state and
    ``(L, B, W-1, C)`` conv window (ssm), or both for a zsuper segment: K
    and V per super-block and ``"ssm": {"ssm", "conv"}`` stacked
    (super-block, inner block); the ``index`` (positions resident: a scalar, every stream in
    lockstep, or ``(B,)`` with ``per_slot_index``, one length per stream)
    and, with the adapter, its per-stream state.  With ``cfg.kv_quant`` K
    and V are int8 codes beside ``(L, B, max_len, KV)`` float32
    ``k_scale`` and ``v_scale`` planes."""
    segs = []
    for kind, count in segments(cfg):
        if kind == "ssm":
            segs.append(ssm_mod.plan_cache(cfg, batch, count))
            continue
        kv = ParamDesc((count, batch, max_len, cfg.n_kv_heads, cfg.hd),
                       init="zeros",
                       dtype="int8" if cfg.kv_quant else cfg.dtype)
        segs.append({"k": kv, "v": kv})
        if cfg.kv_quant:
            sc = ParamDesc((count, batch, max_len, cfg.n_kv_heads),
                           init="zeros", dtype="float32")
            segs[-1].update(k_scale=sc, v_scale=sc)
        if kind == "zsuper":
            inner = ssm_mod.plan_cache(cfg, batch, cfg.ssm.attn_every - 1)
            segs[-1]["ssm"] = _stack_plan(inner, count)
    out = {"segments": segs,
           "index": ParamDesc((batch,) if per_slot_index else (),
                              init="zeros", dtype="int32")}
    if cfg.plastic_adapter:
        out["adapter"] = plastic.plan_cache(cfg, batch)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               per_slot_index: bool = False):
    """The zeroed decode cache on ``device`` (None: the card)."""
    gen = torch.Generator(resolve_device(device))
    return init_from_plan(cache_plan(cfg, batch, max_len, per_slot_index),
                          gen)


def prefill(params, inputs, cfg: ModelConfig, max_len: int):
    """Run the prompts through the model, building the decode cache.
    Returns (last-position logits (B,V), cache)."""
    bsz, s = inputs.shape[0], inputs.shape[1]
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens does not fit max_len "
                         f"{max_len}")
    cache = init_cache(cfg, bsz, max_len, device=params["embed"].device)
    kinds = [kind for kind, _ in segments(cfg)]

    def put(seg, layer, *leaves):
        c = cache["segments"][seg]
        if kinds[seg] == "ssm":
            _embed_ssm(c, layer, *leaves)
        elif isinstance(layer, tuple):          # a zsuper's Mamba2 block
            _embed_ssm(c["ssm"], layer, *leaves)
        else:
            _embed_kv(c, layer, *leaves)

    hidden = forward(params, inputs, cfg, collect_cache=put, head=False)
    logits = hidden[:, -1] @ _head_w(params, cfg)
    cache["index"].fill_(s)
    return logits, cache


def _embed_kv(seg_cache: dict, layer: int, k, v):
    """Place one layer's prefilled (B,S,KV,HD) keys and values at the
    start of its (B,max_len,KV,HD) slot of the cache; an int8 cache takes
    their codes and scales (the scale is per stream, position and head,
    so one layer at a time gives the codes of the whole stack)."""
    s = k.shape[1]
    for name, x in (("k", k), ("v", v)):
        if f"{name}_scale" in seg_cache:
            x, scale = attention.quantize_kv(x)
            seg_cache[f"{name}_scale"][layer, :, :s] = scale
        seg_cache[name][layer, :, :s] = x


def _embed_ssm(seg_cache: dict, layer, state, conv_tail):
    """Place one Mamba2 block's prefilled SSD state and raw conv tail in
    its slot of the cache (``layer`` an index, or a tuple of them into a
    zsuper's stack); a prompt shorter than the conv window leaves the zeros
    of the missing history before it."""
    seg_cache["ssm"][layer] = state
    seg_cache["conv"][layer][:, -conv_tail.shape[1]:] = conv_tail


def _decode_backbone(params, cache, tokens, cfg: ModelConfig, active=None):
    """Embed + all layers for ONE new token per stream, tokens (B,1); the
    cache is written in place.  Returns (h (B,1,D) before the final norm,
    the new index).  ``active (B,)`` makes a vacant slot a no-op on every
    piece of its cache row: K/V rows write back what they held, SSM and
    conv rows are selected, a per-slot index holds, and its token is
    masked out of every MoE layer's expert capacity; its hidden state is
    computed and nothing persistent reads it."""
    index = cache["index"]
    token_mask = None if active is None else active[:, None] != 0
    h = params["embed"][tokens]
    shared = _shared(params, cfg)
    for seg_idx, (kind, count) in enumerate(segments(cfg)):
        seg = params["segments"][seg_idx]
        c = cache["segments"][seg_idx]
        for i in range(count):
            p = _layer(seg, i)
            if kind == "ssm":
                h, _, _ = ssm_mod.decode_step(p, h, c["ssm"][i],
                                              c["conv"][i], cfg, active)
                continue
            blk = shared if kind == "zsuper" else p
            scales = ((c["k_scale"][i], c["v_scale"][i]) if "k_scale" in c
                      else ())
            o = attention.decode_update(blk["attn"], h, c["k"][i], c["v"][i],
                                        index, cfg, active, *scales)
            h = _ffn(blk, h, o, cfg, token_mask)
            if kind == "zsuper":
                inner = c["ssm"]
                for j in range(cfg.ssm.attn_every - 1):
                    h, _, _ = ssm_mod.decode_step(
                        _layer(p["ssm"], j), h, inner["ssm"][i, j],
                        inner["conv"][i, j], cfg, active)
    if index.ndim == 0 or active is None:
        return h, index + 1
    # per slot: a vacant slot's position holds
    return h, index + (active != 0).to(index.dtype)


def _head(params, h, cfg: ModelConfig):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    return h @ _head_w(params, cfg)


def decode_step(params, cache, tokens, cfg: ModelConfig, active=None):
    """One decode step.  tokens (B,1) int; the new token is written at
    ``cache["index"]`` (in place; scalar for a lockstep batch, per slot
    under the pool).  ``active (B,)`` marks resident streams: a vacant
    slot's cache row and adapter state stay bit for bit, its logits are
    garbage nothing reads.  Returns (logits (B,V), new_cache)."""
    h, new_index = _decode_backbone(params, cache, tokens, cfg, active)
    new_cache = {"segments": cache["segments"], "index": new_index}
    if cfg.plastic_adapter:
        h, new_cache["adapter"] = plastic.decode_step(
            params["adapter"], cache["adapter"], h, cfg, active=active)
    return _head(params, h, cfg)[:, 0], new_cache


def decode_rollout(params, cache, tokens, cfg: ModelConfig, active=None):
    """K known tokens per stream, tokens (B,K) int: teacher-forced decode
    (the scheduler's `decode_window`, draft verification, prompt tails).
    The backbone runs token by token (each token's attention sees the one
    before it), writing the cache in place; the adapter sits after every
    segment and touches only the final hidden state, so it then runs once
    over the whole (B, K, D) window: `plastic.decode_rollout`, one fleet
    rollout launch on the card.  The head runs per token, as a step runs
    it.  Equal to K `decode_step` calls on the same tokens: the cache bit
    for bit, the int8 adapter bit for bit, the float32 adapter within the
    rollout kernel's float32 rounding (ROADMAP.md, Queue 3).

    Returns (logits (B,K,V), new_cache)."""
    index, hs = cache["index"], []
    for k in range(tokens.shape[1]):
        h, index = _decode_backbone(
            params, {"segments": cache["segments"], "index": index},
            tokens[:, k:k + 1], cfg, active)
        hs.append(h)
    h = torch.cat(hs, dim=1)                              # (B,K,D)
    new_cache = {"segments": cache["segments"], "index": index}
    if cfg.plastic_adapter:
        h, new_cache["adapter"] = plastic.decode_rollout(
            params["adapter"], cache["adapter"], h, cfg, active=active)
    logits = torch.cat([_head(params, h[:, k:k + 1], cfg)
                        for k in range(h.shape[1])], dim=1)
    return logits, new_cache


def n_params(cfg: ModelConfig) -> int:
    return param_count(plan(cfg))
