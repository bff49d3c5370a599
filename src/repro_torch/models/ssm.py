"""Mamba2 (SSD) block: plan, full-sequence apply (prefill) and the recurrent
decode step.

Structure per Mamba2: in_proj -> [z | xBC | dt]; short causal conv over xBC;
SSD scan over heads; gated RMSNorm; out_proj.  The SSD scan goes through
`kernels.ssd.ssd` (the hand-written kernel on a CUDA tensor); the conv and
the decode step are plain torch, as they are plain jnp in the JAX package.
The B/C groups stay (B, L, G, S): the kernel indexes group
``h // (H / G)`` instead of repeating them to heads.

Training differentiates the block with autograd: the SSD scan and both
silu forms (the conv's activation and the output gate) are autograd
Functions whose backwards are hand-written kernels on the card
(`kernels.ssd.kernel.ssd_scan_bwd`, `layers.silu_bwd`); the conv, the
softplus and ``-exp(a_log)`` of `_ssd_inputs`, the skip and the norm are
plain PyTorch, as they are plain jnp in the JAX package, and none of the
block's ops writes in place.

The decode cache is the SSD state (B, H, S, P) float32 and the conv window
(B, W-1, C), O(1) per token; `decode_step` writes both IN PLACE into the
cache tensors it is given (the JAX package returns updated copies), and
under an ``active (B,)`` slot mask leaves a vacant slot's rows as they
were.

Rounding follows the JAX package under ``jax.jit``: bfloat16 products
round once, the conv sums in float32 and rounds once, silu rounds after
each of its ops (`layers.silu`), the gate's product reaches the norm
unrounded, and the decode step computes from the SSD state to the output
projection in float32, as the JAX package's float32 decode state promotes
it there.  A bfloat16 block's prefill equals the jitted JAX block bit for
bit (tests/test_torch_ssd.py).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd as ssd_op
from repro_torch.kernels.ssd import ssd_decode_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDesc, rms_norm, silu


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    d_xbc = d_inner + 2 * s.n_groups * s.state
    return d_inner, n_heads, d_xbc


def plan(cfg: ModelConfig, stack: int = 0) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, d_xbc = dims(cfg)

    def desc(shape, **kw):
        kw.setdefault("dtype", cfg.dtype)
        return ParamDesc((stack, *shape) if stack else shape, **kw)

    return {
        "norm": desc((d,), init="ones"),
        # fused input projection: z (d_inner) | xBC (d_xbc) | dt (n_heads)
        "w_in": desc((d, d_inner + d_xbc + n_heads), fan_in=d),
        "conv_w": desc((s.conv_width, d_xbc), fan_in=s.conv_width),
        "conv_b": desc((d_xbc,), init="zeros"),
        "a_log": desc((n_heads,), init="zeros", dtype="float32"),
        "dt_bias": desc((n_heads,), init="zeros", dtype="float32"),
        "d_skip": desc((n_heads,), init="ones", dtype="float32"),
        "out_norm": desc((d_inner,), init="ones"),
        "w_out": desc((d_inner, d), fan_in=d_inner),
    }


def _split(cfg, proj):
    d_inner, _, d_xbc = dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner:d_inner + d_xbc]
    dt_raw = proj[..., d_inner + d_xbc:]
    return z, xbc, dt_raw


def _conv(xbc, conv_w, conv_b):
    """Short causal conv along the sequence.  xbc (B,S,C); conv_w (W,C).
    The window sums in float32 and rounds once to xbc's dtype."""
    w, s = conv_w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i:i + s].float() * conv_w[i].float() for i in range(w))
    return silu(out.to(xbc.dtype) + conv_b)


def _ssd_inputs(cfg, xbc, dt_raw, a_log, dt_bias):
    """x (B,L,H,P) and B/C (B,L,G,S) as views of xbc; dt (B,L,H) and
    a (H,) in float32."""
    s = cfg.ssm
    d_inner, n_heads, _ = dims(cfg)
    gs = s.n_groups * s.state
    x = xbc[..., :d_inner].unflatten(-1, (n_heads, s.head_dim))
    bmat = xbc[..., d_inner:d_inner + gs].unflatten(-1, (s.n_groups,
                                                         s.state))
    cmat = xbc[..., d_inner + gs:].unflatten(-1, (s.n_groups, s.state))
    v = dt_raw.float() + dt_bias
    dt = torch.logaddexp(v, torch.zeros_like(v))          # softplus, (B,L,H)
    a = -torch.exp(a_log)                                 # (H,)
    return x, dt, a, bmat, cmat


def _out(params, y, xs, z, x, cfg: ModelConfig):
    """Skip term, gated RMSNorm and the output projection."""
    y = y + (params["d_skip"][:, None] * xs.float()).to(y.dtype)
    y = y.flatten(-2)                                     # (B,S,d_inner)
    # the gate's product enters the norm unrounded: under jax.jit XLA
    # upcasts the bf16 product straight into the norm's float32
    gated = silu(z, y, torch.float32)
    y = rms_norm(gated, params["out_norm"], cfg.norm_eps).to(y.dtype)
    out = y @ params["w_out"].to(y.dtype)
    return x + out.to(x.dtype)


def apply(params, x, cfg: ModelConfig):
    """Full-sequence SSD (prefill).  x (B,S,D) ->
    (out (B,S,D), final SSD state (B,H,S,P) float32, conv tail: the last
    W-1 rows of the raw xBC before the conv (fewer for a shorter prompt))."""
    s = cfg.ssm
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    proj = h @ params["w_in"]
    z, xbc, dt_raw = _split(cfg, proj)
    conv_tail = xbc[:, -(s.conv_width - 1):]
    xbc = _conv(xbc, params["conv_w"], params["conv_b"])
    xs, dt, a, bmat, cmat = _ssd_inputs(cfg, xbc, dt_raw,
                                        params["a_log"], params["dt_bias"])
    y, state = ssd_op(xs, dt, a, bmat, cmat, chunk=s.chunk)
    return _out(params, y, xs, z, x, cfg), state, conv_tail


def plan_cache(cfg: ModelConfig, batch: int, n_layers: int) -> dict:
    """Decode cache: SSD state + conv window."""
    s = cfg.ssm
    _, n_heads, d_xbc = dims(cfg)
    return {
        "ssm": ParamDesc((n_layers, batch, n_heads, s.state, s.head_dim),
                         init="zeros", dtype="float32"),
        "conv": ParamDesc((n_layers, batch, s.conv_width - 1, d_xbc),
                          init="zeros", dtype=cfg.dtype),
    }


def decode_step(params, x, ssm_state, conv_state, cfg: ModelConfig,
                active=None):
    """One-token recurrent step.  x (B,1,D); ssm_state (B,H,S,P) and
    conv_state (B,W-1,C), both written in place; under ``active (B,)`` a
    vacant stream's rows of both stay bit for bit as they were.
    Returns (out (B,1,D), ssm_state, conv_state)."""
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    proj = h @ params["w_in"]
    z, xbc, dt_raw = _split(cfg, proj)
    window = torch.cat([conv_state, xbc], dim=1)          # (B,W,C)
    conv = torch.einsum("bwc,wc->bc", window.float(),
                        params["conv_w"].float())[:, None]
    if active is None:
        conv_state.copy_(window[:, 1:])
    else:
        mask = active.to(torch.bool).reshape(-1, 1, 1)
        conv_state.copy_(torch.where(mask, window[:, 1:], conv_state))
    xbc = silu(conv.to(x.dtype) + params["conv_b"])
    xs, dt, a, bmat, cmat = _ssd_inputs(cfg, xbc, dt_raw,
                                        params["a_log"], params["dt_bias"])
    _, y = ssd_decode_step(ssm_state, xs[:, 0], dt[:, 0], a, bmat[:, 0],
                           cmat[:, 0], active)
    return _out(params, y[:, None], xs, z, x, cfg), ssm_state, conv_state
