"""Common layers and the parameter-plan machinery.

A model is described by a PLAN: a tree of dicts and lists whose leaves are
`ParamDesc` (shape, init, dtype).  `init_from_plan` turns it into real
tensors drawn from a `torch.Generator`, `param_count` counts it.  The
JAX package's logical sharding specs are gone: the port runs on one card.

`rms_norm` and `rope` compute in float32 and cast back to the input's
dtype, as the JAX package does, so a bfloat16 model rounds at the same
places in both.  `silu` rounds after each op as ``jax.nn.silu`` is
written, in one pass on the card (``csrc/silu.cu``), and under autograd
its gradient, in each form the models train (the SwiGLU gate, the Mamba2
conv's activation and output gate), rounds where jitted ``jax.vjp`` of it
rounds (`silu_bwd`, the same file's second entry point).
`cross_entropy` is the JAX package's mean token NLL in float32.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plasticity.kernel import on_card, stream_of
from repro_torch.models.config import torch_dtype

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


@dataclasses.dataclass(frozen=True)
class ParamDesc:
    shape: Tuple[int, ...]
    init: str = "normal"               # normal | zeros | ones | full
                                       # ("full" fills with `scale`)
    scale: float = 1.0                 # stddev multiplier (normal)
    fan_in: Optional[int] = None       # normal: std = scale / sqrt(fan_in)
    dtype: str = "bfloat16"


def leaves(plan) -> list:
    """The plan's `ParamDesc` leaves in a fixed order (dict keys sorted,
    as JAX flattens them; lists in order)."""
    if isinstance(plan, ParamDesc):
        return [plan]
    if isinstance(plan, dict):
        return [d for k in sorted(plan) for d in leaves(plan[k])]
    if isinstance(plan, (list, tuple)):
        return [d for p in plan for d in leaves(p)]
    raise TypeError(f"plan node of type {type(plan).__name__}")


def map_plan(fn, plan):
    """The plan's tree with every `ParamDesc` replaced by ``fn(desc)``."""
    if isinstance(plan, ParamDesc):
        return fn(plan)
    if isinstance(plan, dict):
        return {k: map_plan(fn, plan[k]) for k in sorted(plan)}
    return [map_plan(fn, p) for p in plan]


_DRAW_CHUNK = 1 << 26


def init_from_plan(plan, generator: torch.Generator):
    """Real parameters on the generator's device, one draw per ``normal``
    leaf in `leaves` order (in pieces of 2^26 elements):
    ``std = scale / sqrt(fan_in)`` with ``fan_in`` defaulting to the
    second-to-last dim (the last for vectors)."""
    dev = generator.device

    def mk(d: ParamDesc):
        dt = torch_dtype(d.dtype)
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=dev)
        if d.init == "full":
            return torch.full(d.shape, d.scale, dtype=dt, device=dev)
        fan = d.fan_in if d.fan_in else (
            d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
        std = d.scale / (fan ** 0.5)
        # drawn in pieces, so that a large leaf's float32 draw (a full-width
        # stacked MLP's is 36 GB) never sits beside the whole leaf
        out = torch.empty(d.shape, dtype=dt, device=dev)
        flat = out.view(-1)
        for i in range(0, flat.numel(), _DRAW_CHUNK):
            m = min(_DRAW_CHUNK, flat.numel() - i)
            flat[i:i + m] = torch.randn(m, generator=generator,
                                        device=dev).mul_(std)
        return out

    return map_plan(mk, plan)


def param_count(plan) -> int:
    n = 0
    for d in leaves(plan):
        c = 1
        for s in d.shape:
            c *= s
        n += c
    return n


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def rms_norm(x, weight, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * weight.float()
    return out.to(x.dtype)


def rope(q, k, positions, theta: float):
    """Rotary embeddings.  q/k (..., S, H, D); positions (..., S)."""
    d = q.shape[-1]
    half = d // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=q.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=q.device), exps)
    ang = positions[..., None].float() * freqs           # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]

    def rot(x):
        xf1, xf2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                         -1).to(x.dtype)

    return rot(q), rot(k)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def cross_entropy(logits, labels, mask=None):
    """Mean token NLL in float32.  logits (..., V); labels (...) int, each
    in [0, V) (the caller masks pads, as `transformer.loss_fn` does); mask
    (...) float or None.  lse - picked with the max held out of the
    gradient, as the JAX package writes it; the label's logit is picked by
    a gather, which equals JAX's one-hot contraction exactly for finite
    logits and makes no (..., V) one-hot (2.3 GiB in float32 at
    qwen3-4b's vocab and 4096 tokens)."""
    lf = logits.float()
    lmax = lf.amax(-1, keepdim=True).detach()
    lse = torch.log(torch.exp(lf - lmax).sum(-1)) + lmax[..., 0]
    picked = logits.gather(-1, labels.long()[..., None])[..., 0].float()
    nll = lse - picked
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1)
    return nll.mean()


def _sigmoid(x):
    """1 / (1 + exp(-x)), each op rounding to x's dtype."""
    return torch.reciprocal(torch.exp(torch.neg(x)) + 1)


def silu_plain(x, other=None, out_dtype=None):
    """`silu`'s plain version: the five ops as ``jax.nn.silu`` writes
    them, each rounding to x's dtype, then the product with ``other``
    (none of them in place, so that autograd can differentiate it)."""
    out_dtype = out_dtype or x.dtype
    s = (_sigmoid(x) * x).to(out_dtype)
    return s if other is None else s * other.to(out_dtype)


def silu_bwd_plain(x, other, dy):
    """`silu_bwd`'s plain version: the gradient of ``silu(x) * other`` (or
    of ``silu(x)`` where ``other`` is None) for the output gradient
    ``dy``, all in x's dtype, at the rounding sites of jitted ``jax.vjp``
    of ``jax.nn.silu(x) * other`` (each op rounds to x's dtype):
      s = 1 / (1 + exp(-x)),  i = dy * other (dy without other),
      dx = i * s + (x * i) * (s * (1 - s)),  dother = (x * s) * dy.
    In float32 nothing rounds between the ops and LLVM contracts the
    outer sum into a fused multiply-add, fma(i, s, (x * i) * (s * (1 -
    s))), taken here through float64 (the product of two float32 values
    is exact there).  Returns (dx, dother), dother None without other."""
    s = _sigmoid(x)
    i = dy if other is None else dy * other
    m = (x * i) * (s * (1 - s))
    if x.dtype == torch.float32:
        dx = (i.double() * s.double() + m.double()).float()
    else:
        dx = i * s + m
    return dx, None if other is None else (s * x) * dy


def _grad_wanted(*ts) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in ts)


def silu(x, other=None, out_dtype=None):
    """``jax.nn.silu`` as JAX writes it, x * (1 / (1 + exp(-x))), every op
    rounding to x's dtype (in bfloat16 ``F.silu``, which rounds once,
    differs from it by one step on ~37% of the elements), times ``other``
    if given, in ``out_dtype`` (x's dtype by default; float32 keeps the
    product unrounded).  x is float32 or bfloat16; ``other`` has x's
    shape and x's dtype or float32; the kernel reads rows at their stride
    (a last dim that is not contiguous is copied first).  A CPU
    tensor takes `silu_plain`; a CUDA tensor launches ``csrc/silu.cu`` in
    one pass and counts it in ``silu.launches``.

    Under autograd (grad mode on, x or other requiring grad) the three
    forms the models train run as `torch.autograd.Function`s whose
    backward is `silu_bwd`: the SwiGLU gate's (other and the output in
    x's dtype), the Mamba2 conv's one-operand ``silu(x)`` and the Mamba2
    output gate's (other in x's dtype, the output float32: the output's
    float32 gradient rounds to x's dtype first, as the transpose of
    JAX's upcast of the bf16 product does).  On the card any other form
    raises there; on the CPU autograd differentiates `silu_plain`."""
    out_dtype = out_dtype or x.dtype
    if _grad_wanted(x, other):
        if (out_dtype == x.dtype if other is None else
                other.dtype == x.dtype
                and out_dtype in (x.dtype, torch.float32)):
            return _Silu.apply(x, other, out_dtype)
        if on_card(x):
            got = None if other is None else (tuple(other.shape),
                                              other.dtype)
            raise NotImplementedError(
                f"silu's gradient on the card takes silu(x), and silu(x, "
                f"other) with other in x's dtype and the output in x's "
                f"dtype or float32; got x {tuple(x.shape)} {x.dtype}, other "
                f"{got}, out {out_dtype}")
        return silu_plain(x, other, out_dtype)
    return _silu_forward(x, other, out_dtype)


def _silu_forward(x, other, out_dtype):
    if not on_card(x):
        return silu_plain(x, other, out_dtype)
    kinds = ((x.dtype, None, x.dtype), (x.dtype, x.dtype, x.dtype),
             (x.dtype, x.dtype, torch.float32),
             (x.dtype, torch.float32, torch.float32))
    got = (x.dtype, None if other is None else other.dtype, out_dtype)
    if x.dtype not in _DTYPE_CODE or got not in kinds:
        raise ValueError(f"silu takes float32 or bfloat16 x, other in x's "
                         f"dtype or float32 and out_dtype x's or float32; "
                         f"got (x, other, out) {got}")
    if other is not None and (other.shape != x.shape
                              or other.device != x.device):
        raise ValueError(f"other must match x: {tuple(x.shape)} on "
                         f"{x.device}; got {tuple(other.shape)} on "
                         f"{other.device}")
    cols = x.shape[-1] if x.ndim else 1
    # rows at any stride, each row's elements contiguous
    x2, u2 = (None if t is None else _rows(t, cols) for t in (x, other))
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    fn = _build.library("silu.cu").silu
    fn.argtypes = [_P, _L, _P, _L, _I, _P, _I, _L, _I, _I, _P]
    fn.restype = _I
    _build.check(fn(x2.data_ptr(), x2.stride(0),
                    None if u2 is None else u2.data_ptr(),
                    0 if u2 is None else u2.stride(0),
                    0 if u2 is None else _DTYPE_CODE[u2.dtype],
                    y.data_ptr(), _DTYPE_CODE[out_dtype], x2.shape[0], cols,
                    _DTYPE_CODE[x.dtype], stream_of(x)), "silu")
    _silu.launches += 1
    return y


def _rows(t, cols):
    """t as (rows, cols) with each row's elements contiguous (a last dim
    that is not contiguous is copied first)."""
    return (t if t.ndim and t.stride(-1) == 1 else t.contiguous()
            ).reshape(-1, cols)


def silu_bwd(x, other, dy):
    """The gradient of ``silu(x, other)`` (x's dtype out), or of
    ``silu(x)`` where ``other`` is None, for ``dy``: (dx, dother), as
    `silu_bwd_plain` rounds it (dother None without other).  x, other and
    dy in one dtype, float32 or bfloat16, of one shape.  A CPU tensor
    takes `silu_bwd_plain`; a CUDA tensor launches ``csrc/silu.cu``'s
    ``silu_bwd`` in one pass (the inputs read once, the gradients written
    once) and counts it in ``silu.bwd_launches``."""
    if not on_card(x):
        return silu_bwd_plain(x, other, dy)
    for name, t in (("other", other), ("dy", dy)):
        if t is not None and (t.shape != x.shape or t.dtype != x.dtype
                              or t.device != x.device):
            raise ValueError(f"{name} must match x: {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}; got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"silu_bwd takes float32 or bfloat16; got "
                         f"{x.dtype}")
    cols = x.shape[-1] if x.ndim else 1
    x2, d2 = _rows(x, cols), _rows(dy, cols)
    u2 = None if other is None else _rows(other, cols)
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    du = None if other is None else torch.empty_like(dx)
    if dx.numel() == 0:
        return dx, du
    fn = _build.library("silu.cu").silu_bwd
    fn.argtypes = [_P, _L, _P, _L, _P, _L, _P, _P, _L, _I, _I, _P]
    fn.restype = _I
    _build.check(fn(x2.data_ptr(), x2.stride(0),
                    None if u2 is None else u2.data_ptr(),
                    0 if u2 is None else u2.stride(0),
                    d2.data_ptr(), d2.stride(0), dx.data_ptr(),
                    None if du is None else du.data_ptr(), x2.shape[0], cols,
                    _DTYPE_CODE[x.dtype], stream_of(x)), "silu_bwd")
    _silu.bwd_launches += 1
    return dx, du


class _Silu(torch.autograd.Function):
    """`silu(x, other, out_dtype)` under autograd, other None or in x's
    dtype and the output in x's dtype or float32; backward `silu_bwd` on
    the output gradient rounded to x's dtype."""

    @staticmethod
    def forward(ctx, x, other, out_dtype):
        ctx.save_for_backward(x, other)
        return _silu_forward(x, other, out_dtype)

    @staticmethod
    def backward(ctx, dy):
        x, other = ctx.saved_tensors
        dx, du = silu_bwd(x, other, dy.to(x.dtype))
        return dx, du, None


_silu = silu      # counts the launches: a patch of `silu` leaves it alone
silu.launches = 0
silu.bwd_launches = 0


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ), each product rounded to
    the operands' dtype."""
    return silu(x @ w_gate, x @ w_up) @ w_down
