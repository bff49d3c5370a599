"""Common layers and the parameter-plan machinery.

A model is described by a PLAN: a tree of dicts and lists whose leaves are
`ParamDesc` (shape, init, dtype).  `init_from_plan` turns it into real
tensors drawn from a `torch.Generator`, `param_count` counts it.  The
JAX package's logical sharding specs are gone: the port runs on one card.

`rms_norm` and `rope` compute in float32 and cast back to the input's
dtype, as the JAX package does, so a bfloat16 model rounds at the same
places in both.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.config import torch_dtype


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


def init_from_plan(plan, generator: torch.Generator):
    """Real parameters on the generator's device, one draw per ``normal``
    leaf in `leaves` order: ``std = scale / sqrt(fan_in)`` with ``fan_in``
    defaulting to the second-to-last dim (the last for vectors)."""
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
        x = torch.randn(d.shape, generator=generator, device=dev)
        return x.mul_(std).to(dt)

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


def swiglu(x, w_gate, w_up, w_down):
    """SwiGLU MLP: down( silu(x@gate) * (x@up) ), each product rounded to
    the operands' dtype.  silu rounds once, where XLA's CPU expansion of
    ``jax.nn.silu`` rounds after each of its ops: in bfloat16 a few
    activations differ by one step."""
    g = F.silu(x @ w_gate)
    u = x @ w_up
    return (g * u) @ w_down
