"""Learning-rate schedules as step -> lr callables.

``step`` is an int tensor (the optimizer's 0-d step counter, on the card
with the parameters) or a Python int; the lr comes back as a 0-d float32
tensor on the step's device, so that reading it needs no host sync.

The arithmetic is what the JAX package's schedules compile to under
``jax.jit``: XLA turns each division by a constant step count into a
product with its float32 reciprocal, and LLVM contracts the cosine's
``0.45 (1 + cos) + 0.1`` into a fused multiply-add.  The cosine itself is
float64's rounded to float32, which differs from XLA's own float32 cosine
in its last bit on ~1% of the arguments.
"""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def _recip(n: int) -> float:
    """float32 1 / n (correctly rounded), the constant XLA multiplies by
    where the JAX package divides by n."""
    return float(torch.tensor(1.0) / torch.tensor(float(n)))


def constant(lr: float):
    return lambda step: torch.full((), lr, dtype=torch.float32,
                                   device=torch.as_tensor(step).device)


def linear_warmup(lr: float, warmup_steps: int):
    def fn(step):
        s = _f32(step)
        return lr * torch.clamp_max((s + 1) * _recip(max(warmup_steps, 1)),
                                    1.0)
    return fn


def warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                  final_frac: float = 0.1):
    """Linear warmup then cosine decay to final_frac * lr."""
    def fn(step):
        s = _f32(step)
        warm = lr * torch.clamp_max((s + 1) * _recip(max(warmup_steps, 1)),
                                    1.0)
        t = torch.clamp((s - warmup_steps)
                        * _recip(max(total_steps - warmup_steps, 1)),
                        0.0, 1.0)
        c = torch.cos((math.pi * t).double()).float() + 1
        # final_frac + (1 - final_frac) * 0.5 * (1 + cos), one rounding
        frac = torch.tensor((1 - final_frac) * 0.5, dtype=torch.float32)
        cos = (c.double() * frac.double() + torch.tensor(
            final_frac, dtype=torch.float32).double()).float()
        return torch.where(s < warmup_steps, warm, lr * cos)
    return fn
