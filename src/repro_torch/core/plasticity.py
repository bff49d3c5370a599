"""Four-term parametric synaptic plasticity rule (FireFly-P, Sec. II-A).

    dw_ij = alpha_ij * S_j * S_i + beta_ij * S_j + gamma_ij * S_i + delta_ij

with spike traces ``S(t) = lam * S(t-1) + s(t)``.  theta is ONE packed
``(4, n_pre, n_post)`` tensor, indexed by the constants below, so a kernel
fetches every coefficient plane of a synapse from one array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

# Indices into the packed theta tensor — keep in sync with the CUDA sources.
ALPHA, BETA, GAMMA, DELTA = 0, 1, 2, 3
NUM_TERMS = 4


@dataclasses.dataclass(frozen=True)
class PlasticityConfig:
    """Static configuration of the plasticity rule for one synaptic layer."""

    n_pre: int
    n_post: int
    trace_decay: float = 0.8          # lam in S(t) = lam S(t-1) + s(t)
    w_clip: Optional[float] = 4.0     # |w| clamp
    dtype: torch.dtype = torch.float32

    @property
    def theta_shape(self):
        """Per-synapse coefficients: one (n_pre, n_post) plane per term."""
        return (NUM_TERMS, self.n_pre, self.n_post)


def init_theta(cfg: PlasticityConfig, generator: torch.Generator,
               scale: float = 0.01) -> torch.Tensor:
    """Initial plasticity coefficients, drawn on the generator's device."""
    return (scale * torch.randn(cfg.theta_shape, generator=generator,
                                device=generator.device)).to(cfg.dtype)


def fma32(a, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``round_f32(a * b + c)`` with ONE rounding: an fp32 fused multiply-add
    emulated in float64 (the product of two fp32 values is exact there).

    XLA contracts ``a * b + c`` into an FMA when it compiles the JAX
    reference, so this is the form the port must evaluate to agree with it
    bit for bit; the CUDA kernels call ``__fmaf_rn`` at the same places.
    ``a`` may be a Python float, which is first rounded to fp32 as JAX's
    weak typing does.
    """
    if not isinstance(a, torch.Tensor):
        a = float(torch.tensor(a, dtype=torch.float32))
    else:
        a = a.double()
    return (a * b.double() + c.double()).float()


def delta_w(theta: torch.Tensor, s_pre: torch.Tensor,
            s_post: torch.Tensor) -> torch.Tensor:
    """The four-term rule: ``(n_pre, n_post)`` dw from packed ``(4, n_pre,
    n_post)`` (or scalar-rule ``(4,)``) coefficients and traces ``(n,)`` or
    ``(B, n)`` — batch-averaged when batched (a shared-weight batch).

    Evaluated as ``fma(g, post, fma(a, hebb, b * pre)) + d``, the form XLA
    contracts the reference's sum into under ``jax.jit``.
    """
    if s_pre.ndim == 1:
        s_pre, s_post = s_pre[None], s_post[None]
    b = s_pre.shape[0]
    sp, so, th = s_pre.float(), s_post.float(), theta.float()
    hebb = torch.einsum("bi,bj->ij", sp, so) / b
    inner = fma32(th[ALPHA], hebb, th[BETA] * sp.mean(0)[:, None])
    dw = fma32(th[GAMMA], so.mean(0)[None, :], inner) + th[DELTA]
    return dw.to(theta.dtype)


def apply_plasticity(w: torch.Tensor, theta: torch.Tensor,
                     s_pre: torch.Tensor, s_post: torch.Tensor,
                     cfg: PlasticityConfig) -> torch.Tensor:
    """``w <- clip(w + dw)``: one online plasticity step for one layer (the
    second pass of the unfused, forward-then-update baseline)."""
    w_new = w + delta_w(theta, s_pre, s_post).to(w.dtype)
    if cfg.w_clip is not None:
        w_new = torch.clamp(w_new, -cfg.w_clip, cfg.w_clip)
    return w_new


def update_trace(trace: torch.Tensor, spikes: torch.Tensor,
                 decay: float) -> torch.Tensor:
    """S(t) = lam * S(t-1) + s(t), contracted as the JAX reference is.

    The result keeps the trace's dtype.  In another dtype (bfloat16) lam is
    first rounded to that dtype, as JAX's weak typing of the Python scalar
    does, and the product and the sum each round to it, as the jitted JAX
    reference does."""
    s = spikes.to(trace.dtype)
    if trace.dtype == torch.float32:
        return fma32(decay, trace, s)
    lam = torch.tensor(decay, dtype=trace.dtype, device=trace.device)
    return lam * trace + s
