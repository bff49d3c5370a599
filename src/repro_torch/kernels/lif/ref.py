"""Plain PyTorch Forward Engine (product + LIF + trace), no plasticity."""
from __future__ import annotations

import torch

from repro_torch.core.plasticity import fma32


def lif_forward(x, w, v, trace, *, tau_m: float = 2.0, v_th: float = 1.0,
                v_reset: float = 0.0, trace_decay: float = 0.8):
    """x (B,K), w (K,M), v (B,M), trace (B,M) ->
    (spikes (B,M), v_out (B,M), trace_new (B,M)), computed in float32 and
    returned in the operands' dtypes.

    ``(I - v) * (1 / tau_m)`` equals the reference's ``(I - v) / tau_m``
    for the power-of-two time constants the engine uses; the trace update
    is the fused multiply-add XLA contracts it into.
    """
    current = x.float() @ w.float()
    v32 = v.float()
    v_new = v32 + (current - v32) * (1.0 / tau_m)
    spikes = (v_new >= v_th).float()
    v_out = torch.where(spikes > 0, torch.full_like(v_new, v_reset), v_new)
    trace_new = fma32(trace_decay, trace.float(), spikes)
    return spikes.to(x.dtype), v_out.to(v.dtype), trace_new.to(trace.dtype)
