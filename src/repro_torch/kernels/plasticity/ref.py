"""Plain PyTorch versions of the fused dual-engine step (forward + plasticity).

Semantics of one SNN timestep for one synaptic layer:

    I        = x @ w (+ teach)             # psum stage (Forward Engine)
    v_new    = v + (I - v) * (1/tau_m)     # neuron dynamics
    spiking:   s = v_new >= v_th ; v_out = v_reset where s else v_new
    readout:   s = tanh(v_new)   ; v_out = v_new
    tp_new   = lam * trace_post + s        # trace update
    dw       = a*hebb + b*pre + g*post + d # Plasticity Engine (4 terms)
    w_new    = clip(w + dw, -clip, clip)

The FLEET functions carry a leading stream rank on the weights ``(B, N, M)``:
every stream rewrites its own synapses with a per-sample dw under one shared
rule theta.  The JAX reference writes them as ``vmap`` of the unbatched step;
here the batch dimension is explicit.  These functions are the plain version
every fleet kernel is held against, and what a CPU tensor runs.

The SHARED-weight functions (one ``(N, M)`` matrix, batch-averaged dw) are
the plain versions of the shared-step kernels (``csrc/shared_step.cu``).
Every integer reduction here is an exact int32 broadcast-and-sum, never an
integer matrix product: PyTorch has no integer ``matmul`` on CUDA tensors,
and the plain versions run on the card beside their kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core.plasticity import fma32
from repro_torch.kernels.plasticity import quant as Q


def _forward(current, v, trace_post, *, tau_m, v_th, v_reset, trace_decay,
             spiking):
    v32 = v.float()
    v_new = v32 + (current - v32) * (1.0 / tau_m)
    if spiking:
        spikes = (v_new >= v_th).float()
        v_out = torch.where(spikes > 0, torch.full_like(v_new, v_reset), v_new)
    else:
        spikes = torch.tanh(v_new)
        v_out = v_new
    return spikes, v_out, fma32(trace_decay, trace_post.float(), spikes)


def _gate(active, events, v_out, tp_new, w_new, v, trace_post, w):
    """Select the OLD state wholesale for inactive streams (computed, then
    selected), so a vacant slot is frozen bit for bit."""
    if active is None:
        return events, v_out, tp_new, w_new
    a = active.reshape(-1).bool()
    if a.shape[0] != events.shape[0]:
        raise ValueError(f"active mask {tuple(active.shape)} does not match "
                         f"B = {events.shape[0]}")
    a2 = a[:, None]
    return (torch.where(a2, events, torch.zeros_like(events)),
            torch.where(a2, v_out, v.to(v_out.dtype)),
            torch.where(a2, tp_new, trace_post.to(tp_new.dtype)),
            torch.where(a[:, None, None], w_new, w.to(w_new.dtype)))


def dual_engine_step(x, w, theta, v, trace_pre, trace_post, *,
                     tau_m: float = 2.0, v_th: float = 1.0,
                     v_reset: float = 0.0, trace_decay: float = 0.8,
                     w_clip: float = 4.0, plastic: bool = True,
                     spiking: bool = True, teach=None):
    """Shared-weight step: x (B,N)|(N,), w (N,M), batch-averaged dw."""
    current = x.float() @ w.float()
    if teach is not None:
        current = current + teach.float()
    spikes, v_out, tp_new = _forward(
        current, v, trace_post, tau_m=tau_m, v_th=v_th, v_reset=v_reset,
        trace_decay=trace_decay, spiking=spiking)
    if plastic:
        tpre, tpo = trace_pre.float(), tp_new
        if tpre.ndim == 1:
            tpre, tpo = tpre[None], tpo[None]
        b = tpre.shape[0]
        hebb = tpre.T @ tpo / b
        dw = Q.fma_dw(theta.float(), hebb, tpre.mean(0)[:, None],
                      tpo.mean(0)[None, :])
        w_new = torch.clamp(w.float() + dw, -w_clip, w_clip)
    else:
        w_new = w.float()
    return (spikes.to(x.dtype), v_out.to(v.dtype),
            tp_new.to(trace_post.dtype), w_new.to(w.dtype))


def dual_engine_fleet_step(x, w, theta, v, trace_pre, trace_post, *,
                           tau_m: float = 2.0, v_th: float = 1.0,
                           v_reset: float = 0.0, trace_decay: float = 0.8,
                           w_clip: float = 4.0, plastic: bool = True,
                           spiking: bool = True, teach=None, active=None):
    """Fleet step: x (B,N), w (B,N,M), theta (4,N,M) shared, v (B,M),
    traces (B,·), teach (B,M)|(M,)|None, active (B,)|None.

    Returns (events, v_out, trace_post_new, w_new); inactive streams come
    back bit-identical with zero events.
    """
    current = torch.bmm(x.float()[:, None, :], w.float())[:, 0]   # psum
    if teach is not None:
        current = current + teach.float()          # (M,) broadcasts
    spikes, v_out, tp_new = _forward(
        current, v, trace_post, tau_m=tau_m, v_th=v_th, v_reset=v_reset,
        trace_decay=trace_decay, spiking=spiking)
    w32 = w.float()
    if plastic:
        tpre = trace_pre.float()[:, :, None]
        tpo = tp_new[:, None, :]
        dw = Q.fma_dw(theta.float(), tpre * tpo, tpre, tpo)
        w_new = torch.clamp(w32 + dw, -w_clip, w_clip)
    else:
        w_new = w32
    out = (spikes.to(x.dtype), v_out.to(v.dtype),
           tp_new.to(trace_post.dtype), w_new.to(w.dtype))
    return _gate(active, *out, v, trace_post, w)


# ---- fixed-point datapath ---------------------------------------------------

def _flat_idx(n: int, m: int, device) -> torch.Tensor:
    """Flat ``row * M + col`` index of an (N, M) matrix (the hash counter)."""
    return (torch.arange(n, device=device)[:, None] * m
            + torch.arange(m, device=device)[None, :])


def dual_engine_step_q(x, w, scale, theta, v, trace_pre, trace_post, *,
                       qcfg: Q.QuantConfig, v_th: float = 1.0,
                       v_reset: float = 0.0, w_clip: float = 4.0,
                       plastic: bool = True, spiking: bool = True,
                       teach=None, seed=None):
    """Shared-weight fixed-point step: x (B,N)|(N,) int32, w (N,M) int8,
    scale () f32, seed () int32."""
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    seed = torch.as_tensor(0 if seed is None else seed, dtype=torch.int32,
                           device=x.device)
    x32, w32 = x.to(torch.int32), w.to(torch.int32)
    acc = (x32[..., :, None] * w32).sum(-2, dtype=torch.int32)   # exact psum
    i_fx = Q.current_fx(acc, scale, qcfg)
    if teach is not None:
        i_fx = i_fx + teach.to(torch.int32)
    events, v_out = Q.neuron_update_q(v.to(torch.int32), i_fx, qcfg, v_th,
                                      v_reset, spiking)
    tp_new = Q.trace_update_q(trace_post.to(torch.int32), events, qcfg)
    if plastic:
        tpre, tpo = trace_pre.to(torch.int32), tp_new
        if tpre.ndim == 1:
            tpre, tpo = tpre[None], tpo[None]
        b = tpre.shape[0]
        hebb_i = (tpre[:, :, None] * tpo[:, None, :]).sum(
            0, dtype=torch.int32)                          # exact tpre^T tpo
        dw = Q.dw_from_int_reductions(hebb_i, tpre.sum(0, dtype=torch.int32),
                                      tpo.sum(0, dtype=torch.int32), theta,
                                      b, qcfg)
        n, m = w.shape
        steps = Q.round_steps(dw / scale, seed, _flat_idx(n, m, x.device),
                              qcfg)
        qmax = Q.qclip(w_clip, scale)
        w_new = torch.clamp(w32 + steps, -qmax, qmax).to(torch.int8)
    else:
        w_new = w
    return events, v_out, tp_new, w_new


def dual_engine_fleet_step_q(x, w, scale, theta, v, trace_pre, trace_post, *,
                             qcfg: Q.QuantConfig, v_th: float = 1.0,
                             v_reset: float = 0.0, w_clip: float = 4.0,
                             plastic: bool = True, spiking: bool = True,
                             teach=None, seed=None, active=None):
    """Fixed-point fleet step: x (B,N) int32, w (B,N,M) int8, scale (B,)|()
    f32 per slot, theta (4,N,M) f32 shared, v/traces (B,·) int32, seed
    (B,)|() int32 per-session step counters, active (B,)|None.

    Every reduction is an exact integer reduction and every float operation
    elementwise, so the CUDA kernel matches this function bit for bit.
    """
    b, n, m = w.shape
    dev = x.device
    scale = torch.as_tensor(scale, dtype=torch.float32, device=dev)
    scale = scale.expand(b) if scale.ndim == 0 else scale
    seed = torch.as_tensor(0 if seed is None else seed, dtype=torch.int32,
                           device=dev)
    seed = seed.expand(b) if seed.ndim == 0 else seed
    x32, w32 = x.to(torch.int32), w.to(torch.int32)
    acc = (x32[:, :, None] * w32).sum(1, dtype=torch.int32)   # exact psum
    i_fx = Q.current_fx(acc, scale[:, None], qcfg)
    if teach is not None:
        i_fx = i_fx + teach.to(torch.int32)
    events, v_out = Q.neuron_update_q(v.to(torch.int32), i_fx, qcfg, v_th,
                                      v_reset, spiking)
    tp_new = Q.trace_update_q(trace_post.to(torch.int32), events, qcfg)
    if plastic:
        tpre = trace_pre.to(torch.int32)
        hebb_i = tpre[:, :, None] * tp_new[:, None, :]        # exact outer
        dw = Q.dw_from_int_reductions(hebb_i, tpre, tp_new, theta, 1, qcfg)
        sc = scale[:, None, None]
        steps = Q.round_steps(dw / sc, seed[:, None, None],
                              _flat_idx(n, m, dev), qcfg)
        qmax = Q.qclip(w_clip, sc)
        w_new = torch.clamp(w32 + steps, -qmax, qmax).to(torch.int8)
    else:
        w_new = w
    return _gate(active, events, v_out, tp_new, w_new, v, trace_post, w)
