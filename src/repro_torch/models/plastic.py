"""Plastic fast-weight adapter: FireFly-P's rule as an LM serving feature.

A two-population spiking micro-network rides on the backbone's hidden state
during DECODE.  Per decode step, per request stream:

    drive   = h @ P_in                  (fixed random projection, D -> N)
    s1      = LIF(v1, drive)            (presynaptic population)
    s2, W_fast <- engine.layer_step(s1) (fused forward + rule, fleet mode)
    h'      = h + scale * (s2 @ P_out)  (readout back into the residual)

The synaptic layer is ONE fleet-mode `core.engine.layer_step` over the
batch: ``W_fast (B, N, N)`` holds one plastic memory per stream, so a CUDA
tensor launches the fleet-step kernel once per decode step
(``csrc/fleet_step.cu``: `fleet_step` in float32, `fleet_step_q` with
``cfg.adapter_quant``).  W_fast starts at zero and lives in the decode
cache; theta is the frozen rule.

``cfg.adapter_quant`` is the fixed-point datapath: int8 W_fast with a
per-slot scale, int32 membranes and traces, and dw rounded to grid steps by
the deterministic stochastic round keyed on the per-stream step counter
``t``.  The presynaptic population stays float; ``to_fixed(s1)`` is exact
since spikes are 0/1.  ``active (B,)`` freezes vacant slots bit for bit.

`decode_rollout` is the K-token form: the presynaptic LIF series is peeled
token by token, then the synaptic layer's K steps run as ONE fleet rollout
launch (``csrc/rollout.cu``, `engine.rollout`) at the largest tile its plan
fits on the card (`fused.fleet_fit`).
"""
from __future__ import annotations

import torch

from repro_torch.core import engine
from repro_torch.core import plasticity as P
from repro_torch.core.snn import LIFConfig, lif_step
from repro_torch.kernels.plasticity import quant as Q
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamDesc

LIF = LIFConfig(tau_m=2.0, v_threshold=1.0, v_reset=0.0)
# The adapter's fixed-point grid (cfg.adapter_quant): tau_m = 2**1 matches
# LIF.tau_m, trace decay 0.75, int8 weights on a 2**-5 grid.
QUANT = Q.QuantConfig()


def plan(cfg: ModelConfig) -> dict:
    d, n = cfg.d_model, cfg.adapter_neurons
    return {
        "p_in": ParamDesc((d, n), fan_in=d, dtype=cfg.dtype),
        "p_out": ParamDesc((n, d), fan_in=n, dtype=cfg.dtype),
        "theta": ParamDesc((P.NUM_TERMS, n, n), scale=0.3, fan_in=n,
                           dtype="float32"),
        "scale": ParamDesc((), init="zeros", dtype="float32"),
    }


def plan_cache(cfg: ModelConfig, batch: int) -> dict:
    """Per-stream adapter state (one row per stream); ``t`` is the
    per-stream step counter that seeds the fixed-point stochastic round."""
    n = cfg.adapter_neurons
    sdt = "int32" if cfg.adapter_quant else "float32"

    def z(shape, dtype="float32"):
        return ParamDesc(shape, init="zeros", dtype=dtype)

    out = {
        "w_fast": z((batch, n, n), "int8" if cfg.adapter_quant
                    else "float32"),
        "v1": z((batch, n)),                      # presyn: always float32
        "v2": z((batch, n), sdt),
        "tr1": z((batch, n), sdt),
        "tr2": z((batch, n), sdt),
        "t": z((batch,), "int32"),
    }
    if cfg.adapter_quant:
        out["w_scale"] = ParamDesc((batch,), init="full",
                                   scale=QUANT.w_scale, dtype="float32")
    return out


def _engine_params(cfg: ModelConfig, trace_decay: float, w_clip: float
                   ) -> engine.EngineParams:
    if cfg.adapter_quant:
        return engine.EngineParams(
            tau_m=QUANT.tau_m, v_th=LIF.v_threshold, v_reset=LIF.v_reset,
            trace_decay=QUANT.decay, w_clip=w_clip, plastic=True,
            spiking=True, quant=QUANT)
    return engine.EngineParams(
        tau_m=LIF.tau_m, v_th=LIF.v_threshold, v_reset=LIF.v_reset,
        trace_decay=trace_decay, w_clip=w_clip, plastic=True, spiking=True)


def _gate(active, new, old):
    """Freeze per-slot rows whose active flag is false (bit-exact no-op)."""
    if active is None:
        return new
    mask = active.to(torch.bool).reshape((-1,) + (1,) * (new.ndim - 1))
    return torch.where(mask, new, old)


def decode_step(params, state: dict, h, cfg: ModelConfig,
                trace_decay: float = 0.8, w_clip: float = 4.0,
                active=None):
    """h (B,1,D) -> (h', new_state).  One online plasticity step per token."""
    quant = cfg.adapter_quant
    drive = h[:, 0].float() @ params["p_in"].float()
    v1, s1 = lif_step(state["v1"], drive, LIF)
    v1 = _gate(active, v1, state["v1"])
    if quant:
        x = Q.to_fixed(s1, QUANT)                  # exact: spikes are 0/1
        tr1 = Q.trace_update_q(state["tr1"], x, QUANT)
    else:
        x = s1
        tr1 = P.update_trace(state["tr1"], s1, trace_decay)
    tr1 = _gate(active, tr1, state["tr1"])

    layer = engine.LayerState(
        w=state["w_fast"], v=state["v2"], trace_pre=tr1,
        trace_post=state["tr2"], theta=params["theta"].float(),
        w_scale=state.get("w_scale"))
    layer, s2 = engine.layer_step(
        layer, x, params=_engine_params(cfg, trace_decay, w_clip),
        active=active, seed=Q.fold_seed(state["t"], 0) if quant else None)

    s2f = Q.from_fixed(s2, QUANT) if quant else s2
    out = s2f @ params["p_out"].float()
    if active is not None:
        out = out * active.float()[:, None]
    h = h + (params["scale"] * out[:, None, :]).to(h.dtype)
    step = (torch.ones_like(state["t"]) if active is None
            else (active != 0).to(torch.int32))
    new_state = {"w_fast": layer.w, "v1": v1, "v2": layer.v,
                 "tr1": tr1, "tr2": layer.trace_post,
                 "t": state["t"] + step}
    if quant:
        new_state["w_scale"] = state["w_scale"]
    return h, new_state


def decode_rollout(params, state: dict, h, cfg: ModelConfig,
                   trace_decay: float = 0.8, w_clip: float = 4.0,
                   active=None):
    """h (B, K, D) -> (h', new_state).  K plasticity steps, ONE launch.

    The multi-token form of K `decode_step` calls.  The presynaptic
    population is feedforward (v1 and s1 depend only on the tokens), so
    its LIF series runs first, token by token with the step's own
    products; the synaptic layer's K steps then run as one
    `engine.rollout` over ``NetworkState(w=(w_fast,), v=(v2,),
    trace=(tr1, tr2))``, which on the card is one launch of the fleet
    window kernel at the largest tile that fits (its plan kept in
    ``fused.rollout.last_plan``; where not even one stream fits it
    raises).  In fixed point step k draws its stochastic
    round from the per-stream counter ``t + k``, as K steps would: the
    int8 state equals theirs bit for bit.  ``active (B,)`` freezes vacant
    slots."""
    quant = cfg.adapter_quant
    p_in, p_out = params["p_in"].float(), params["p_out"].float()
    k_steps = h.shape[1]
    v1, s1s = state["v1"], []
    for k in range(k_steps):
        v1_new, s1 = lif_step(v1, h[:, k].float() @ p_in, LIF)
        v1 = _gate(active, v1_new, v1)
        s1s.append(s1)
    s1_series = torch.stack(s1s)                          # (K, B, N)
    net = engine.NetworkState(
        w=(state["w_fast"],), v=(state["v2"],),
        trace=(state["tr1"], state["tr2"]),
        t=torch.zeros((), dtype=torch.int32, device=h.device),
        w_scale=(state["w_scale"],) if quant else ())
    net, s2_series = engine.rollout(
        net, [params["theta"].float()],
        Q.to_fixed(s1_series, QUANT) if quant else s1_series,
        params=_engine_params(cfg, trace_decay, w_clip), active=active,
        seed=state["t"] if quant else None)
    outs = []
    for k in range(k_steps):
        s2 = s2_series[k]
        outs.append((Q.from_fixed(s2, QUANT) if quant else s2) @ p_out)
    out = torch.stack(outs, dim=1)                        # (B, K, D)
    if active is not None:
        out = out * active.float()[:, None, None]
    h = h + (params["scale"] * out).to(h.dtype)
    step = (torch.full_like(state["t"], k_steps) if active is None
            else (active != 0).to(torch.int32) * k_steps)
    new_state = {"w_fast": net.w[0], "v1": v1, "v2": net.v[0],
                 "tr1": net.trace[0], "tr2": net.trace[1],
                 "t": state["t"] + step}
    if quant:
        new_state["w_scale"] = state["w_scale"]
    return h, new_state

