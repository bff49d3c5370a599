"""LIF spiking network with online plasticity (FireFly-P forward engine).

The network is a generic N-layer stack stepped through the PlasticEngine
(`core.engine`): every layer timestep — psum, neuron dynamics, trace update
AND the four-term plasticity update — is one fused program.

  * psum stage:     I(t) = W^T s_in(t)
  * neuron stage:   V(t) = V(t-1) + (I - V(t-1))/tau_m,  tau_m = 2
                    s(t) = V(t) >= V_th ; hard reset on spike
  * trace stage:    S(t) = lam S(t-1) + s(t)

Within a timestep layer L's plasticity consumes the CURRENT timestep's
traces while layer L+1's forward pass consumes layer L's fresh spikes.

`timestep` is the per-event path (one step kernel per layer);
`rollout_window`, `controller_step` and `classify_window` run a whole window
of timesteps as one rollout-kernel launch, with the same bits in fixed-point
mode.  Rate encoding draws its Bernoulli spike trains from a
`torch.Generator`, which the caller passes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from repro_torch.core import engine
from repro_torch.core import plasticity as P
from repro_torch.core.engine import NetworkState
from repro_torch.kernels.plasticity import quant as Q
from repro_torch.kernels.plasticity.quant import QuantConfig
from repro_torch.obs.telemetry import FleetTelemetry
from repro_torch.optim.compression import compress_int8


@dataclasses.dataclass(frozen=True)
class LIFConfig:
    tau_m: float = 2.0        # paper: tau_m = 2 -> multiplier-free on FPGA
    v_threshold: float = 1.0
    v_reset: float = 0.0      # hard reset


def lif_step(v: torch.Tensor, current: torch.Tensor,
             cfg: LIFConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """One elementwise LIF update.  Returns (v_new, spikes)."""
    v = v + (current.to(v.dtype) - v) * (1.0 / cfg.tau_m)
    spikes = (v >= cfg.v_threshold).to(v.dtype)
    v = torch.where(spikes > 0, torch.full_like(v, cfg.v_reset), v)
    return v, spikes


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    """Fully-connected plastic controller (paper Sec. IV-A).

    layer_sizes = (obs_dim, *hidden..., act_dim).  ``quant`` switches the
    whole network onto the fixed-point datapath (use `quant_config` for a
    consistent pair of decay and time constant).  ``block_b`` is the number
    of fleet streams one CTA of the rollout kernel holds for a window.
    """
    layer_sizes: Sequence[int] = (16, 128, 8)
    timesteps: int = 4                      # SNN timesteps per control step
    trace_decay: float = 0.8
    lif: LIFConfig = LIFConfig()
    encoding: str = "current"               # "current" | "rate"
    spiking_readout: bool = False           # True for classification
    w_clip: float = 4.0
    dtype: torch.dtype = torch.float32
    plastic: bool = True                    # False => fixed-weight SNN
    quant: Optional[QuantConfig] = None     # fixed-point mode (None = float32)
    block_b: int = 8                        # rollout-kernel streams per CTA

    @property
    def num_layers(self) -> int:
        return len(self.layer_sizes) - 1

    def layer_plasticity_cfg(self, i: int) -> P.PlasticityConfig:
        return P.PlasticityConfig(
            n_pre=self.layer_sizes[i], n_post=self.layer_sizes[i + 1],
            trace_decay=self.trace_decay, w_clip=self.w_clip, dtype=self.dtype)

    def engine_params(self, i: int) -> engine.EngineParams:
        """Static PlasticEngine parameters for layer i."""
        last = i == self.num_layers - 1
        return engine.EngineParams(
            tau_m=self.lif.tau_m, v_th=self.lif.v_threshold,
            v_reset=self.lif.v_reset, trace_decay=self.trace_decay,
            w_clip=self.w_clip, plastic=self.plastic,
            spiking=(not last) or self.spiking_readout, quant=self.quant)


def quant_config(base: Optional[SNNConfig] = None,
                 qc: Optional[QuantConfig] = None, **overrides) -> SNNConfig:
    """An `SNNConfig` consistently switched onto the fixed-point datapath:
    sets ``quant`` and snaps ``trace_decay``/``lif.tau_m`` to the power-of-two
    dynamics the hardware implements."""
    base = SNNConfig() if base is None else base
    qc = QuantConfig() if qc is None else qc
    return dataclasses.replace(
        base, quant=qc, trace_decay=qc.decay,
        lif=dataclasses.replace(base.lif, tau_m=qc.tau_m), **overrides)


def resolve_device(device=None) -> torch.device:
    """``None`` means the card.  Raises where no card is present instead of
    handing back CPU tensors."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    return device


def init_state(cfg: SNNConfig, batch: Optional[int] = None,
               fleet: bool = False, device=None) -> NetworkState:
    """Network state: per-layer membranes, per-population traces, weights.

    Deployment starts from ZERO weights (paper Sec. II-B): the rule, not the
    initialization, builds the connectivity.  ``batch`` batches membranes
    and traces over B streams with shared weights; ``fleet=True`` gives
    every stream its OWN weights ``(B, N, M)``.  ``device=None`` is the card.
    """
    if fleet and batch is None:
        raise ValueError("fleet=True requires batch (one weight set per "
                         "request stream)")
    device = resolve_device(device)
    qc = cfg.quant
    w_dtype = torch.int8 if qc is not None else cfg.dtype
    s_dtype = torch.int32 if qc is not None else cfg.dtype

    def z(*shape, dtype=s_dtype, batched=batch is not None):
        s = (batch, *shape) if batched else shape
        return torch.zeros(s, dtype=dtype, device=device)

    sizes = cfg.layer_sizes
    if qc is None:
        w_scale = ()
    elif fleet:
        # per-SLOT weight scale: travels with the session
        w_scale = tuple(torch.full((batch,), qc.w_scale, dtype=torch.float32,
                                   device=device)
                        for _ in range(cfg.num_layers))
    else:
        w_scale = tuple(torch.tensor(qc.w_scale, dtype=torch.float32,
                                     device=device)
                        for _ in range(cfg.num_layers))
    return NetworkState(
        w=tuple(z(sizes[i], sizes[i + 1], dtype=w_dtype, batched=fleet)
                for i in range(cfg.num_layers)),
        v=tuple(z(sizes[i + 1]) for i in range(cfg.num_layers)),
        trace=tuple(z(sizes[i]) for i in range(len(sizes))),
        t=torch.zeros((), dtype=torch.int32, device=device),
        w_scale=w_scale)


def init_theta(cfg: SNNConfig, generator: torch.Generator,
               scale: float = 0.01):
    """Per-layer initial rules, drawn on the generator's device."""
    return [P.init_theta(cfg.layer_plasticity_cfg(i), generator, scale)
            for i in range(cfg.num_layers)]


def flatten_theta(theta) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in theta])


def unflatten_theta(cfg: SNNConfig, flat: torch.Tensor):
    out, off = [], 0
    for i in range(cfg.num_layers):
        shape = (P.NUM_TERMS, cfg.layer_sizes[i], cfg.layer_sizes[i + 1])
        n = shape[0] * shape[1] * shape[2]
        out.append(flat[off:off + n].reshape(shape).to(cfg.dtype))
        off += n
    return out


def quantize_state(cfg: SNNConfig, state: NetworkState) -> NetworkState:
    """A float `NetworkState` moved onto the fixed-point representation:
    weights onto the int8 grid ``2**-w_frac_bits`` (`compress_int8` with
    that FIXED scale, one per slot for a fleet pool), membranes and traces
    to int32 fixed point.  Lossy by exactly one rounding."""
    qc = cfg.quant
    if qc is None:
        raise ValueError("quantize_state needs cfg.quant set (see "
                         "snn.quant_config)")
    w_q, scales = [], []
    for w in state.w:
        q, s = compress_int8(w, scale=qc.w_scale)
        w_q.append(q)
        scales.append(s.expand(w.shape[0]).clone() if w.ndim == 3 else s)
    return NetworkState(
        w=tuple(w_q), v=tuple(Q.to_fixed(v, qc) for v in state.v),
        trace=tuple(Q.to_fixed(tr, qc) for tr in state.trace),
        t=state.t, w_scale=tuple(scales))


def _check_encode_key(cfg: SNNConfig, generator) -> None:
    """Stochastic rate encoding needs a generator to draw from."""
    if cfg.encoding == "rate" and generator is None:
        raise ValueError(
            'encoding="rate" draws Bernoulli spike trains and requires a '
            "torch.Generator; pass generator=torch.Generator(device)"
            ".manual_seed(...) to this call (or use encoding=\"current\" "
            "for deterministic analog drive)")


def encode(cfg: SNNConfig, obs: torch.Tensor,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Observation -> input drive for one timestep: the analog current, or
    with rate encoding ``sign(obs)`` spikes with probability
    ``clip(|obs|, 0, 1)``, drawn from ``generator``."""
    if cfg.encoding == "rate":
        _check_encode_key(cfg, generator)
        p = torch.clamp(obs.abs(), 0.0, 1.0)
        u = torch.rand(obs.shape, generator=generator,
                       device=generator.device)
        return (u < p).to(cfg.dtype) * torch.sign(obs).to(cfg.dtype)
    return obs.to(cfg.dtype)


def encode_window(cfg: SNNConfig, obs: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  k: Optional[int] = None) -> torch.Tensor:
    """A held observation as a time-major (K, ...) drive window: exactly the
    draws K successive `encode` calls would make."""
    k = cfg.timesteps if k is None else k
    if cfg.encoding == "rate":
        return torch.stack([encode(cfg, obs, generator) for _ in range(k)])
    return encode(cfg, obs)[None].expand(k, *obs.shape)


def timestep(cfg: SNNConfig, state: NetworkState, theta,
             drive: torch.Tensor, teach: Optional[torch.Tensor] = None,
             active: Optional[torch.Tensor] = None,
             seed: Optional[torch.Tensor] = None,
             telemetry: bool = False):
    """One SNN timestep: every layer through `engine.layer_step`.

    `teach` drives the OUTPUT layer; `active` (fleet only) freezes inactive
    streams bit-exactly through every layer, the input trace included;
    `seed` (fixed point) is the stochastic-round step counter, scalar or
    (B,) per session, defaulting to ``state.t``.  In fixed-point mode
    `drive`/`teach` are floats quantized here and the output is dequantized,
    so callers are representation-agnostic.

    `telemetry` (fleet only): also return a network-level
    `obs.FleetTelemetry` — the layers' telemetry averaged over the layers
    (spike rate and saturation over all, |dw| zero for a frozen network).
    """
    qc = cfg.quant
    w, v, tr = list(state.w), list(state.v), list(state.trace)
    if qc is not None:
        x = Q.to_fixed(drive, qc)
        teach = None if teach is None else Q.to_fixed(teach, qc)
        base_seed = (torch.as_tensor(seed, dtype=torch.int32,
                                     device=x.device)
                     if seed is not None else state.t.to(torch.int32))
        tr0_new = Q.trace_update_q(tr[0], x, qc)
    else:
        x = drive
        base_seed = None
        tr0_new = P.update_trace(tr[0], x, cfg.trace_decay)
    if active is not None:
        tr0_new = torch.where(active.bool()[:, None], tr0_new, tr[0])
    tr[0] = tr0_new
    out = None
    tels = []
    for i in range(cfg.num_layers):
        last = i == cfg.num_layers - 1
        layer = engine.LayerState(
            w=w[i], v=v[i], trace_pre=tr[i], trace_post=tr[i + 1],
            theta=theta[i] if cfg.plastic else None,
            w_scale=state.w_scale[i] if state.w_scale else None)
        res = engine.layer_step(
            layer, x, params=cfg.engine_params(i),
            teach=teach if last else None, active=active,
            seed=None if base_seed is None else Q.fold_seed(base_seed, i),
            telemetry=telemetry)
        layer, out = res[0], res[1]
        if telemetry:
            tels.append(res[2])
        w[i], v[i], tr[i + 1] = layer.w, layer.v, layer.trace_post
        x = out
    if qc is not None:
        out = Q.from_fixed(out, qc)
    new_state = NetworkState(w=tuple(w), v=tuple(v), trace=tuple(tr),
                             t=state.t + 1, w_scale=state.w_scale)
    if not telemetry:
        return new_state, out
    nl = float(cfg.num_layers)
    tel = FleetTelemetry(
        spike_rate=sum(t.spike_rate for t in tels) / nl,
        mean_abs_dw=(sum(t.mean_abs_dw for t in tels) / nl if cfg.plastic
                     else torch.zeros_like(tels[0].spike_rate)),
        sat_frac=sum(t.sat_frac for t in tels) / nl,
        occupancy=tels[0].occupancy)
    return new_state, out, tel


def rollout_window(cfg: SNNConfig, state: NetworkState, theta,
                   drives: torch.Tensor,
                   teach: Optional[torch.Tensor] = None,
                   active: Optional[torch.Tensor] = None,
                   seed: Optional[torch.Tensor] = None,
                   telemetry: bool = False):
    """K SNN timesteps as ONE fused engine launch (`engine.rollout`).

    ``drives`` is time-major (K, N_in) or (K, B, N_in), already encoded.
    `teach`/`active`/`seed`/`telemetry` follow `timestep` (``teach`` held or
    per-step; telemetry as window means, a third result).  In fixed-point
    mode drives/teach are quantized here and the outputs dequantized.
    """
    qc = cfg.quant
    if qc is not None:
        drives = Q.to_fixed(drives, qc)
        teach = None if teach is None else Q.to_fixed(teach, qc)
    params = [cfg.engine_params(i) for i in range(cfg.num_layers)]
    th = [theta[i] if cfg.plastic else None for i in range(cfg.num_layers)]
    res = engine.rollout(
        state, th, drives, params=params, teach=teach, active=active,
        seed=seed, block_b=cfg.block_b, telemetry=telemetry)
    state, outs = res[0], res[1]
    if qc is not None:
        outs = Q.from_fixed(outs, qc)
    return (state, outs) + tuple(res[2:])


def controller_step(cfg: SNNConfig, state: NetworkState, theta,
                    obs: torch.Tensor,
                    generator: Optional[torch.Generator] = None
                    ) -> tuple[NetworkState, torch.Tensor]:
    """One control step = cfg.timesteps SNN timesteps on a held observation,
    as one `rollout_window` launch.  Returns (state, action) with action =
    the mean readout over the window (tanh-squashed for a leaky readout)."""
    _check_encode_key(cfg, generator)
    drives = encode_window(cfg, obs, generator)
    state, outs = rollout_window(cfg, state, theta, drives)
    action = outs.mean(dim=0)
    if not cfg.spiking_readout:
        action = torch.tanh(action)
    return state, action


def classify_window(cfg: SNNConfig, state: NetworkState, theta,
                    x: torch.Tensor,
                    generator: Optional[torch.Generator] = None,
                    teach: Optional[torch.Tensor] = None
                    ) -> tuple[NetworkState, torch.Tensor]:
    """Present x for cfg.timesteps; return (state, class scores = readout
    counts summed over the window).

    With `teach` (e.g. ``label_onehot * amplitude``) the output population
    is driven toward the labelled class during the window, so the rule
    performs supervised online learning.  One `rollout_window` launch with
    the teaching current held across it."""
    _check_encode_key(cfg, generator)
    drives = encode_window(cfg, x, generator)
    state, outs = rollout_window(cfg, state, theta, drives, teach=teach)
    return state, outs.sum(dim=0)
