"""PlasticEngine: the fused layer step and the fused rollout window.

One `layer_step` = one SNN timestep for ONE synaptic layer: the Forward
Engine (psum, neuron dynamics, trace update) and the Plasticity Engine
(four-term dw, weights rewritten) as a single fused program.  `rollout` runs
K such timesteps over the whole layer stack as one launch.

Two modes, selected by the weight rank:

  * FLEET (``w (B, N, M)``): every request stream owns its synapses, with a
    per-sample dw under one shared rule theta;
  * SHARED weights (``w (N, M)``) with unbatched ``(N,)`` or batched
    ``(B, N)`` activations: one matrix, batch-averaged dw (online MNIST).
    Unbatched state is promoted to B = 1 for the kernels and squeezed back.

The backend follows the tensors' device: a CUDA tensor launches the
hand-written kernels (kernels/plasticity/kernel.py, fused.py) and a CPU
tensor runs their plain versions.

Fleet mode accepts an ``active (B,)`` slot mask: streams whose flag is
false are frozen bit for bit — weights, membrane and traces unchanged,
events zero — so a fixed-shape slot pool never drifts in its vacant slots.

Fleet mode also takes ``telemetry=True``: the kernels' telemetry variants
return per-slot sums beside the state, normalized here into an
`obs.FleetTelemetry` third result (vacant slots report zeros).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from repro_torch.kernels.plasticity import fused as _fused
from repro_torch.kernels.plasticity import kernel as _kernel
from repro_torch.kernels.plasticity.quant import QuantConfig
from repro_torch.obs.telemetry import FleetTelemetry


@dataclasses.dataclass
class LayerState:
    """State one layer step reads and rewrites.

    ``trace_pre`` is the already-updated presynaptic trace of this timestep;
    ``trace_post`` the previous timestep's postsynaptic trace, which
    `layer_step` advances.  ``theta`` is the packed ``(4, N, M)`` rule (None
    for a non-plastic layer).  A leading stream rank on ``w`` selects FLEET
    mode.
    """

    w: torch.Tensor                         # (N, M) | (B, N, M)
    v: torch.Tensor                         # (M,) | (B, M)
    trace_pre: torch.Tensor                 # (N,) | (B, N)
    trace_post: torch.Tensor                # (M,) | (B, M)
    theta: Optional[torch.Tensor] = None    # (4, N, M)
    w_scale: Optional[torch.Tensor] = None  # () | (B,) int8 weight scale


@dataclasses.dataclass
class NetworkState:
    """Whole-network state: per-layer weights and membranes, per-population
    traces (``trace[i]`` is layer i's presynaptic population, ``trace[0]``
    the input drive's), the timestep ``t`` (0-d int32) and, in fixed-point
    mode only, per-layer int8 weight scales (``()`` in float mode)."""

    w: Tuple[torch.Tensor, ...]
    v: Tuple[torch.Tensor, ...]
    trace: Tuple[torch.Tensor, ...]
    t: torch.Tensor
    w_scale: Tuple[torch.Tensor, ...] = ()

    @property
    def num_layers(self) -> int:
        return len(self.w)

    def layer(self, i: int, theta=None) -> LayerState:
        """View layer i as a LayerState (traces must be current-timestep)."""
        return LayerState(w=self.w[i], v=self.v[i], trace_pre=self.trace[i],
                          trace_post=self.trace[i + 1], theta=theta,
                          w_scale=self.w_scale[i] if self.w_scale else None)


@dataclasses.dataclass(frozen=True)
class EngineParams:
    """Static per-layer parameters of the fused step."""

    tau_m: float = 2.0
    v_th: float = 1.0
    v_reset: float = 0.0
    trace_decay: float = 0.8
    w_clip: float = 4.0
    plastic: bool = True
    spiking: bool = True        # False => leaky readout (event = tanh(V))
    quant: Optional[QuantConfig] = None  # fixed-point mode (None = float)


def _check_quant_params(p: EngineParams, qc: QuantConfig) -> None:
    """The fixed-point datapath implements power-of-two dynamics; float
    params that silently disagree would compare the wrong things."""
    if p.tau_m != qc.tau_m:
        raise ValueError(
            f"quant mode implements tau_m = 2**tau_shift = {qc.tau_m}; "
            f"set EngineParams.tau_m to match (got {p.tau_m})")
    if abs(p.trace_decay - qc.decay) > 1e-9:
        raise ValueError(
            f"quant mode implements trace_decay = 1 - 2**-trace_shift "
            f"= {qc.decay}; set EngineParams.trace_decay to match "
            f"(got {p.trace_decay})")


def _check_dtypes(checks, what: str) -> None:
    for name, arr, want in checks:
        if arr.dtype != want:
            raise ValueError(
                f"{what} needs {name} of dtype {want} (build state with "
                f"snn.init_state on a quant config; quantize drive/teach with "
                f"kernels.plasticity.quant.to_fixed); got {arr.dtype}")


def _occupancy(active, b: int, device) -> torch.Tensor:
    """The active mask as 0.0/1.0 float32 (all ones without one)."""
    if active is None:
        return torch.ones((b,), dtype=torch.float32, device=device)
    return active.reshape(-1).float()


_TELEMETRY_FLEET_ONLY = ("telemetry is a fleet-mode (w (B, N, M)) contract: "
                         "per-slot rows need a leading stream rank")


def layer_step(state: LayerState, x: torch.Tensor, *,
               params: EngineParams = EngineParams(),
               teach: Optional[torch.Tensor] = None,
               active: Optional[torch.Tensor] = None,
               seed: Optional[torch.Tensor] = None,
               telemetry: bool = False):
    """One fused forward+plasticity step for one layer.

    Args:
      state:  layer state (not modified; a new state is returned).  ``w`` of
              rank 3 ``(B, N, M)`` selects FLEET mode.
      x:      presynaptic events ``(N,)`` or ``(B, N)``.
      params: static engine parameters.
      teach:  optional teaching current added to the psum ``(M,)``/``(B, M)``.
      active: optional fleet-only ``(B,)`` slot mask; inactive streams are
              true no-ops (state bit-identical, events zero).
      seed:   fixed-point mode — the step counter of the stochastic round
              (scalar, or ``(B,)`` per-session counters in fleet mode).
      telemetry: fleet only — also return an `obs.FleetTelemetry` of
              per-slot means (the kernels' telemetry variant).

    Returns ``(new_state, out)``: out is the layer's events for spiking
    layers, the membrane for the leaky readout; with ``telemetry``,
    ``(new_state, out, FleetTelemetry)``.
    """
    plastic = params.plastic and state.theta is not None
    qc = params.quant
    if qc is not None:
        _check_quant_params(params, qc)
        checks = [("w", state.w, torch.int8), ("x", x, torch.int32),
                  ("v", state.v, torch.int32),
                  ("trace_pre", state.trace_pre, torch.int32),
                  ("trace_post", state.trace_post, torch.int32)]
        if teach is not None:
            checks.append(("teach", teach, torch.int32))
        _check_dtypes(checks, "quant mode")
        kw = dict(qcfg=qc, v_th=params.v_th, v_reset=params.v_reset,
                  w_clip=params.w_clip, plastic=plastic,
                  spiking=params.spiking, seed=seed)
    else:
        kw = dict(tau_m=params.tau_m, v_th=params.v_th,
                  v_reset=params.v_reset, trace_decay=params.trace_decay,
                  w_clip=params.w_clip, plastic=plastic,
                  spiking=params.spiking)

    fleet = state.w.ndim == 3
    if fleet:
        b, n, m = state.w.shape
        if x.ndim != 2 or x.shape[0] != b:
            raise ValueError(
                f"fleet mode needs x of shape (B, N) matching w (B, N, M); "
                f"got x {tuple(x.shape)} vs w {tuple(state.w.shape)}")
        # an unbatched (M,) membrane or trace would silently broadcast ONE
        # user's state across every stream
        for name, arr, want in (("v", state.v, (b, m)),
                                ("trace_pre", state.trace_pre, (b, n)),
                                ("trace_post", state.trace_post, (b, m))):
            if tuple(arr.shape) != want:
                raise ValueError(
                    f"fleet mode needs {name} of shape {want} matching "
                    f"w (B, N, M) = {tuple(state.w.shape)}; got {name} "
                    f"{tuple(arr.shape)}")
        if active is not None and tuple(active.shape) != (b,):
            raise ValueError(
                f"active slot mask must have shape (B,) = ({b},); got "
                f"{tuple(active.shape)}")
        kw["active"] = active
    elif active is not None:
        raise ValueError(
            "active slot masks are a fleet-mode (w (B, N, M)) contract; "
            f"got w {tuple(state.w.shape)} with an active mask")
    if telemetry:
        if not fleet:
            raise ValueError(f"{_TELEMETRY_FLEET_ONLY}; got w "
                             f"{tuple(state.w.shape)}")
        kw["telemetry"] = True

    # the kernels are rank-(B, N): promote unbatched shared state to B = 1
    unbatched = not fleet and x.ndim == 1
    up = (lambda a: a[None]) if unbatched else (lambda a: a)
    state_args = (up(state.v), up(state.trace_pre), up(state.trace_post))
    if qc is not None:
        scale = state.w_scale if state.w_scale is not None else qc.w_scale
        args = (up(x), state.w, scale, state.theta, *state_args)
        fn = _kernel.fleet_step_q if fleet else _kernel.shared_step_q
    else:
        args = (up(x), state.w, state.theta, *state_args)
        fn = _kernel.fleet_step if fleet else _kernel.shared_step
    res = fn(*args, teach=None if teach is None else up(teach), **kw)
    spikes, v, tpost, w = res[:4]
    if unbatched:
        spikes, v, tpost = spikes[0], v[0], tpost[0]

    new_state = dataclasses.replace(state, w=w, v=v, trace_post=tpost)
    out = spikes if params.spiking else v
    if active is not None and not params.spiking:
        # the readout's output IS the membrane; inactive slots still emit
        # zero events
        out = torch.where(active.bool()[:, None], out, torch.zeros_like(out))
    if not telemetry:
        return new_state, out
    # the raw per-slot sums as per-neuron / per-synapse means
    b, n, m = state.w.shape
    raw = res[4]
    tel = FleetTelemetry(spike_rate=raw[:, 0] / m,
                         mean_abs_dw=raw[:, 1] / (n * m),
                         sat_frac=raw[:, 2] / m,
                         occupancy=_occupancy(active, b, x.device))
    return new_state, out, tel


def _validate_rollout_params(params) -> None:
    """Rollout params must agree on everything a fused window shares
    (dynamics scalars + datapath); only spiking/plastic may vary by layer."""
    p0 = params[0]
    for i, p in enumerate(params):
        for f in ("tau_m", "v_th", "v_reset", "trace_decay", "w_clip",
                  "quant"):
            if getattr(p, f) != getattr(p0, f):
                raise ValueError(
                    f"rollout fuses all layers into one window and needs "
                    f"uniform EngineParams.{f}; layer {i} has "
                    f"{getattr(p, f)!r} vs layer 0's {getattr(p0, f)!r}")


def rollout(state: NetworkState, theta, drives: torch.Tensor, *,
            params, teach: Optional[torch.Tensor] = None,
            active: Optional[torch.Tensor] = None,
            seed: Optional[torch.Tensor] = None,
            block_b: Optional[int] = None, telemetry: bool = False):
    """K fused timesteps of the WHOLE layer stack (one kernel launch).

    The time-fused analogue of calling `layer_step` K * num_layers times,
    with the same bits in fixed-point mode.

    Args:
      state:  `NetworkState` — a fleet pool (B, N, M), or shared weights
              (N, M) with unbatched or batched activations.
      theta:  per-layer packed (4, N_i, M_i) rules (None where non-plastic).
      drives: time-major input window (K, N0) or (K, B, N0); int32 fixed
              point with a QuantConfig, float otherwise.
      params: per-layer `EngineParams` (or one for every layer); they must
              agree on the dynamics scalars and quant mode.
      teach:  optional teaching current for the LAST layer: rank equal to
              the drives' is a per-step window, one less a held signal.
      active: fleet-only (B,) slot mask, constant across the window.
      seed:   fixed-point mode — base step counter (scalar or (B,)); step
              k draws from ``fold_seed(seed + k, layer)``.  Defaults to
              ``state.t``.
      block_b: fleet only — the rollout kernel's tile, the streams one
              CTA holds at once (`fused.fleet_plan`); None takes the
              largest tile of at most 8 that fits (`fused.fleet_fit`),
              and raises where not even one stream fits.
      telemetry: fleet only — also return an `obs.FleetTelemetry` of
              per-slot WINDOW means: spike_rate and sat_frac averaged over
              the K steps and the layers, mean_abs_dw the NET weight motion
              ``|w_end - w_start| / (N*M) / (K * n_plastic)``.

    Returns ``(new_state, outs)`` with outs (K, ·, M_last) and
    ``new_state.t = state.t + K``; with ``telemetry``,
    ``(new_state, outs, FleetTelemetry)``.
    """
    if isinstance(params, EngineParams):
        params = [params] * state.num_layers
    params = list(params)
    if len(params) != state.num_layers:
        raise ValueError(f"need one EngineParams per layer "
                         f"({state.num_layers}), got {len(params)}")
    _validate_rollout_params(params)
    theta = list(theta)
    if len(theta) != state.num_layers:
        raise ValueError(f"need one theta entry per layer "
                         f"({state.num_layers}; None for non-plastic), "
                         f"got {len(theta)}")
    qc = params[0].quant
    fleet = state.w[0].ndim == 3
    if drives.ndim not in (2, 3):
        raise ValueError(f"drives must be (K, N0) or (K, B, N0); got "
                         f"{tuple(drives.shape)}")
    if fleet and drives.ndim != 3:
        raise ValueError(f"fleet rollout needs drives (K, B, N0); got "
                         f"{tuple(drives.shape)}")
    if active is not None and not fleet:
        raise ValueError("active slot masks are a fleet-mode contract")
    if telemetry and not fleet:
        raise ValueError(_TELEMETRY_FLEET_ONLY)
    k_steps = drives.shape[0]
    if k_steps < 1:
        raise ValueError("rollout needs K >= 1 timesteps")
    if fleet:
        b = state.w[0].shape[0]
        if drives.shape[1] != b:
            raise ValueError(f"fleet rollout needs drives (K, B, N0) with "
                             f"B = {b}; got {tuple(drives.shape)}")
        if active is not None and tuple(active.shape) != (b,):
            raise ValueError(f"active slot mask must have shape ({b},); "
                             f"got {tuple(active.shape)}")
    if qc is not None:
        _check_quant_params(params[0], qc)
        checks = [("w", state.w[0], torch.int8),
                  ("drives", drives, torch.int32),
                  ("v", state.v[0], torch.int32),
                  ("trace", state.trace[0], torch.int32)]
        if teach is not None:
            checks.append(("teach", teach, torch.int32))
        _check_dtypes(checks, "quant rollout")
    if teach is not None:
        if teach.ndim == drives.ndim - 1:
            teach = teach[None].expand(k_steps, *teach.shape)
        elif teach.ndim != drives.ndim:
            raise ValueError(
                f"teach must be per-step (K, ..., M) of rank {drives.ndim} "
                f"or held of rank {drives.ndim - 1}; got "
                f"{tuple(teach.shape)}")

    plastic = [p.plastic and theta[i] is not None
               for i, p in enumerate(params)]
    p0 = params[0]
    kw = dict(spiking=[p.spiking for p in params], plastic=plastic,
              tau_m=p0.tau_m, v_th=p0.v_th, v_reset=p0.v_reset,
              trace_decay=p0.trace_decay, w_clip=p0.w_clip, qcfg=qc,
              teach=teach, active=active, telemetry=telemetry)
    if qc is not None:
        kw["scales"] = [state.w_scale[i] if state.w_scale
                        else torch.tensor(qc.w_scale, dtype=torch.float32,
                                          device=drives.device)
                        for i in range(state.num_layers)]
        kw["seed"] = (torch.as_tensor(seed, dtype=torch.int32,
                                      device=drives.device)
                      if seed is not None else state.t.to(torch.int32))
    thetas = [theta[i] if plastic[i] else None
              for i in range(state.num_layers)]
    # the kernels are rank-(B, ·): promote unbatched shared state to B = 1
    unbatched = not fleet and drives.ndim == 2
    up = (lambda a: a[None]) if unbatched else (lambda a: a)
    up_t = (lambda a: a[:, None]) if unbatched else (lambda a: a)
    if teach is not None:
        kw["teach"] = up_t(teach)
    res = _fused.rollout(
        up_t(drives), state.w, thetas, tuple(up(a) for a in state.v),
        tuple(up(a) for a in state.trace), block_b=block_b, **kw)
    outs, w, v, tr = res[:4]
    if unbatched:
        outs = outs[:, 0]
        v = tuple(a[0] for a in v)
        tr = tuple(a[0] for a in tr)
    new_state = dataclasses.replace(state, w=w, v=v, trace=tr,
                                    t=state.t + k_steps)
    if not telemetry:
        return new_state, outs
    raw = res[4]                       # finalized and gated (B, 3)
    tel = FleetTelemetry(spike_rate=raw[:, 0], mean_abs_dw=raw[:, 1],
                         sat_frac=raw[:, 2],
                         occupancy=_occupancy(active, raw.shape[0],
                                              drives.device))
    return new_state, outs, tel


# ---- sharded fleet dispatch (multi-device slot pools) ----------------------


def fleet_spmd(fn, mesh, in_axes, out_axes, axis_name: str = "data"):
    """Run a fleet-mode function once per shard of ``mesh``.

    The fleet tensors are slot-major and slot rows are independent, so a
    pool of B slots on D shards is pure data parallelism: each shard runs
    the SAME function, the same kernels, on its B/D slot rows, and no
    shard reads another's.  The JAX package lowers this as ``shard_map``
    (`src/repro/core/engine.py` `fleet_spmd`); here one process drives the
    shards in turn, each launch on its shard's device, and nothing is
    concatenated or copied between shards.

    Args:
      fn:       positional-argument function over fleet trees.
      mesh:     a `distributed.sharding.FleetMesh` (`fleet_mesh`).
      in_axes:  one entry per positional argument: an int, the slot axis
                every leaf of that argument carries (0 for ``(B, ...)``
                state, 1 for time-major ``(K, B, ...)`` windows), a tree of
                them matching the argument, or None for a replicated input
                (scalars, the shared rule), which every shard receives on
                its own device.  A slot-mapped leaf is a
                `distributed.sharding.Sharded` (its piece) or a whole
                tensor (its block of rows, moved to the shard's device).
      out_axes: the same per output; every output must be slot-mapped: a
                replicated output has no one shard to come from, so compute
                pool-global outputs outside the wrapped call (ValueError
                otherwise).

    Returns a function of the same arguments whose outputs are trees of
    `Sharded` leaves (None stays None).
    """
    from repro_torch.checkpoint import manager as _ckpt
    from repro_torch.distributed import sharding as _sh

    if axis_name not in mesh.axis_names:
        raise ValueError(f"fleet_spmd maps over mesh axis {axis_name!r}; "
                         f"the mesh has {mesh.axis_names}")
    for ax in out_axes:
        if ax is None or any(a is None for a in _ckpt.flatten(ax)[1]):
            raise ValueError(
                "fleet_spmd outputs must be slot-mapped (int axis); "
                "compute replicated outputs outside the wrapped fn")

    def per_leaf(tree, ax):
        """``tree``'s leaves beside their axes (``ax`` an int, None or a
        tree of them)."""
        leaves = _ckpt.flatten(tree)[1]
        if isinstance(ax, int) or ax is None:
            return leaves, [ax] * len(leaves)
        return leaves, _ckpt.flatten(ax)[1]

    def run(*args):
        if len(args) != len(in_axes):
            raise ValueError(f"fleet_spmd: {len(args)} arguments for "
                             f"{len(in_axes)} in_axes")
        outs = []
        for d in range(mesh.size):
            local = []
            for a, ax in zip(args, in_axes):
                leaves, axes = per_leaf(a, ax)
                local.append(_ckpt.unflatten(a, [
                    _sh.local(x, xa, d, mesh)
                    for x, xa in zip(leaves, axes)]))
            out = fn(*local)
            outs.append(out if isinstance(out, tuple) else (out,))
        if any(len(o) != len(out_axes) for o in outs):
            raise ValueError(f"fleet_spmd: {len(outs[0])} outputs for "
                             f"{len(out_axes)} out_axes")
        result = []
        for i, ax in enumerate(out_axes):
            shards = [per_leaf(o[i], ax) for o in outs]
            leaves, axes = shards[0]
            result.append(_ckpt.unflatten(outs[0][i], [
                _sh.Sharded([s[0][j] for s in shards], axes[j])
                for j in range(len(leaves))]))
        return tuple(result)

    return run
