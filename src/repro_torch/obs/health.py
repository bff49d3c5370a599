"""Streaming anomaly detectors over the flight-recorder channels.

Session health is evaluated on the device, in the same recorded pool step
that produced the telemetry (`obs.recorder`; the schedulers' ``record=``
variants): the verdict is a function of fixed-shape ``(B, ...)`` detector
state, so a recorded pool step makes no host sync.  The host reads the
latched verdict only when it decides to act (quarantine, rollback:
`serving.scheduler.SessionPool.remediate`).

Four detectors, one hysteresis streak each (a detector must fire
``hysteresis[d]`` consecutive recorded steps to flag):

  ewma_z   |x - EWMA mean| / sqrt(EWMA var + z_floor^2) > z_threshold on
           any channel, after ``warmup`` recorded steps.  The baseline
           update is winsorized (see `health_update`).
  bound    any channel outside its absolute ``bounds`` corridor.
  stuck    the whole channel vector within ``stuck_eps`` of the previous
           recorded step's (after warmup); the default eps of 0.0 means
           bitwise frozen.
  dead     spike rate (channel 0) below ``dead_floor`` after warmup.

Flags latch (``HealthState.flagged`` is sticky per detector); the scheduler
clears a slot's rows on admit, evict and rollback.  Inactive slots are
gated: their channels arrive as exact zeros, no detector fires, streaks
reset, the baseline holds bit for bit.

This module is the plain version, in the JAX package's order of operations;
on the card the fused recorder kernel (`obs.recorder.record_step`,
``csrc/recorder.cu``) computes the same in one launch.
"""
from __future__ import annotations

import dataclasses

import torch

# Channel schema of the flight-recorder ring (obs/recorder.py): the three
# FleetTelemetry signals plus the weight-norm drift vs admission snapshot.
CHANNELS = ("spike_rate", "mean_abs_dw", "sat_frac", "wnorm_drift")

# Detector order: indexes `HealthConfig.hysteresis`, `HealthState.streaks`
# and `HealthState.flagged` columns.
DETECTORS = ("ewma_z", "bound", "stuck", "dead")


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    """Static detector configuration.

    window     ring length W of the flight recorder (steps of history kept
               per slot for post-mortem dumps; the detectors stream and do
               not re-scan the ring).
    ewma_alpha EWMA smoothing for the per-channel mean/variance baseline.
    z_threshold / z_floor
               ewma_z fires when |x - mean| exceeds z_threshold *
               sqrt(var + z_floor^2); the floor stops a near-constant
               channel's vanishing variance from turning numeric jitter
               into infinite z-scores (0.03 in channel units: an 8-neuron
               layer's spike rate moves in 1/8 steps).
    warmup     recorded steps before ewma_z / stuck / dead may fire.
    bounds     per-channel (lo, hi) absolute corridor, `CHANNELS` order.
    stuck_eps  max per-channel move still counting as "unchanged".
    dead_floor spike-rate floor for the dead-session detector.
    hysteresis per-detector consecutive-fire count before flagging,
               `DETECTORS` order.
    """

    window: int = 64
    ewma_alpha: float = 0.2
    z_threshold: float = 6.0
    z_floor: float = 0.03
    warmup: int = 8
    bounds: tuple = ((0.0, 8.0), (0.0, 4.0), (0.0, 1.01), (0.0, 64.0))
    stuck_eps: float = 0.0
    dead_floor: float = 1e-5
    hysteresis: tuple = (3, 3, 8, 8)

    def __post_init__(self):
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if len(self.bounds) != len(CHANNELS):
            raise ValueError(
                f"bounds needs one (lo, hi) per channel {CHANNELS}, got "
                f"{len(self.bounds)}")
        if len(self.hysteresis) != len(DETECTORS):
            raise ValueError(
                f"hysteresis needs one entry per detector {DETECTORS}, "
                f"got {len(self.hysteresis)}")
        if any(h < 1 for h in self.hysteresis):
            raise ValueError(f"hysteresis entries must be >= 1, got "
                             f"{self.hysteresis}")


@dataclasses.dataclass(frozen=True)
class HealthState:
    """Per-slot streaming detector state, every leaf slot-major ``(B, ...)``.

    ewma_mean / ewma_var   per-channel EWMA baseline ``(B, C) float32``
    last                   previous recorded channel vector ``(B, C)``
    streaks                consecutive-fire counts ``(B, D) int32``
    flagged                latched per-detector flags ``(B, D) bool``
    steps                  recorded (active) steps since reset ``(B,) int32``
    """

    ewma_mean: torch.Tensor
    ewma_var: torch.Tensor
    last: torch.Tensor
    streaks: torch.Tensor
    flagged: torch.Tensor
    steps: torch.Tensor


def init_health(cfg: HealthConfig, slots: int, device=None) -> HealthState:
    """Zero detector state for ``slots`` slots; ``device=None`` is the
    card."""
    from repro_torch.core.snn import resolve_device
    device = resolve_device(device)
    c, d = len(CHANNELS), len(DETECTORS)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)
    return HealthState(ewma_mean=z(slots, c), ewma_var=z(slots, c),
                       last=z(slots, c),
                       streaks=z(slots, d, dtype=torch.int32),
                       flagged=z(slots, d, dtype=torch.bool),
                       steps=z(slots, dtype=torch.int32))


def health_update(cfg: HealthConfig, h: HealthState, x: torch.Tensor,
                  active) -> tuple:
    """One streaming detector step: ``(new_state, verdict (B,) bool)``.

    `x` is the recorded channel vector ``(B, C) float32`` (already gated to
    exact zeros on inactive slots); `active` the pool's ``(B,)`` mask.
    Detection runs against the baseline from before the update, and the
    baseline update is winsorized: once warm, the deviation is clipped per
    channel to ±z_threshold·sigma, so a sustained fault cannot drag the
    mean under itself within a hysteresis streak while a recurring clean
    burst re-teaches the variance.  Samples that fire `bound` never teach.
    """
    act = torch.as_tensor(active, device=x.device).bool()
    x = x.to(torch.float32)
    warm = h.steps >= cfg.warmup

    # ewma_z: z-score vs the slot's own running baseline
    z = (x - h.ewma_mean).abs() / torch.sqrt(h.ewma_var + cfg.z_floor ** 2)
    fire_z = warm & (z > cfg.z_threshold).any(dim=-1)

    # bound: the absolute deployment corridor
    lo = torch.tensor([b[0] for b in cfg.bounds], dtype=torch.float32,
                      device=x.device)
    hi = torch.tensor([b[1] for b in cfg.bounds], dtype=torch.float32,
                      device=x.device)
    fire_bound = ((x < lo) | (x > hi)).any(dim=-1)

    # stuck: the whole channel vector stopped moving
    fire_stuck = warm & ((x - h.last).abs() <= cfg.stuck_eps).all(dim=-1)

    # dead: spike collapse
    fire_dead = warm & (x[:, CHANNELS.index("spike_rate")] < cfg.dead_floor)

    fires = torch.stack([fire_z, fire_bound, fire_stuck, fire_dead],
                        dim=-1) & act[:, None]
    streaks = torch.where(fires, h.streaks + 1, 0).to(torch.int32)
    hyst = torch.tensor(cfg.hysteresis, dtype=torch.int32, device=x.device)
    flagged = h.flagged | (streaks >= hyst)

    # baseline update: inactive slots hold their state bit for bit;
    # out-of-corridor samples never teach; once warm the deviation is
    # winsorized per channel to ±z_threshold·sigma
    gate = act[:, None]
    learn = (act & ~fire_bound)[:, None]
    d = x - h.ewma_mean
    cap = cfg.z_threshold * torch.sqrt(h.ewma_var + cfg.z_floor ** 2)
    d = torch.where(warm[:, None], torch.clamp(d, -cap, cap), d)
    a = cfg.ewma_alpha
    new = HealthState(
        ewma_mean=torch.where(learn, h.ewma_mean + a * d, h.ewma_mean),
        ewma_var=torch.where(learn, (1.0 - a) * (h.ewma_var + a * d * d),
                             h.ewma_var),
        last=torch.where(gate, x, h.last),
        streaks=streaks,
        flagged=flagged,
        steps=h.steps + act.to(torch.int32))
    return new, flagged.any(dim=-1)
