"""Device-side fleet telemetry: the per-slot health vector and its schema.

The fused dual-engine kernels (per-step fleet step, float and fixed point;
the time-fused rollout window) optionally emit one extra reduced output per
slot — raw per-slot sums ``(B, 3) float32``:

    col 0   spike_sum   sum of |events| over the layer, in EVENT units
                        (spikes are 1.0; the fixed-point datapath's
                        0/``one`` events are divided by ``one`` so both
                        datapaths report in the same units)
    col 1   abs_dw_sum  sum of |dw| over the (N, M) synapse block, in
                        FLOAT weight units (int8 grid steps x w_scale on
                        the quantized path)
    col 2   sat_cnt     number of postsynaptic membranes with
                        |v| >= SAT_FRACTION * v_th after the update

Vacant slots (``active == 0``) report exact zeros: the raw row is gated by
the same mask that bit-freezes the slot's state, so telemetry never leaks a
frozen slot's stale membrane.

`engine.layer_step` / `engine.rollout` normalize the raw sums into a
`FleetTelemetry` of per-slot MEANS, comparable across layer widths, window
lengths and datapaths.  Telemetry is a static variant: ``telemetry=`` is a
Python bool that picks a kernel variant, and with it off the kernels compute
exactly what they compute without it.

`adapter_telemetry` is the LM adapter's health vector, recovered from its
cache before and after a decode step or window in plain PyTorch (the JAX
package computes it in XLA, not in a kernel): the LM pool's telemetry
variants run the kernels' telemetry-off instantiations.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# A membrane counts as "saturated" when |v| reaches this fraction of the
# firing threshold after the update: the pile-up region where the
# fixed-point datapath's int32 membrane grid loses headroom, below the reset
# discontinuity at v_th itself.
SAT_FRACTION = 0.9


def sat_threshold(v_th: float) -> float:
    """Float-datapath saturation threshold on |v|."""
    return SAT_FRACTION * float(v_th)


def sat_threshold_q(v_th: float, qcfg) -> int:
    """Fixed-point saturation threshold on the int32 membrane |v_fx|,
    rounded once on the host so the kernels and the plain versions compare
    against the same integer."""
    return int(round(SAT_FRACTION * float(v_th) * qcfg.one))


@dataclasses.dataclass(frozen=True)
class FleetTelemetry:
    """Per-slot fleet health vector — all fields ``(B,) float32``.

    spike_rate   mean |event| per postsynaptic neuron per step (0..1 for
                 spiking layers; mean |readout event| for the readout)
    mean_abs_dw  mean |dw| per synapse per step, float weight units; for a
                 window the NET motion |w_end - w_start| / (N*M) /
                 (K * n_plastic)
    sat_frac     fraction of postsynaptic membranes at >= SAT_FRACTION of
                 threshold after the step
    occupancy    the slot's active flag as 0.0/1.0

    Vacant slots report exact zeros in every field.
    """

    spike_rate: torch.Tensor
    mean_abs_dw: torch.Tensor
    sat_frac: torch.Tensor
    occupancy: torch.Tensor

    @staticmethod
    def zeros(batch: int, device=None) -> "FleetTelemetry":
        z = torch.zeros((batch,), dtype=torch.float32, device=device)
        return FleetTelemetry(spike_rate=z, mean_abs_dw=z, sat_frac=z,
                              occupancy=z)


def adapter_telemetry(before: dict, after: dict, active, *, qcfg=None,
                      trace_decay: float = 0.8,
                      v_th: float = 1.0) -> FleetTelemetry:
    """`FleetTelemetry` of the LM fast-weight adapter, from cache deltas.

    The adapter's decode step is one fleet layer step inside the decode
    path, so its three signals are recovered from the adapter cache (the
    `models.plastic.plan_cache` schema) before and after it:

      * spikes: the postsynaptic trace update is ``tr2' = decay * tr2 +
        s2`` (fixed point: ``tr2' = tr2 - (tr2 >> trace_shift) + ev``), so
        the events are ``tr2' - decay(tr2)``;
      * |dw|: the ``w_fast`` delta (times the per-slot ``w_scale`` on the
        int8 grid);
      * saturation: the postsynaptic membrane ``v2`` after the step.

    Everything is gated by ``active``: a frozen slot's unchanged trace
    would otherwise show a phantom event ``(1 - decay) * tr2``.  For a
    K-step window the caller divides spike_rate and mean_abs_dw by K (net
    weight motion and recovered event mass over the window).
    """
    act = torch.as_tensor(active).to(device=after["tr2"].device,
                                     dtype=torch.float32)
    n = before["tr2"].shape[-1]
    if qcfg is not None:
        tr2_b = before["tr2"]
        decayed = tr2_b - (tr2_b >> qcfg.trace_shift)
        s2 = (after["tr2"] - decayed).float() / qcfg.one
        dw = (after["w_fast"].to(torch.int32)
              - before["w_fast"].to(torch.int32))
        abs_dw = dw.abs().float() * before["w_scale"][:, None, None]
        sat = after["v2"].abs() >= sat_threshold_q(v_th, qcfg)
    else:
        s2 = after["tr2"] - trace_decay * before["tr2"]
        abs_dw = (after["w_fast"] - before["w_fast"]).abs()
        sat = after["v2"].abs() >= sat_threshold(v_th)
    spike_rate = s2.abs().mean(dim=-1).float()
    mean_abs_dw = (abs_dw.sum(dim=(-2, -1)) / (n * n)).float()
    sat_frac = sat.float().mean(dim=-1)
    return FleetTelemetry(spike_rate=spike_rate * act,
                          mean_abs_dw=mean_abs_dw * act,
                          sat_frac=sat_frac * act, occupancy=act)


def record_fleet_telemetry(registry, tel: FleetTelemetry,
                           prefix: str = "fleet") -> dict:
    """Fold a `FleetTelemetry` into host gauges (one transfer).

    Gauges are occupancy-weighted means over ACTIVE slots — vacant slots'
    mandated zeros must not dilute the fleet's numbers:

        {prefix}_spike_rate   {prefix}_mean_abs_dw
        {prefix}_sat_frac     {prefix}_occupancy (fraction of slots active)

    Returns the scalar values as a dict.
    """
    rows = torch.stack([tel.spike_rate, tel.mean_abs_dw, tel.sat_frac,
                        tel.occupancy]).cpu().numpy().astype(np.float64)
    occ = rows[3]
    n_active = float(occ.sum())
    b = max(1, occ.shape[0])

    def active_mean(x) -> float:
        return 0.0 if n_active == 0 else float(x.sum() / n_active)

    vals = {
        f"{prefix}_spike_rate": active_mean(rows[0]),
        f"{prefix}_mean_abs_dw": active_mean(rows[1]),
        f"{prefix}_sat_frac": active_mean(rows[2]),
        f"{prefix}_occupancy": n_active / b,
    }
    help_text = {
        f"{prefix}_spike_rate": "mean |event|/neuron/step over active slots",
        f"{prefix}_mean_abs_dw": "mean |dw|/synapse/step over active slots",
        f"{prefix}_sat_frac": "fraction of membranes near threshold",
        f"{prefix}_occupancy": "fraction of pool slots active",
    }
    for name, v in vals.items():
        registry.gauge(name, help_text[name]).set(v)
    return vals
