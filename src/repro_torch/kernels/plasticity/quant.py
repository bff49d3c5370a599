"""Fixed-point (FPGA-faithful) arithmetic for the dual-engine step.

Representation, as in the JAX reference:

  * weights — int8 ``w_q`` with a per-slot fp32 scale ``s``: ``w = w_q * s``
    (default scale ``2**-w_frac_bits``);
  * membrane and traces — int32 fixed point with ``frac_bits`` fractional
    bits; a spike is ``one = 2**frac_bits``; the readout event is
    ``clip(v, -one, one)``;
  * dw — fp32 from exact integer trace reductions, turned into whole int8
    grid steps by a deterministic stochastic round (`uniform_hash`).

Every helper here is bitwise equal to its counterpart in the JAX package
compiled with ``jax.jit``; the CUDA sources (``csrc/plasticity.cuh``) repeat
the same arithmetic.  The traps, each handled below: ``round`` is half to
even; the int32 right shifts are arithmetic; XLA contracts the dw sum into
fused multiply-adds (`dw_from_int_reductions`); the hash and `fold_seed`
rely on 32-bit wrap-around, computed here in int64 with explicit masks;
``dw / scale`` is an IEEE division.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.plasticity import ALPHA, BETA, DELTA, GAMMA, fma32

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Static fixed-point parameters.

    ``frac_bits``   — fractional bits of the int32 membrane/trace format.
    ``w_frac_bits`` — weight grid: default scale is ``2**-w_frac_bits``.
    ``trace_shift`` — power-of-two trace decay ``1 - 2**-trace_shift``.
    ``tau_shift``   — membrane time constant ``tau_m = 2**tau_shift``.
    ``stoch_round`` — deterministic stochastic rounding of dw to grid steps
                      (False = round-half-even).
    """

    frac_bits: int = 8
    w_frac_bits: int = 5
    trace_shift: int = 2
    tau_shift: int = 1
    stoch_round: bool = True

    def __post_init__(self):
        for name in ("frac_bits", "w_frac_bits", "trace_shift", "tau_shift"):
            v = getattr(self, name)
            if not (isinstance(v, int) and 0 <= v <= 24):
                raise ValueError(f"{name} must be an int in [0, 24], got {v!r}")

    @property
    def one(self) -> int:
        """Fixed-point 1.0 of the membrane/trace format."""
        return 1 << self.frac_bits

    @property
    def w_scale(self) -> float:
        """Default (power-of-two) weight scale."""
        return 2.0 ** -self.w_frac_bits

    @property
    def decay(self) -> float:
        """Effective trace decay ``1 - 2**-trace_shift``."""
        return 1.0 - 2.0 ** -self.trace_shift

    @property
    def tau_m(self) -> float:
        return float(1 << self.tau_shift)


# ---- fixed-point conversion (network boundary) -----------------------------

def to_fixed(x: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """float -> int32 fixed point (round half to even)."""
    return torch.round(x.float() * float(qc.one)).to(torch.int32)


def from_fixed(q: torch.Tensor, qc: QuantConfig) -> torch.Tensor:
    """int32 fixed point -> float32 (exact for |q| < 2**24)."""
    return q.float() * (2.0 ** -qc.frac_bits)


# ---- integer datapath -------------------------------------------------------

def thresholds_fx(qc: QuantConfig, v_th: float, v_reset: float):
    """Fixed-point threshold and reset, rounded as the reference rounds."""
    return int(round(v_th * qc.one)), int(round(v_reset * qc.one))


def neuron_update_q(v_fx, i_fx, qc: QuantConfig, v_th: float, v_reset: float,
                    spiking: bool):
    """Integer LIF / readout update.  Returns ``(event_fx, v_out_fx)``.

    ``v += (I - v) >> tau_shift`` (arithmetic shift); spiking layers hard
    reset and emit ``one``; the readout emits ``clip(v, -one, one)``.
    """
    one = qc.one
    vth_fx, vres_fx = thresholds_fx(qc, v_th, v_reset)
    v_new = v_fx + ((i_fx - v_fx) >> qc.tau_shift)
    if spiking:
        sp = v_new >= vth_fx
        event = torch.where(sp, one, 0).to(torch.int32)
        v_out = torch.where(sp, vres_fx, v_new).to(torch.int32)
    else:
        event = torch.clamp(v_new, -one, one)
        v_out = v_new
    return event, v_out


def trace_update_q(tp_fx, event_fx, qc: QuantConfig):
    """Integer trace decay + accumulate: ``tp - (tp >> k) + event``."""
    return tp_fx - (tp_fx >> qc.trace_shift) + event_fx


def current_fx(acc_i32, scale, qc: QuantConfig):
    """Integer psum accumulator -> membrane fixed point:
    ``round(acc * scale)`` (the units ``2**-frac_bits`` cancel)."""
    del qc
    return torch.round(acc_i32.float() * scale).to(torch.int32)


def dw_from_int_reductions(hebb_i32, pre_sum_i32, post_sum_i32, theta,
                           batch: int, qc: QuantConfig):
    """Four-term dw (fp32) from EXACT integer trace reductions.

    ``hebb (..., N, M)`` with ``pre (..., N)`` and ``post (..., M)``.  The sum
    is evaluated as ``fma(g, post, fma(a, hebb, b * pre)) + d``: the form XLA
    contracts the reference into under ``jax.jit`` (plain IEEE evaluation
    differs in the last bit on about a quarter of the elements, and such a
    bit can move a stochastic round onto the next grid step).
    """
    inv1 = float(torch.tensor(1.0 / (qc.one * batch), dtype=torch.float32))
    inv2 = float(torch.tensor(1.0 / (qc.one * qc.one * batch),
                              dtype=torch.float32))
    hebb = hebb_i32.float() * inv2
    pre_m = (pre_sum_i32.float() * inv1)[..., :, None]
    post_m = (post_sum_i32.float() * inv1)[..., None, :]
    th = theta.float()
    return fma_dw(th, hebb, pre_m, post_m)


def fma_dw(th, hebb, pre, post):
    """``fma(g, post, fma(a, hebb, b * pre)) + d`` on broadcastable fp32
    operands (`dw_from_int_reductions`; the float datapath uses it too)."""
    inner = fma32(th[ALPHA], hebb, th[BETA] * pre)
    return fma32(th[GAMMA], post, inner) + th[DELTA]


# ---- deterministic stochastic rounding -------------------------------------

def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """``(h * c) mod 2**32`` for int64 ``h`` in [0, 2**32): split in 16-bit
    halves so no intermediate leaves the int64 range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (h * lo + (((h * hi) & 0xFFFF) << 16)) & _M32


def _u32(x) -> torch.Tensor:
    """int tensor -> its two's-complement uint32 value, held in int64."""
    return torch.as_tensor(x).long() & _M32


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    x = x.long() & _M32
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def uniform_hash(seed, idx: torch.Tensor) -> torch.Tensor:
    """Counter-based uniform in [0, 1): avalanche hash of (seed, index).

    ``seed`` is the session's step counter (int32), ``idx`` the weight's flat
    index within its own (N, M) matrix, never the fleet slot."""
    h = _mul32(_u32(idx), 0x9E3779B1)
    s = (_u32(seed) + 0x7F4A7C15) & _M32
    h = h ^ _mul32(s, 0x85EBCA6B)
    h = h ^ (h >> 15)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 13)
    h = _mul32(h, 0x27D4EB2F)
    h = h ^ (h >> 16)
    return (h >> 8).float() * (2.0 ** -24)


def round_steps(steps_f32, seed, idx, qc: QuantConfig):
    """dw in units of the weight grid -> integer steps: stochastic round
    (round up with probability = fractional part), deterministic given
    (seed, index)."""
    if not qc.stoch_round:
        return torch.round(steps_f32).to(torch.int32)
    fl = torch.floor(steps_f32)
    frac = steps_f32 - fl
    return (fl + (frac > uniform_hash(seed, idx)).float()).to(torch.int32)


def qclip(w_clip: float, scale):
    """Largest admissible |w_q|: ``min(floor(w_clip / scale), 127)``."""
    w = torch.tensor(w_clip, dtype=torch.float32, device=scale.device)
    return torch.clamp(torch.floor(w / scale), max=127.0).to(torch.int32)


def fold_seed(seed, layer: int):
    """Per-layer seed ``seed * 1000003 + layer`` with int32 wrap-around."""
    return wrap_i32(torch.as_tensor(seed).long() * 1000003 + layer)
