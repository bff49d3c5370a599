"""Dual-engine steps: wrappers of the CUDA kernels and their plain versions.

One call = one SNN timestep of one synaptic layer — the Forward Engine
(psum, neuron, trace) and the Plasticity Engine (four-term dw, weights
rewritten) fused in one launch.

  * `fleet_step`    — B request streams, each with its own weights
                      ``(B, N, M)`` under one shared rule theta; float32;
                      kernel ``csrc/fleet_step.cu`` ``fleet_step_f32``.
  * `fleet_step_q`  — the same on the fixed-point datapath (int8 weights,
                      int32 membranes and traces); ``fleet_step_q``.
  * `shared_step`   — B activation rows sharing ONE weight matrix
                      ``(N, M)``, batch-averaged dw; float32; kernel
                      ``csrc/shared_step.cu`` ``shared_step_f32``.
  * `shared_step_q` — its fixed-point twin; ``shared_step_q``.

The fixed-point kernels are bit for bit equal to their plain versions.

``telemetry=True`` on the fleet steps launches the kernels' telemetry
variant and appends the raw (B, 3) float32 per-slot row of
`ref._fleet_telemetry_raw` to the four outputs.

The backend follows the tensors: a CPU tensor takes the plain version
(``ref.dual_engine_fleet_step[_q]``), a CUDA tensor launches the kernel, and
anything else raises.  Each wrapper counts its kernel launches in
``<wrapper>.launches``, and the fleet steps those of their telemetry variant
also in ``<wrapper>.telemetry_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.plasticity import quant as Q
from repro_torch.kernels.plasticity import ref as _ref
from repro_torch.obs.telemetry import sat_threshold, sat_threshold_q

# Plain versions, beside their kernels.
fleet_step_plain = _ref.dual_engine_fleet_step
fleet_step_q_plain = _ref.dual_engine_fleet_step_q
shared_step_plain = _ref.dual_engine_step
shared_step_q_plain = _ref.dual_engine_step_q

MAX_SHARED_BATCH = 1024     # rows of one shared step (its traces in smem)

_P = ctypes.c_void_p


class FParams(ctypes.Structure):
    """``ff::FParams`` of csrc/plasticity.cuh."""
    _fields_ = [("inv_tau", ctypes.c_float), ("v_th", ctypes.c_float),
                ("v_reset", ctypes.c_float), ("decay", ctypes.c_float)]


class QParams(ctypes.Structure):
    """``ff::QParams`` of csrc/plasticity.cuh."""
    _fields_ = [("one", ctypes.c_int), ("tau_shift", ctypes.c_int),
                ("trace_shift", ctypes.c_int), ("vth_fx", ctypes.c_int),
                ("vres_fx", ctypes.c_int), ("stoch_round", ctypes.c_int),
                ("inv1", ctypes.c_float), ("inv2", ctypes.c_float)]


class _FleetStepArgs(ctypes.Structure):
    """``FleetStepArgs`` of csrc/fleet_step.cu."""
    _fields_ = [(name, _P) for name in (
        "x", "w", "theta", "v", "trace_pre", "trace_post", "teach", "active",
        "scale", "seed", "events", "v_out", "trace_post_out", "w_out")] + [
        (name, ctypes.c_int) for name in (
            "batch", "n", "m", "plastic", "spiking")] + [
        ("w_clip", ctypes.c_float), ("f", FParams), ("q", QParams),
        ("tel", _P), ("tiles", ctypes.c_int), ("sat_q", ctypes.c_int),
        ("sat_f", ctypes.c_float)]


class _SharedStepArgs(ctypes.Structure):
    """``SharedStepArgs`` of csrc/shared_step.cu."""
    _fields_ = [(name, _P) for name in (
        "x", "w", "theta", "v", "trace_pre", "trace_post", "teach", "scale",
        "seed", "events", "v_out", "trace_post_out", "w_out")] + [
        (name, ctypes.c_int) for name in (
            "batch", "n", "m", "plastic", "spiking")] + [
        ("w_clip", ctypes.c_float), ("f", FParams), ("q", QParams)]


def f_params(tau_m, v_th, v_reset, trace_decay) -> FParams:
    return FParams(1.0 / tau_m, v_th, v_reset, trace_decay)


def q_params(qcfg: Q.QuantConfig, v_th, v_reset, batch: int = 1) -> QParams:
    """Fixed-point constants; ``inv1``/``inv2`` are ``1 / (one * batch)`` and
    ``1 / (one**2 * batch)`` in double, rounded once to fp32 (as
    `quant.dw_from_int_reductions`): batch 1 per fleet stream, B for a
    shared-weight batch."""
    vth_fx, vres_fx = Q.thresholds_fx(qcfg, v_th, v_reset)
    return QParams(qcfg.one, qcfg.tau_shift, qcfg.trace_shift, vth_fx,
                   vres_fx, int(qcfg.stoch_round), 1.0 / (qcfg.one * batch),
                   1.0 / (qcfg.one * qcfg.one * batch))


def on_card(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"repro_torch runs on CUDA or CPU tensors; got a tensor "
                     f"on {t.device}")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def expect(name: str, t: torch.Tensor, shape, dtype, device) -> torch.Tensor:
    """Check a kernel operand and return it contiguous."""
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device:
        raise ValueError(f"{name}: kernel needs {tuple(shape)} {dtype} on "
                         f"{device}; got {tuple(t.shape)} {t.dtype} on "
                         f"{t.device}")
    return t.contiguous()


def per_stream(val, b: int, dtype, device) -> torch.Tensor:
    """Scalar or (B,) -> contiguous (B,) operand (one scale/seed per slot;
    a missing seed is 0)."""
    t = torch.as_tensor(0 if val is None else val, dtype=dtype,
                        device=device)
    return t.expand(b).contiguous() if t.ndim == 0 else \
        expect("per-stream operand", t, (b,), dtype, device)


def active_mask(active, b: int, device) -> torch.Tensor | None:
    if active is None:
        return None
    if tuple(active.shape) != (b,):
        raise ValueError(f"active slot mask must have shape ({b},); got "
                         f"{tuple(active.shape)}")
    return (active.to(device) != 0).to(torch.uint8).contiguous()


def tel_tiles(m: int) -> int:
    """Partials per stream of the fleet-step telemetry buffer: the most
    32-lane warps that M contiguous (b, m) elements can touch."""
    return (m - 1) // 32 + 2


def _launch(entry: str, x, w, theta, v, trace_pre, trace_post, *, state_dt,
            plastic, spiking, w_clip, teach, active, telemetry, v_th,
            scale=None, seed=None, f=None, q=None, qcfg=None):
    """Check operands, allocate outputs, launch one fleet-step kernel;
    with ``telemetry`` also fold its per-(stream, warp piece) partials into
    the raw (B, 3) row."""
    b, n = x.shape
    m = w.shape[2]
    dev = x.device
    if plastic and theta is None:
        raise ValueError("plastic layer needs theta")
    x = expect("x", x, (b, n), state_dt, dev)
    w = expect("w", w, (b, n, m), w.dtype, dev)
    v = expect("v", v, (b, m), state_dt, dev)
    trace_post = expect("trace_post", trace_post, (b, m), state_dt, dev)
    trace_pre = expect("trace_pre", trace_pre, (b, n), state_dt, dev)
    if plastic:
        theta = expect("theta", theta, (4, n, m), torch.float32, dev)
    if teach is not None:
        teach = teach.to(device=dev, dtype=state_dt).expand(b, m).contiguous()
    active = active_mask(active, b, dev)
    events = torch.empty((b, m), dtype=state_dt, device=dev)
    v_out = torch.empty_like(v)
    tp_out = torch.empty_like(trace_post)
    w_out = torch.empty_like(w)
    tiles = tel_tiles(m)
    parts = (torch.zeros((b, tiles, 3), dtype=state_dt, device=dev)
             if telemetry else None)
    args = _FleetStepArgs(
        ptr(x), ptr(w), ptr(theta) if plastic else None, ptr(v),
        ptr(trace_pre), ptr(trace_post), ptr(teach), ptr(active), ptr(scale),
        ptr(seed), ptr(events), ptr(v_out), ptr(tp_out), ptr(w_out),
        b, n, m, int(plastic), int(spiking), w_clip, f or FParams(),
        q or QParams(), ptr(parts), tiles,
        sat_threshold_q(v_th, qcfg) if qcfg is not None else 0,
        sat_threshold(v_th))
    fn = getattr(_build.library("fleet_step.cu"), entry)
    fn.argtypes, fn.restype = [ctypes.POINTER(_FleetStepArgs), _P], \
        ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(x)), entry)
    out = (events, v_out, tp_out, w_out)
    if not telemetry:
        return out
    if qcfg is None:
        raw = parts.sum(1)
    else:   # exact integer counts until one division and one scaling
        sums = parts.sum(1, dtype=torch.int32)
        raw = torch.stack([sums[:, 0].float() / qcfg.one,
                           sums[:, 1].float() * scale,
                           sums[:, 2].float()], dim=1)
    if active is not None:
        raw = raw * active.reshape(-1, 1).float()
    return out + (raw,)


def fleet_step(x, w, theta, v, trace_pre, trace_post, *,
               tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
               trace_decay: float = 0.8, w_clip: float = 4.0,
               plastic: bool = True, spiking: bool = True, teach=None,
               active=None, telemetry: bool = False):
    """Float32 fleet step; shapes as `ref.dual_engine_fleet_step`.
    Returns (events, v_out, trace_post_new, w_new), plus the raw (B, 3)
    telemetry row with ``telemetry``."""
    if not on_card(x):
        return fleet_step_plain(
            x, w, theta, v, trace_pre, trace_post, tau_m=tau_m, v_th=v_th,
            v_reset=v_reset, trace_decay=trace_decay, w_clip=w_clip,
            plastic=plastic, spiking=spiking, teach=teach, active=active,
            telemetry=telemetry)
    if w.dtype != torch.float32:
        raise ValueError(f"float fleet kernel needs float32 w; got {w.dtype}")
    out = _launch("fleet_step_f32", x, w, theta, v, trace_pre, trace_post,
                  state_dt=torch.float32, plastic=plastic, spiking=spiking,
                  w_clip=w_clip, teach=teach, active=active,
                  telemetry=telemetry, v_th=v_th,
                  f=f_params(tau_m, v_th, v_reset, trace_decay))
    fleet_step.launches += 1
    fleet_step.telemetry_launches += int(telemetry)
    return out


fleet_step.launches = 0
fleet_step.telemetry_launches = 0       # the telemetry variant's share


def fleet_step_q(x, w, scale, theta, v, trace_pre, trace_post, *,
                 qcfg: Q.QuantConfig, v_th: float = 1.0, v_reset: float = 0.0,
                 w_clip: float = 4.0, plastic: bool = True,
                 spiking: bool = True, teach=None, seed=None, active=None,
                 telemetry: bool = False):
    """Fixed-point fleet step; shapes as `ref.dual_engine_fleet_step_q`.
    Returns (events, v_out, trace_post_new, w_new), int32 and int8, plus
    the raw (B, 3) float32 telemetry row with ``telemetry``."""
    if not on_card(x):
        return fleet_step_q_plain(
            x, w, scale, theta, v, trace_pre, trace_post, qcfg=qcfg,
            v_th=v_th, v_reset=v_reset, w_clip=w_clip, plastic=plastic,
            spiking=spiking, teach=teach, seed=seed, active=active,
            telemetry=telemetry)
    if w.dtype != torch.int8:
        raise ValueError(f"fixed-point fleet kernel needs int8 w; got "
                         f"{w.dtype}")
    b, dev = x.shape[0], x.device
    out = _launch("fleet_step_q", x, w, theta, v, trace_pre, trace_post,
                  state_dt=torch.int32, plastic=plastic, spiking=spiking,
                  w_clip=w_clip, teach=teach, active=active,
                  telemetry=telemetry, v_th=v_th,
                  scale=per_stream(scale, b, torch.float32, dev),
                  seed=per_stream(seed, b, torch.int32, dev),
                  q=q_params(qcfg, v_th, v_reset), qcfg=qcfg)
    fleet_step_q.launches += 1
    fleet_step_q.telemetry_launches += int(telemetry)
    return out


fleet_step_q.launches = 0
fleet_step_q.telemetry_launches = 0       # the telemetry variant's share


def _launch_shared(entry: str, x, w, theta, v, trace_pre, trace_post, *,
                   state_dt, plastic, spiking, w_clip, teach, scale=None,
                   seed=None, f=None, q=None):
    """Check operands, allocate outputs, launch one shared-step kernel."""
    if x.ndim != 2:
        raise ValueError(f"the shared-step kernel takes batched x (B, N); got "
                         f"{tuple(x.shape)} (engine.layer_step promotes "
                         f"unbatched state to B = 1)")
    b, n = x.shape
    m = w.shape[1]
    dev = x.device
    if b > MAX_SHARED_BATCH:
        raise ValueError(f"shared-step kernel takes at most "
                         f"{MAX_SHARED_BATCH} rows; got B = {b}")
    if plastic and theta is None:
        raise ValueError("plastic layer needs theta")
    x = expect("x", x, (b, n), state_dt, dev)
    w = expect("w", w, (n, m), w.dtype, dev)
    v = expect("v", v, (b, m), state_dt, dev)
    trace_post = expect("trace_post", trace_post, (b, m), state_dt, dev)
    trace_pre = expect("trace_pre", trace_pre, (b, n), state_dt, dev)
    if plastic:
        theta = expect("theta", theta, (4, n, m), torch.float32, dev)
    if teach is not None:
        teach = teach.to(device=dev, dtype=state_dt).expand(b, m).contiguous()
    events = torch.empty((b, m), dtype=state_dt, device=dev)
    v_out = torch.empty_like(v)
    tp_out = torch.empty_like(trace_post)
    w_out = torch.empty_like(w)
    args = _SharedStepArgs(
        ptr(x), ptr(w), ptr(theta) if plastic else None, ptr(v),
        ptr(trace_pre), ptr(trace_post), ptr(teach), ptr(scale), ptr(seed),
        ptr(events), ptr(v_out), ptr(tp_out), ptr(w_out), b, n, m,
        int(plastic), int(spiking), w_clip, f or FParams(), q or QParams())
    fn = getattr(_build.library("shared_step.cu"), entry)
    fn.argtypes, fn.restype = [ctypes.POINTER(_SharedStepArgs), _P], \
        ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(x)), entry)
    return events, v_out, tp_out, w_out


def shared_step(x, w, theta, v, trace_pre, trace_post, *,
                tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
                trace_decay: float = 0.8, w_clip: float = 4.0,
                plastic: bool = True, spiking: bool = True, teach=None):
    """Float32 shared-weight step; shapes as `ref.dual_engine_step` (the
    kernel takes batched (B, ·) state).
    Returns (events, v_out, trace_post_new, w_new)."""
    if not on_card(x):
        return shared_step_plain(
            x, w, theta, v, trace_pre, trace_post, tau_m=tau_m, v_th=v_th,
            v_reset=v_reset, trace_decay=trace_decay, w_clip=w_clip,
            plastic=plastic, spiking=spiking, teach=teach)
    for name, t in (("x", x), ("w", w), ("v", v), ("trace_pre", trace_pre),
                    ("trace_post", trace_post)):
        if t.dtype != torch.float32:
            raise ValueError(f"float shared-step kernel needs float32 {name}; "
                             f"got {t.dtype}")
    out = _launch_shared("shared_step_f32", x, w, theta, v, trace_pre,
                         trace_post, state_dt=torch.float32, plastic=plastic,
                         spiking=spiking, w_clip=w_clip, teach=teach,
                         f=f_params(tau_m, v_th, v_reset, trace_decay))
    shared_step.launches += 1
    return out


shared_step.launches = 0


def shared_step_q(x, w, scale, theta, v, trace_pre, trace_post, *,
                  qcfg: Q.QuantConfig, v_th: float = 1.0, v_reset: float = 0.0,
                  w_clip: float = 4.0, plastic: bool = True,
                  spiking: bool = True, teach=None, seed=None):
    """Fixed-point shared-weight step; shapes as `ref.dual_engine_step_q`:
    one scale () and one seed () per call.
    Returns (events, v_out, trace_post_new, w_new), int32 and int8."""
    if not on_card(x):
        return shared_step_q_plain(
            x, w, scale, theta, v, trace_pre, trace_post, qcfg=qcfg,
            v_th=v_th, v_reset=v_reset, w_clip=w_clip, plastic=plastic,
            spiking=spiking, teach=teach, seed=seed)
    if w.dtype != torch.int8:
        raise ValueError(f"fixed-point shared-step kernel needs int8 w; got "
                         f"{w.dtype}")
    dev = x.device
    out = _launch_shared(
        "shared_step_q", x, w, theta, v, trace_pre, trace_post,
        state_dt=torch.int32, plastic=plastic, spiking=spiking, w_clip=w_clip,
        teach=teach, scale=per_stream(scale, 1, torch.float32, dev),
        seed=per_stream(seed, 1, torch.int32, dev),
        q=q_params(qcfg, v_th, v_reset, batch=x.shape[0]))
    shared_step_q.launches += 1
    return out


shared_step_q.launches = 0
