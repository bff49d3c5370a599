"""Device-side flight recorder: per-slot telemetry history + incident dumps.

The black box of the serving pools: a fixed-shape ``(B, W, C)`` ring of
per-slot telemetry channels (`health.CHANNELS`: spike rate, mean |dw|,
saturation fraction, weight-norm drift against the admission snapshot),
written by the schedulers' ``record=`` variants of `FleetScheduler.step` and
`pool_step`.  A recorded step makes no host sync: the streaming detectors
(`obs.health`) run in the same launch, and the host reads the latched
verdict only when it decides to act.

Every slot records in lockstep (occupancy is a mask, not a shape), so one
host-side cursor serves the whole pool; the scheduler passes it as a scalar.

`recorder_update`, `network_weight_norm` and `health.health_update` are the
plain versions, in the JAX package's order of operations.  `record_step` is
what the scheduler calls: on the card it launches ``csrc/recorder.cu``,
which reads the weights, latches ``wnorm0``, writes ring row ``pos % W``
and runs the detectors in one launch (counted in ``record_step.launches``);
on a CPU tensor it composes the plain versions.  Either way it updates the
recorder state in place.  `recorder_plan` lays the launch out from the
shape (the kernel refuses another layout).

`dump_incident` is the post-mortem exit: one JSON (verdicts, streaks,
config, registry snapshot, watchdog state) and one NPZ (the unrolled ring
and the detector baselines) per flagged session, the JAX package's format.

The LM adapter records through the same step on a one-layer view of its
cache (`adapter_weight_norm`, `AdapterFlightRecorder` of the lockstep serve
loop, the ``record=`` variants of `serving.lm.LMScheduler`).
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import re
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.kernels import _build
from repro_torch.obs.health import (CHANNELS, DETECTORS, HealthConfig,
                                    HealthState, health_update, init_health)
from repro_torch.obs.telemetry import adapter_telemetry

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_W_DTYPE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_W_BYTES = {torch.float32: 4, torch.bfloat16: 2, torch.int8: 1}
# csrc/recorder.cu's constants: layers, threads a CTA, slots a CTA (four
# threads each), CTAs a slot (portable clusters), CTAs an SM, a CTA's and
# an SM's shared bytes (1 KB of the SM's kept a CTA), the bytes a tile aims
# at, the least bytes a cluster rank takes, the layer table's bytes
MAX_LAYERS = 8
REC_THREADS = 256
REC_MAX_TILE = REC_THREADS // 4
REC_MAX_CLUSTER = 8
REC_MAX_CTAS_SM = 4
REC_SMEM_MAX = 232448
REC_SMEM_SM = 233472
REC_STAGE_TARGET = 32768
REC_MIN_SHARE = 2048
_LAYER_TABLE = 32 * MAX_LAYERS
# the fields of a plan that the kernel's launcher checks, in its order
_PLAN_FIELDS = ("cluster", "slots", "tiles", "stages", "ctas", "stage_bytes",
                "smem", "words")
RECORDER_KERNELS = ("recorder_tiles_kernel<float>",
                    "recorder_tiles_kernel<bf16>",
                    "recorder_tiles_kernel<int8>",
                    "recorder_cluster_kernel<float>",
                    "recorder_cluster_kernel<bf16>",
                    "recorder_cluster_kernel<int8>")


@dataclasses.dataclass(frozen=True)
class RecorderState:
    """Flight-recorder device state, every leaf slot-major ``(B, ...)``.

    ring     ``(B, W, C) float32`` channel history (W = cfg.window); row
             ``pos % W`` is overwritten each recorded step.
    wnorm0   ``(B,) float32`` admission-time weight-norm snapshot, latched
             on the device at the slot's first recorded step.
    health   streaming detector state (`obs.health.HealthState`).
    """

    ring: torch.Tensor
    wnorm0: torch.Tensor
    health: HealthState


def init_recorder(cfg: HealthConfig, slots: int,
                  device=None) -> RecorderState:
    """Zero recorder state for ``slots`` slots; ``device=None`` is the
    card."""
    health = init_health(cfg, slots, device)
    dev = health.steps.device
    return RecorderState(
        ring=torch.zeros((slots, cfg.window, len(CHANNELS)),
                         dtype=torch.float32, device=dev),
        wnorm0=torch.zeros((slots,), dtype=torch.float32, device=dev),
        health=health)


def recorder_update(cfg: HealthConfig, rec: RecorderState,
                    channels: torch.Tensor, pos, active) -> tuple:
    """One recorded step: ``(new_state, verdict (B,) bool)``.

    `channels` is the raw ``(B, C)`` vector in `health.CHANNELS` order
    with the last column carrying the current weight norm (not yet a
    drift): ``wnorm0`` latches the first recorded active value and channel
    3 becomes ``|wnorm - wnorm0|``.  `pos` is the global ring cursor.
    Everything is gated by `active`: vacant and frozen slots write exact
    zeros and keep their detector state.  `rec` is not modified.
    """
    act = torch.as_tensor(active, device=channels.device).bool()
    channels = channels.to(torch.float32)
    wnorm = channels[:, -1]
    first = act & (rec.health.steps == 0)
    wnorm0 = torch.where(first, wnorm, rec.wnorm0)
    x = torch.cat([channels[:, :-1], (wnorm - wnorm0).abs()[:, None]],
                  dim=-1)
    x = torch.where(act[:, None], x, 0.0)
    ring = rec.ring.clone()
    ring[:, int(pos) % cfg.window] = x
    health, verdict = health_update(cfg, rec.health, x, act)
    return RecorderState(ring=ring, wnorm0=wnorm0, health=health), verdict


def reset_slot(rec: RecorderState, slot: int) -> RecorderState:
    """Zero one slot's rows in every recorder leaf, in place; returns
    `rec`.  The scheduler calls this on admit, evict and rollback so a
    slot's history always belongs to one session tenancy."""
    for leaf in _ckpt.flatten(rec)[1]:
        leaf[int(slot)].zero_()
    return rec


# ---- weight-norm channel ----------------------------------------------------


def network_weight_norm(state, quant: bool) -> torch.Tensor:
    """Per-slot mean |w| summed over layers for a fleet `NetworkState`
    (``(B,) float32``; int8 planes dequantized by their per-slot scale so
    both datapaths report in float weight units).  The mean is the sum
    divided by N * M, as ``jnp.mean`` computes it: by a tensor, since
    PyTorch on the card multiplies by the reciprocal of a number."""
    tot = None
    for i, w in enumerate(state.w):
        if quant:
            s = w.to(torch.int32).abs().to(torch.float32).sum(dim=(-2, -1))
        else:
            s = w.to(torch.float32).abs().sum(dim=(-2, -1))
        a = s / torch.full_like(s, w.shape[-2] * w.shape[-1])
        if quant:
            a = a * state.w_scale[i]
        tot = a if tot is None else tot + a
    return tot.to(torch.float32)


@dataclasses.dataclass(frozen=True)
class AdapterLayers:
    """The LM adapter's cache as a one-layer fleet: what `record_step` and
    `network_weight_norm` read of a `NetworkState` (``w`` and, in fixed
    point, ``w_scale``)."""

    w: tuple
    w_scale: tuple = ()

    @staticmethod
    def of(adapter: dict, quant: bool) -> "AdapterLayers":
        return AdapterLayers(w=(adapter["w_fast"],),
                             w_scale=(adapter["w_scale"],) if quant else ())


def adapter_weight_norm(adapter: dict, quant: bool) -> torch.Tensor:
    """Per-slot mean |w_fast| of an LM adapter cache (``(B,) float32``, the
    int8 grid dequantized by its per-slot scale)."""
    return network_weight_norm(AdapterLayers.of(adapter, quant), quant)


# ---- the fused recorded step ---------------------------------------------


def record_step_plain(cfg: HealthConfig, rec: RecorderState, state, tel,
                      pos, active, quant: bool) -> tuple:
    """`record_step`'s plain version: ``recorder_update`` of the telemetry
    and `network_weight_norm`, written back into `rec` in place.  Returns
    ``(rec, verdict)``."""
    ch = torch.stack([tel.spike_rate, tel.mean_abs_dw, tel.sat_frac,
                      network_weight_norm(state, quant)], dim=-1)
    new, verdict = recorder_update(cfg, rec, ch, pos, active)
    for a, b in zip(_ckpt.flatten(rec)[1], _ckpt.flatten(new)[1]):
        a.copy_(b)
    return rec, verdict


# ---- the kernel's plan ------------------------------------------------------


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def _extra_bytes(n_layers: int) -> int:
    """Shared bytes after the stages: the (slot, layer) sums of a CTA's
    slots (at most `REC_MAX_TILE`) or a cluster CTA's warp sums and
    partials, 8 bytes each; two mbarriers; the layer table."""
    return 8 * REC_MAX_TILE * n_layers + 16 + _LAYER_TABLE


def _stage(nms, e: int, k: int, c: int):
    """(bytes, shares, offsets) of a stage holding k slots' layers, each
    layer's region 4 bytes over its span (a cp.async span starts at byte
    address & 3) rounded to 16; a CTA takes ``share`` elements of a slot's
    layer: all of it, or on a cluster of c CTAs a 16-byte multiple."""
    v = 16 // e
    s, shares, offs = 0, [], []
    for nm in nms:
        share = nm if c == 1 else -(-(-(-nm // c)) // v) * v
        shares.append(share)
        offs.append(s)
        s += _align16(k * share * e + 4)
    return s, tuple(shares), tuple(offs)


def recorder_plan(b: int, nms, w_dtype, sm_count: int,
                  aligned=None) -> dict:
    """How ``csrc/recorder.cu`` lays out one recorded step of ``b`` slots
    whose layers hold ``nms`` weights each (N * M) of ``w_dtype``, on a card
    of ``sm_count`` SMs (``aligned``: each layer's base on 16 bytes; all by
    default).  The launcher computes the same plan and refuses another.

    ``route`` "tiles" (many small slots, the fleet): a CTA takes ``slots``
    consecutive slots a tile, whose layers are one contiguous span each, so
    one thread brings them in by bulk copies while the detector threads
    load the state; ``ctas`` CTAs walk the ``tiles`` through ``stages``
    buffers of ``stage_bytes``.  "cluster" (few large slots, the LM
    adapter): one slot runs on ``cluster`` CTAs, each taking ``shares``
    elements of every layer, their sums met in rank order.  ``loads``: each
    layer by one "bulk" copy, or "cp_async" words where its N M bytes are
    not a multiple of 16 or its base is off 16 bytes (``words``: their
    bits).  ``smem``: dynamic shared bytes a CTA.  Raises for a shape no
    plan fits: a slot whose eighth does not fit a CTA's shared memory, or
    more than `MAX_LAYERS` layers."""
    if w_dtype not in _W_BYTES:
        raise ValueError(f"recorder_plan takes float32, bfloat16 or int8 "
                         f"weights; got {w_dtype}")
    e = _W_BYTES[w_dtype]
    nms = tuple(int(n) for n in nms)
    n = len(nms)
    if not 1 <= n <= MAX_LAYERS or b < 1 or min(nms) < 1 or sm_count < 1:
        raise ValueError(f"recorder_plan takes 1 to {MAX_LAYERS} layers of "
                         f"at least one weight and B >= 1; got B = {b}, "
                         f"N * M = {nms}")
    aligned = (True,) * n if aligned is None else tuple(map(bool, aligned))
    loads = tuple("bulk" if al and nm * e % 16 == 0 else "cp_async"
                  for nm, al in zip(nms, aligned))
    words = sum(1 << l for l, r in enumerate(loads) if r == "cp_async")
    per_slot = sum(nms) * e
    c = min(REC_MAX_CLUSTER, -(-sm_count // b),
            max(1, per_slot // REC_MIN_SHARE))
    if c == 1 and (2 * _stage(nms, e, 1, 1)[0] + _extra_bytes(n)
                   <= REC_SMEM_MAX):
        k = max(1, min(REC_MAX_TILE, REC_STAGE_TARGET // per_slot,
                       -(-b // sm_count)))
        tiles = -(-b // k)
        stage, shares, offs = _stage(nms, e, k, 1)
        extra = _extra_bytes(n)
        per_sm = min(REC_MAX_CTAS_SM, REC_SMEM_SM // (stage + extra + 1024))
        stages = 1 if tiles <= sm_count * per_sm else 2
        if stages == 2:
            per_sm = min(REC_MAX_CTAS_SM,
                         REC_SMEM_SM // (2 * stage + extra + 1024))
        # a CTA holds the detector state of at most REC_MAX_TILE slots
        ctas = max(min(tiles, sm_count * per_sm),
                   -(-tiles // (REC_MAX_TILE // k)))
        plan = dict(route="tiles", cluster=1, slots=k, tiles=tiles,
                    stages=stages, ctas=ctas, stage_bytes=stage,
                    smem=stages * stage + extra)
    else:
        c = max(c, 2)
        while c <= REC_MAX_CLUSTER and (_stage(nms, e, 1, c)[0]
                                        + _extra_bytes(n) > REC_SMEM_MAX):
            c += 1
        if c > REC_MAX_CLUSTER:
            raise ValueError(f"the recorder takes a slot of at most "
                             f"{REC_MAX_CLUSTER} CTAs' shared memory; "
                             f"{per_slot} bytes a slot (N * M = {nms}) do "
                             f"not fit")
        stage, shares, offs = _stage(nms, e, 1, c)
        plan = dict(route="cluster", cluster=c, slots=1, tiles=b, stages=1,
                    ctas=b * c, stage_bytes=stage,
                    smem=stage + _extra_bytes(n))
    # int8: a warp adds at most a stage's bytes into 32-bit partials
    if e == 1 and 128 * plan["stage_bytes"] >= 2 ** 31:
        raise ValueError("the recorder's int8 partials could overflow")
    plan.update(threads=REC_THREADS, loads=loads, words=words, shares=shares,
                offsets=offs)
    return plan


def recorder_attrs() -> dict:
    """``{kernel: {registers, local_bytes}}`` of ``csrc/recorder.cu``'s
    kernels (`RECORDER_KERNELS`) as compiled (``cudaFuncGetAttributes``;
    ``local_bytes`` a thread are its spills and stack).  Needs the card."""
    fn = _build.library("recorder.cu").recorder_attrs
    fn.argtypes, fn.restype = [ctypes.POINTER(_I), _I], _I
    out = (_I * (2 * len(RECORDER_KERNELS)))()
    _build.check(fn(out, len(RECORDER_KERNELS)), "recorder_attrs")
    return {name: dict(registers=out[2 * i], local_bytes=out[2 * i + 1])
            for i, name in enumerate(RECORDER_KERNELS)}


def _config_arrays(cfg: HealthConfig):
    a = float(cfg.ewma_alpha)
    floats = ([a, 1.0 - a, float(cfg.z_threshold), float(cfg.z_floor) ** 2,
               float(cfg.stuck_eps), float(cfg.dead_floor)]
              + [float(b[0]) for b in cfg.bounds]
              + [float(b[1]) for b in cfg.bounds])
    # each constant rounded to float32 from its double, as the plain
    # version's scalars are
    fc = (ctypes.c_float * len(floats))(
        *np.asarray(floats, np.float64).astype(np.float32).tolist())
    ic = (ctypes.c_int * 5)(int(cfg.warmup), *map(int, cfg.hysteresis))
    return fc, ic


def record_step(cfg: HealthConfig, rec: RecorderState, state, tel, pos,
                active, quant: bool) -> tuple:
    """One recorded step of a fleet, in place: the network weight norm of
    ``state`` (a fleet `NetworkState`, its new weights), the drift against
    ``wnorm0``, ring row ``pos % W`` from ``tel`` (a `FleetTelemetry`) and
    the detectors.  Returns ``(rec, verdict (B,) bool)``.

    A CPU recorder takes `record_step_plain`; on the card this launches
    ``csrc/recorder.cu`` once, laid out by `recorder_plan`, with ``pos``
    passed by value, and counts it in ``record_step.launches`` (B = 0
    launches nothing).  The weights must be contiguous (a fleet's are), the
    telemetry fields ``(B,)`` float32 at any stride, ``active`` a ``(B,)``
    bool or uint8 mask on the card."""
    # the kernel helpers import obs.telemetry: imported here, not above
    from repro_torch.kernels.plasticity.kernel import on_card, stream_of
    if not on_card(rec.ring):
        return record_step_plain(cfg, rec, state, tel, pos, active, quant)
    b, dev = rec.ring.shape[0], rec.ring.device
    layers = list(state.w)
    if not 1 <= len(layers) <= MAX_LAYERS:
        raise ValueError(f"record_step takes 1 to {MAX_LAYERS} layers; got "
                         f"{len(layers)}")
    w_dt = layers[0].dtype
    if w_dt not in _W_DTYPE or (w_dt == torch.int8) != bool(quant):
        raise ValueError(f"record_step takes float32 or bfloat16 weights, "
                         f"or int8 with quant=True; got {w_dt}, quant="
                         f"{quant}")
    for w in layers:
        if w.dtype != w_dt or w.device != dev or w.shape[0] != b \
                or w.ndim != 3 or not w.is_contiguous():
            raise ValueError(f"record_step needs contiguous (B={b}, N, M) "
                             f"{w_dt} weights on {dev}; got "
                             f"{tuple(w.shape)} {w.dtype} on {w.device}")
    scales = [None] * len(layers)
    if quant:
        scales = list(state.w_scale)
        for s in scales:
            if s.shape != (b,) or s.dtype != torch.float32 \
                    or s.device != dev or not s.is_contiguous():
                raise ValueError("record_step needs (B,) float32 scales on "
                                 "the card in an int8 fleet")
    cols = (tel.spike_rate, tel.mean_abs_dw, tel.sat_frac)
    for t in cols:
        if t.shape != (b,) or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"record_step needs (B={b},) float32 telemetry "
                             f"on {dev}; got {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}")
    if active is not None and (tuple(active.shape) != (b,)
                               or active.device != dev
                               or active.dtype not in (torch.bool,
                                                       torch.uint8)
                               or not active.is_contiguous()):
        raise ValueError(f"record_step needs a contiguous (B={b},) bool or "
                         f"uint8 mask on {dev}")
    h = rec.health
    verdict = torch.empty((b,), dtype=torch.bool, device=dev)
    if b == 0:
        return rec, verdict
    n = len(layers)
    nms = [w.shape[1] * w.shape[2] for w in layers]
    plan = recorder_plan(b, nms, w_dt,
                         torch.cuda.get_device_properties(dev)
                         .multi_processor_count,
                         [w.data_ptr() % 16 == 0 for w in layers])
    fc, ic = _config_arrays(cfg)
    fn = _build.library("recorder.cu").recorder_step
    fn.argtypes = [ctypes.POINTER(_P), ctypes.POINTER(_P),
                   ctypes.POINTER(_L), _I, _I, ctypes.POINTER(_P),
                   ctypes.POINTER(_L), _P, _P, _P, _P, _P, _P, _P, _P, _P,
                   _P, _L, _I, _I, ctypes.POINTER(ctypes.c_float),
                   ctypes.POINTER(_I), ctypes.POINTER(_I), _P]
    fn.restype = _I
    _build.check(fn(
        (_P * n)(*[w.data_ptr() for w in layers]),
        (_P * n)(*[None if s is None else s.data_ptr() for s in scales]),
        (_L * n)(*nms), n,
        _W_DTYPE[w_dt], (_P * 3)(*[t.data_ptr() for t in cols]),
        (_L * 3)(*[t.stride(0) for t in cols]),
        None if active is None else active.data_ptr(),
        rec.ring.data_ptr(), rec.wnorm0.data_ptr(), h.ewma_mean.data_ptr(),
        h.ewma_var.data_ptr(), h.last.data_ptr(), h.streaks.data_ptr(),
        h.flagged.data_ptr(), h.steps.data_ptr(), verdict.data_ptr(),
        int(pos) % cfg.window, cfg.window, b, fc, ic,
        (_I * len(_PLAN_FIELDS))(*[plan[k] for k in _PLAN_FIELDS]),
        stream_of(rec.ring)),
        "recorder_step")
    _record_step.launches += 1
    return rec, verdict


_record_step = record_step   # counts the launches: a patch leaves it alone
record_step.launches = 0


# ---- post-mortem export -----------------------------------------------------


def unroll_ring(ring_row: np.ndarray, pos: int, window: int) -> np.ndarray:
    """The valid portion of one slot's ring, oldest -> newest ``(n, C)``.

    `pos` is the recorder's global cursor (total recorded steps); only
    ``min(pos, window)`` rows have ever been written."""
    ring_row = np.asarray(ring_row)
    n = min(int(pos), window)
    if n == 0:
        return ring_row[:0]
    return np.roll(ring_row, -(int(pos) % window), axis=0)[-n:]


def _safe_uid(uid: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", str(uid)) or "session"


def dump_incident(directory: str, *, uid: str, slot: int,
                  rec: RecorderState, cfg: HealthConfig, pos: int,
                  registry=None, watchdog=None,
                  extra: Optional[dict] = None) -> str:
    """Write one incident's post-mortem bundle; returns the JSON path.

    Two files per incident, ``incident_<uid>_p<pos>.{json,npz}``: the JSON
    carries the per-detector latched flags and streaks, the detector
    config, a metrics-registry snapshot and the recompile-watchdog state at
    dump time; the NPZ carries the arrays (the unrolled ring and the EWMA
    baselines the verdict was computed against).
    """
    os.makedirs(directory, exist_ok=True)
    slot = int(slot)
    host = _ckpt.tree_map(lambda t: t[slot].detach().cpu().numpy(), rec)
    h: HealthState = host.health
    stem = f"incident_{_safe_uid(uid)}_p{int(pos)}"
    npz_path = os.path.join(directory, stem + ".npz")
    np.savez(
        npz_path,
        ring=unroll_ring(host.ring, pos, cfg.window),
        ewma_mean=h.ewma_mean, ewma_var=h.ewma_var, last=h.last,
        streaks=h.streaks, flagged=h.flagged, wnorm0=host.wnorm0)
    flags = h.flagged
    doc = {
        "uid": str(uid),
        "slot": slot,
        "pos": int(pos),
        "channels": list(CHANNELS),
        "detectors": list(DETECTORS),
        "verdict": bool(flags.any()),
        "flagged": {d: bool(flags[i]) for i, d in enumerate(DETECTORS)},
        "streaks": {d: int(h.streaks[i]) for i, d in enumerate(DETECTORS)},
        "recorded_steps": int(h.steps),
        "wnorm0": float(host.wnorm0),
        "config": dataclasses.asdict(cfg),
        "npz": os.path.basename(npz_path),
        "registry": registry.snapshot() if registry is not None else None,
        "watchdog": ({
            "compiles": watchdog.compiles,
            "violations": watchdog.violations,
            "signatures": list(watchdog.violation_signatures),
        } if watchdog is not None else None),
    }
    if extra:
        doc.update(extra)
    path = os.path.join(directory, stem + ".json")
    with open(path, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
    return path


# ---- the lockstep-batch recorder (launch/serve.py) --------------------------


class AdapterFlightRecorder:
    """Flight recorder of the lockstep serve loop (`launch.serve`).

    `launch.serve` decodes a fixed batch with no scheduler in the loop, so this
    helper owns the recorder state.  ``observe(before, after)`` per decode
    step recovers the adapter's channels from its cache before and after
    the step (`obs.telemetry.adapter_telemetry`) and records them with the
    adapter's weight norm through `record_step` (one launch on the card,
    no host sync); ``dump(directory, ...)`` writes one incident bundle per
    flagged slot and always ``flight_summary.json``.

    `qcfg`: the adapter's quant config (``models.plastic.QUANT``) for int8
    pools, None for float32.  ``device=None`` is the card.
    """

    def __init__(self, cfg: HealthConfig, slots: int, qcfg=None,
                 trace_decay: float = 0.8, device=None):
        self.cfg = cfg
        self.slots = int(slots)
        self.qcfg = qcfg
        self.trace_decay = trace_decay
        self.rec = init_recorder(cfg, self.slots, device)
        self.pos = 0

    def observe(self, before: dict, after: dict, active=None) -> None:
        """Record one decode step from the adapter cache before and after
        it (``active (B,)`` bool, all slots when None)."""
        dev = self.rec.ring.device
        active = (torch.ones((self.slots,), dtype=torch.bool, device=dev)
                  if active is None else active.to(dev, torch.bool))
        quant = self.qcfg is not None
        tel = adapter_telemetry(before, after, active, qcfg=self.qcfg,
                                trace_decay=self.trace_decay)
        record_step(self.cfg, self.rec, AdapterLayers.of(after, quant), tel,
                    self.pos, active, quant)
        self.pos += 1

    def flagged_slots(self) -> list:
        """Slots whose latched verdict is unhealthy (host read on demand)."""
        flags = self.rec.health.flagged.any(dim=-1).cpu().numpy()
        return [int(s) for s in np.nonzero(flags)[0]]

    def dump(self, directory: str, uid_by_slot=None, registry=None,
             watchdog=None) -> list:
        """One incident bundle per flagged slot; returns the JSON paths.

        Always writes ``flight_summary.json`` (steps recorded, flagged
        slots, detector config): a missing directory means the recorder
        never ran, an empty incident list that it ran and found nothing.
        """
        uid_by_slot = uid_by_slot or {}
        flagged = self.flagged_slots()
        os.makedirs(directory, exist_ok=True)
        summary = {
            "steps_recorded": self.pos,
            "slots": self.slots,
            "flagged_slots": flagged,
            "channels": list(CHANNELS),
            "detectors": list(DETECTORS),
            "config": dataclasses.asdict(self.cfg),
        }
        with open(os.path.join(directory, "flight_summary.json"), "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        return [dump_incident(
                    directory, uid=uid_by_slot.get(s, f"slot{s}"), slot=s,
                    rec=self.rec, cfg=self.cfg, pos=self.pos,
                    registry=registry, watchdog=watchdog)
                for s in flagged]
