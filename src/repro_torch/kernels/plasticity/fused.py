"""Time-fused rollout window: K timesteps x L layers in ONE kernel launch.

The per-step path launches one fleet-step kernel per layer per timestep —
K * L launches per control window, each re-reading and re-writing the whole
state through device memory.  `rollout` runs the entire window as one launch
of ``csrc/rollout.cu``: a persistent grid (as many CTAs as the card holds at
once, `fleet_launch`) whose CTAs keep the shared theta planes in shared
memory and walk the fleet a tile of ``block_b`` streams at a time; each
stream is run by its own group of warps, which holds the stream's weights,
membranes, all L+1 traces and the inter-layer event bus in shared memory
for the window, synchronises only itself between layers, writes the state
back once and meanwhile fetches its next stream (`fleet_plan`).

Semantics, identical to K per-step calls (`rollout_plain` is that loop):

  * the input population's trace is updated from the drive first, gated by
    the active mask;
  * each layer's plasticity reads the UNGATED post trace (equal to the gated
    one for active streams; inactive streams keep their old weights);
  * step k of layer i draws its stochastic round from
    ``fold_seed(seed + k, i)`` and the layer's own flat index;
  * a readout layer's output is its membrane, zeroed for inactive streams;
  * an optional teaching current drives the LAST layer, per step (K, B, M).

``telemetry=True`` (fleet only) also returns the window's per-slot
telemetry row ``(B, 3) float32``, already normalized and gated: mean
|event| and saturated share over the K * L layer steps, and the net weight
motion |w_end - w_start| / (N_i * M_i) per plastic layer over K * n_plastic
(``csrc/rollout.cu``'s telemetry variant; `rollout_plain` is its plain
version).

FLEET mode (``w (B, N, M)``) launches ``csrc/rollout.cu`` (`rollout`);
SHARED-weight mode (``w (N, M)``, batched activations, batch-averaged dw)
launches ``csrc/rollout_shared.cu`` (`rollout_shared`): one cooperative
launch whose co-resident CTAs each own a slice of ONE layer's columns for
the whole window, the layers pipelined: layer i hands each step's events
and traces to layer i + 1 through a bus in device memory (`shared_plan`).

Both kernels take the float window in float32 or bfloat16 (drives, weights,
membranes and traces in one dtype; the rules in that dtype or float32).  A
bfloat16 window computes in float32 throughout, rounds each step's outputs
to bfloat16 and the state once, at write-back (`rollout_plain` documents
the contract); each wrapper counts those launches also in
``<wrapper>.bf16_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.plasticity import fma32
from repro_torch.kernels import _build
from repro_torch.kernels.plasticity import kernel as _k
from repro_torch.kernels.plasticity import quant as Q
from repro_torch.kernels.plasticity import ref as _ref
from repro_torch.obs.telemetry import sat_threshold, sat_threshold_q

MAX_LAYERS = 8                    # ff::kMaxLayers

_P = ctypes.c_void_p


class _RolloutArgs(ctypes.Structure):
    """``RolloutArgs`` of csrc/rollout.cu."""
    _fields_ = [(name, _P) for name in (
        "drives", "outs", "teach", "active", "seed")] + [
        (name, _P * MAX_LAYERS) for name in (
            "w_in", "w_out", "theta", "scale", "v_in", "v_out")] + [
        ("tr_in", _P * (MAX_LAYERS + 1)), ("tr_out", _P * (MAX_LAYERS + 1)),
        ("sizes", ctypes.c_int * (MAX_LAYERS + 1))] + [
        (name, ctypes.c_int) for name in (
            "n_layers", "k_steps", "batch", "block_b", "spiking_mask",
            "plastic_mask", "theta_in_smem")] + [
        ("w_clip", ctypes.c_float), ("f", _k.FParams), ("q", _k.QParams),
        ("tel", _P), ("telemetry", ctypes.c_int), ("sat_q", ctypes.c_int),
        ("sat_f", ctypes.c_float), ("bf16", ctypes.c_int),
        ("theta_bf16", ctypes.c_int), ("warps", ctypes.c_int),
        ("double_buffer", ctypes.c_int), ("ctas", ctypes.c_int)]


FLEET_SYNAPSES_PER_THREAD = 16  # of the widest layer, per step: sets warps
MAX_TILE = 8                    # streams a CTA holds where no tile is named


def _state_bytes(sizes, wb: int, sb: int) -> int:
    """One stream's weights (``wb`` bytes a weight), membranes and traces
    (``sb`` an element), each array 16-byte aligned."""
    return (sum(_k._al(sizes[i] * sizes[i + 1] * wb)
                + _k._al(sizes[i + 1] * sb)
                for i in range(len(sizes) - 1))
            + sum(_k._al(n * sb) for n in sizes))


def fleet_plan(sizes, batch: int, block_b: int, plastic, *, quant: bool,
               limit: int, w_bytes: int = 4, s_bytes: int = 4,
               theta_bytes: int = 4, sms: int | None = None,
               occupancy: int | None = None,
               warps: int | None = None) -> dict:
    """The fleet kernel's plan (``csrc/rollout.cu``): ``block_b`` streams
    per tile, the tile's streams each run by a group of ``warps`` warps.

    * ``tile``: min(block_b, B), at most 32 streams (1024 threads).
    * ``warps``: a power of two, as many as give each thread about
      `FLEET_SYNAPSES_PER_THREAD` synapses of the widest layer a step, at
      most 1024 / (32 * tile); 1 when the tile has more streams than the
      CTA has named barriers.  ``warps=`` takes another's (a larger
      tile's: a shard planned as its pool, `fleet_launch`).
    * ``buffers``: "double" (the next stream is fetched into a second state
      buffer while the group computes) or, for a bfloat16 window, "staged"
      (its next stream lands raw beside the float32 state buffer); where
      those do not fit, "single" (the next stream is loaded once the last
      has left).
    * ``theta``: "smem" when the rules fit beside the slots, else "l2".
      Preference: resident rules with two buffers, with one, then the rules
      through L2 with two, with one; raises ValueError where none fits —
      the kernel does not fall back.
    * ``role_smem``: bytes of the rules, a state buffer (in fixed point
      also the stream's scales and seed), the spare buffer, the bus and
      the spare buffer's mbarriers; ``slot`` the last four, per stream;
      ``smem`` the CTA's total with the rules' mbarrier.
    * With ``sms`` and ``occupancy`` (CTAs an SM holds, by
      `cudaOccupancyMaxActiveBlocksPerMultiprocessor`): ``ctas_per_sm`` and
      ``ctas``, the persistent grid, sms * occupancy CTAs or fewer where
      the tiles run out.

    ``w_bytes``/``s_bytes``: a weight and a state element in device memory
    (1/4 int8, 2/2 bfloat16, 4/4 float32); ``theta_bytes`` a coefficient.
    """
    n_layers = len(sizes) - 1
    tile = max(1, min(block_b, batch))
    if 32 * tile > _k.MAX_THREADS:
        raise ValueError(
            f"fleet rollout: block_b={block_b} streams a tile need "
            f"{32 * tile} threads; a CTA has {_k.MAX_THREADS}")
    if warps is None:
        warps = 1
        if tile <= _k.BARRIER_GROUPS:
            widest = max(sizes[i] * sizes[i + 1] for i in range(n_layers))
            want = -(-widest // (32 * FLEET_SYNAPSES_PER_THREAD))
            cap = _k.MAX_THREADS // (32 * tile)
            while warps * 2 <= cap and warps < want:
                warps *= 2
    elif (warps < 1 or warps & (warps - 1) or 32 * warps * tile
          > _k.MAX_THREADS or (warps > 1 and tile > _k.BARRIER_GROUPS)):
        raise ValueError(f"fleet rollout: {warps} warps a stream do not fit "
                         f"a tile of {tile} streams")
    staged = not quant and s_bytes == 2
    state = _state_bytes(sizes, 1 if quant else 4, 4) \
        + (_k._al(4 * (n_layers + 1)) if quant else 0)
    bus = _k._al(2 * max(sizes) * 4)
    th = sum(4 * sizes[i] * sizes[i + 1] for i in range(n_layers)
             if plastic[i])
    ahead = "staged" if staged else "double"
    for theta, buffers in (("smem", ahead), ("smem", "single"),
                           ("l2", ahead), ("l2", "single")):
        spare = (0 if buffers == "single" else
                 _state_bytes(sizes, 2, 2) if staged else state)
        th_b = _k._al(th * theta_bytes) if theta == "smem" else 0
        bars = _k.BARRIER_BYTES if spare else 0
        slot = state + spare + bus + bars
        smem = _k.BARRIER_BYTES + th_b + tile * slot
        if smem <= limit:
            break
    else:
        raise ValueError(
            f"fleet rollout: {tile} streams of layer sizes {list(sizes)} "
            f"need {smem} bytes of shared memory even with the rules read "
            f"through L2 and one buffer a stream; a CTA may use {limit}; "
            f"lower block_b")
    plan = dict(tile=tile, warps=warps, threads=32 * warps * tile,
                buffers=buffers, theta=theta,
                role_smem=dict(theta=th_b, state=state, spare=spare, bus=bus,
                               barriers=bars, slot=slot),
                smem=smem)
    if sms is not None and occupancy is not None:
        plan.update(ctas_per_sm=occupancy,
                    ctas=min(sms * occupancy, -(-batch // tile)))
    return plan


def fleet_fit(sizes, batch: int, plastic, **kw) -> dict:
    """`fleet_plan` at the largest tile of at most `MAX_TILE` streams that
    fits (``kw`` as `fleet_plan` takes them).  Raises ValueError where not
    even one stream fits: the window does not fall back to per-step
    launches or to the plain version."""
    for block_b in range(min(MAX_TILE, batch), 0, -1):
        try:
            return fleet_plan(sizes, batch, block_b, plastic, **kw)
        except ValueError as e:
            err = e
    raise ValueError(
        f"fleet rollout: one stream of layer sizes {list(sizes)} does not "
        f"fit a CTA ({err}); such widths wait for ROADMAP.md Queue 2's "
        f"follow-up '#3 fleet for adapter widths whose stream exceeds an "
        f"SM'")


class _SharedRolloutArgs(ctypes.Structure):
    """``SharedRolloutArgs`` of csrc/rollout_shared.cu."""
    _fields_ = [(name, _P) for name in (
        "drives", "outs", "teach", "seed")] + [
        (name, _P * MAX_LAYERS) for name in (
            "w_in", "w_out", "theta", "scale", "v_in", "v_out")] + [
        ("tr_in", _P * (MAX_LAYERS + 1)), ("tr_out", _P * (MAX_LAYERS + 1)),
        ("bus", _P * MAX_LAYERS), ("progress", _P),
        ("sizes", ctypes.c_int * (MAX_LAYERS + 1)),
        ("first_cta", ctypes.c_int * (MAX_LAYERS + 1))] + [
        (name, ctypes.c_int * MAX_LAYERS) for name in (
            "cols", "w_route", "w_width", "w_box", "th_route", "th_width",
            "th_box")] + [
        (name, ctypes.c_int) for name in (
            "n_layers", "k_steps", "batch", "bus_depth", "spiking_mask",
            "plastic_mask")] + [
        ("base", ctypes.c_uint), ("w_clip", ctypes.c_float),
        ("f", _k.FParams), ("q", _k.QParams), ("bf16", ctypes.c_int),
        ("theta_bf16", ctypes.c_int)]


SHARED_THREADS, SHARED_CHUNK = 512, 8      # csrc/rollout_shared.cu
SHARED_BUS_DEPTH = 32          # steps one layer boundary's bus holds at most
SHARED_BUS_BYTES = 16 << 20    # and its bound in device memory
TMA_BOX_ROWS = 256             # rows of one TMA box at most
# How a plane reaches shared memory (csrc/rollout_shared.cu Route): a TMA
# box, cp.async pieces, cp.async of the 4-byte words covering each row's
# span (repacked), or not at all (theta read through L2).
ROUTES = ("tma", "cp.async", "cp.async words", "l2")


def shared_route(rows: int, m: int, c: int, e: int) -> tuple:
    """``(route, width, box_rows)`` of the owned ``[rows) x [c)`` block of a
    row-major ``(rows, m)`` plane of ``e``-byte elements: TMA where its
    16-byte rules hold (row stride and box width multiples of 16 bytes), in
    boxes of at most 256 rows whose bytes are a multiple of 128, stored back
    16 bytes a piece; else cp.async of the widest piece (16, 8 or 4 bytes)
    that divides the row stride and the owned width; else cp.async of the
    4-byte words covering each row's span."""
    row_b, span_b = m * e, c * e
    if row_b % 16 == 0 and span_b % 16 == 0:
        n_box = -(-rows // TMA_BOX_ROWS)
        step = max(1, 128 // span_b)
        return "tma", 16, _k._al(-(-rows // n_box), step)
    for width in (16, 8, 4):
        if row_b % width == 0 and span_b % width == 0:
            return "cp.async", width, 0
    return "cp.async words", 4, 0


def shared_smem_bytes(n: int, c: int, batch: int, quant: bool,
                      w_bytes: int, theta_bytes: int, w_plane: tuple,
                      th_plane: tuple | None) -> int:
    """Shared memory of one CTA owning ``c`` columns of a layer of ``n``
    inputs: its theta slab if resident (``th_plane`` a TMA or cp.async route;
    ``theta_bytes`` a coefficient), the weight slab (float32 on chip in a
    bfloat16 window, int8 in fixed point), the staging area of a bfloat16
    or word-copied slab (``w_bytes`` a weight in device memory), membranes
    and post traces, the input trace (layer 0), the staged events and pre
    traces, the pre/post sums, the partial-sum buffer, two mbarriers and
    128 bytes to align the base — the layout of ``csrc/rollout_shared.cu``
    (TMA slabs rounded up to whole boxes)."""
    total = 0
    if th_plane is not None and th_plane[0] in ("tma", "cp.async"):
        rows = _k._al(4 * n, th_plane[2]) if th_plane[0] == "tma" else 4 * n
        total += _k._al(rows * c * theta_bytes, 128)
    w_rows = _k._al(n, w_plane[2]) if w_plane[0] == "tma" else n
    staged = (not quant and w_bytes == 2) or w_plane[0] == "cp.async words"
    total += _k._al((n if staged else w_rows) * c * (1 if quant else 4), 128)
    if staged:
        pitch = (4 * (-(-c * w_bytes // 4) + 1)
                 if w_plane[0] == "cp.async words" else c * w_bytes)
        total += _k._al(w_rows * pitch, 128)
    total += 2 * _k._al(batch * c * 4) + 2 * _k._al(batch * n * 4)
    return (total + _k._al(n * 4) + _k._al(32 * 4)
            + _k._al(SHARED_THREADS // 32 * SHARED_CHUNK * 32 * 4) + 16 + 128)


def shared_plan(sizes, batch: int, plastic, quant: bool, sms: int,
                limit: int, w_bytes: int = 4, theta_bytes: int = 4) -> dict:
    """Layers pipelined across co-resident CTAs: each CTA owns ``c_i``
    columns of ONE layer i (a power of two <= 32).  Starting from one
    column a CTA, the layer whose doubled share of synapses (N_i * 2 c_i) is
    smallest doubles until all layers fit ``sms`` CTAs, so the slowest
    role's work stays least.  Per layer: the copy route of w and of theta
    (`shared_route`; theta is read through L2 where its slab would not fit
    or cannot be copied 4 bytes at a time), the role's shared memory; and
    the bus depth: `SHARED_BUS_DEPTH` steps, fewer where a boundary's bus
    would exceed `SHARED_BUS_BYTES`.  Raises ValueError where the layers
    cannot all be co-resident (one CTA a SM) or a role does not fit."""
    n_layers = len(sizes) - 1
    cols = [1] * n_layers
    ctas = lambda: [-(-sizes[i + 1] // cols[i]) for i in range(n_layers)]
    while sum(ctas()) > sms:
        grow = [(sizes[i] * cols[i] * 2, i) for i, g in enumerate(ctas())
                if g > 1 and cols[i] < 32]
        if not grow:
            raise ValueError(
                f"shared-weight rollout: layers {list(sizes)} need "
                f"{sum(ctas())} co-resident CTAs of at most 32 columns each; "
                f"the card has {sms} SMs")
        cols[min(grow)[1]] *= 2
    w_planes, th_planes, role_smem = [], [], []
    for i in range(n_layers):
        n, m, c = sizes[i], sizes[i + 1], cols[i]
        w_plane = shared_route(n, m, c, w_bytes)
        th_plane = shared_route(4 * n, m, c, theta_bytes) \
            if plastic[i] else None
        if th_plane is not None and th_plane[0] == "cp.async words":
            th_plane = ("l2", 0, 0)
        smem = shared_smem_bytes(n, c, batch, quant, w_bytes, theta_bytes,
                                 w_plane, th_plane)
        if smem > limit and th_plane is not None:
            th_plane = ("l2", 0, 0)
            smem = shared_smem_bytes(n, c, batch, quant, w_bytes,
                                     theta_bytes, w_plane, th_plane)
        if smem > limit:
            raise ValueError(
                f"shared-weight rollout: a CTA of layer {i} ({n} x {c} "
                f"synapses, B = {batch}) needs {smem} bytes of shared "
                f"memory; a CTA may use {limit}")
        w_planes.append(w_plane)
        th_planes.append(th_plane)
        role_smem.append(smem)
    widest = max(sizes[1:-1], default=0)
    depth = (min(SHARED_BUS_DEPTH,
                 max(2, SHARED_BUS_BYTES // (8 * batch * widest)))
             if widest else 0)
    return dict(ctas=ctas(), cols=cols, w=w_planes, theta=th_planes,
                role_smem=role_smem, smem=max(role_smem), bus_depth=depth)


def _event_units(out, spiking: bool, qcfg):
    """|events| in event units from a layer's gated output: a readout's
    output is its membrane, mapped back through its event nonlinearity
    (tanh, or the fixed-point clip); zeroed outputs stay zero."""
    if qcfg is not None:
        ev = out if spiking else torch.clamp(out, -qcfg.one, qcfg.one)
        return ev.abs().float() / qcfg.one
    return (out if spiking else torch.tanh(out)).abs()


def _window_telemetry(acc, ws0, ws, plastic, scales, active, k_steps, qcfg):
    """Finalize a window's (B, 2) [spike, saturation] accumulator and net
    weight motion into the gated (B, 3) row (`fused.py:256-283` of the JAX
    package)."""
    n_layers = len(ws)
    kl = float(k_steps * n_layers)
    spike_rate, sat_frac = acc[:, 0] / kl, acc[:, 1] / kl
    plast = [i for i in range(n_layers) if plastic[i]]
    mean_dw = torch.zeros_like(spike_rate)
    if plast:
        for i in plast:
            n_i, m_i = ws[i].shape[-2], ws[i].shape[-1]
            if qcfg is not None:
                d = (ws[i].to(torch.int32) - ws0[i].to(torch.int32)).abs()
                per_slot = d.sum((1, 2), dtype=torch.int32).float() \
                    * torch.as_tensor(scales[i], dtype=torch.float32,
                                      device=acc.device).reshape(-1)
            else:
                per_slot = (ws[i] - ws0[i]).abs().sum((1, 2))
            mean_dw = mean_dw + per_slot / (n_i * m_i)
        mean_dw = mean_dw / float(k_steps * len(plast))
    row = torch.stack([spike_rate, mean_dw, sat_frac], dim=1)
    if active is not None:
        # by selection: a lost slot's poisoned (NaN) rows report zeros
        row = torch.where(active.reshape(-1, 1).bool(), row, 0.0)
    return row


def rollout_plain(drives, ws, thetas, vs, traces, *, spiking, plastic,
                  tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
                  trace_decay: float = 0.8, w_clip: float = 4.0, qcfg=None,
                  scales=None, seed=None, teach=None, active=None,
                  telemetry: bool = False):
    """The window as a Python loop over K of the plain per-layer steps.

    Arguments as `rollout`; also takes shared weights ``(N, M)``.  Returns
    ``(outs, ws, vs, traces)`` with outs (K, B, M_last), plus the (B, 3)
    telemetry row with ``telemetry`` (fleet only).

    A float window in another dtype than float32 (bfloat16) runs as the
    kernel does (`fused.py:112-122`, `:251`, `:275-278` of the JAX
    package): state, weights and the inter-layer events in float32 for all
    K steps, the outputs rounded to the drives' dtype, and weights,
    membranes and traces rounded once, at write-back.
    """
    if qcfg is None and drives.dtype != torch.float32:
        up = lambda ts: [None if t is None else t.float() for t in ts]
        res = rollout_plain(
            drives.float(), up(ws), up(thetas), up(vs), up(traces),
            spiking=spiking, plastic=plastic, tau_m=tau_m, v_th=v_th,
            v_reset=v_reset, trace_decay=trace_decay, w_clip=w_clip,
            teach=None if teach is None else teach.float(), active=active,
            telemetry=telemetry)
        back = lambda got, like: tuple(g.to(t.dtype)
                                       for g, t in zip(got, like))
        return (res[0].to(drives.dtype), back(res[1], ws), back(res[2], vs),
                back(res[3], traces)) + tuple(res[4:])
    n_layers = len(ws)
    fleet = ws[0].ndim == 3
    if telemetry and not fleet:
        raise ValueError("telemetry is a fleet-mode contract (per-slot rows "
                         "need a leading stream rank)")
    ws0 = ws
    ws, vs, trs = list(ws), list(vs), list(traces)
    gate = None if active is None else active.reshape(-1).bool()[:, None]
    acc = (torch.zeros((drives.shape[1], 2), dtype=torch.float32,
                       device=drives.device) if telemetry else None)
    sat_thr = (None if not telemetry else sat_threshold(v_th)
               if qcfg is None else sat_threshold_q(v_th, qcfg))
    outs = []
    for k in range(drives.shape[0]):
        x = drives[k]
        if qcfg is not None:
            tr0 = Q.trace_update_q(trs[0], x, qcfg)
        else:
            tr0 = fma32(trace_decay, trs[0], x)
        trs[0] = tr0 if gate is None else torch.where(gate, tr0, trs[0])
        for i in range(n_layers):
            kw = dict(v_th=v_th, v_reset=v_reset, w_clip=w_clip,
                      plastic=plastic[i], spiking=spiking[i],
                      teach=None if teach is None or i < n_layers - 1
                      else teach[k])
            if fleet:
                kw["active"] = active
            if qcfg is not None:
                fn = (_ref.dual_engine_fleet_step_q if fleet
                      else _ref.dual_engine_step_q)
                res = fn(x, ws[i], scales[i], thetas[i], vs[i], trs[i],
                         trs[i + 1], qcfg=qcfg,
                         seed=Q.fold_seed(seed.long() + k, i), **kw)
            else:
                fn = (_ref.dual_engine_fleet_step if fleet
                      else _ref.dual_engine_step)
                res = fn(x, ws[i], thetas[i], vs[i], trs[i], trs[i + 1],
                         tau_m=tau_m, trace_decay=trace_decay, **kw)
            events, vs[i], trs[i + 1], ws[i] = res
            x = events if spiking[i] else vs[i]
            if gate is not None and not spiking[i]:
                x = torch.where(gate, x, torch.zeros_like(x))
            if telemetry:
                m_i = x.shape[-1]
                sat = (vs[i].abs() >= sat_thr).float()
                acc = acc + torch.stack(
                    [_event_units(x, spiking[i], qcfg).sum(1) / m_i,
                     sat.sum(1) / m_i], dim=1)
        outs.append(x)
    out = (torch.stack(outs), tuple(ws), tuple(vs), tuple(trs))
    if not telemetry:
        return out
    return out + (_window_telemetry(acc, ws0, ws, plastic, scales, active,
                                    drives.shape[0], qcfg),)


def _layer_flags(spiking, plastic, thetas):
    """Per-layer flags as bool tuples; a plastic layer needs its theta."""
    plastic = tuple(bool(p) for p in plastic)
    for i, p in enumerate(plastic):
        if p and thetas[i] is None:
            raise ValueError(f"layer {i} marked plastic but theta is None")
    return tuple(bool(s) for s in spiking), plastic


def _window_args(a, drives, ws, thetas, vs, traces, *, fleet, spiking,
                 plastic, tau_m, v_th, v_reset, trace_decay, w_clip, qcfg,
                 scales, seed, teach):
    """Check a window's operands, allocate its outputs and fill the fields
    both rollout kernels' argument structs share.  Returns ``((outs, ws,
    vs, traces), keep, theta_bytes)``: ``keep`` holds the checked inputs
    alive until the launch."""
    n_layers = len(ws)
    if n_layers > MAX_LAYERS:
        raise ValueError(f"rollout kernel takes at most {MAX_LAYERS} layers")
    quant = qcfg is not None
    k_steps, b, n0 = drives.shape
    dev = drives.device
    sizes = [n0] + [w.shape[-1] for w in ws]
    lead = (b,) if fleet else ()          # fleet: one weight set per stream
    if quant:
        state_dt, w_dt, th_dt = torch.int32, torch.int8, torch.float32
    else:
        state_dt = w_dt = _k.float_dtype(
            "rollout kernel",
            [("drives", drives)] + [(f"w[{i}]", w) for i, w in enumerate(ws)]
            + [(f"v[{i}]", v) for i, v in enumerate(vs)]
            + [(f"trace[{i}]", t) for i, t in enumerate(traces)],
            [thetas[i] for i in range(n_layers) if plastic[i]])
        th_dts = {thetas[i].dtype for i in range(n_layers) if plastic[i]}
        if len(th_dts) > 1:
            raise ValueError(f"rollout kernel: every layer's theta in one "
                             f"dtype; got {sorted(map(str, th_dts))}")
        th_dt = th_dts.pop() if th_dts else torch.float32
    drives = _k.expect("drives", drives, (k_steps, b, n0), state_dt, dev)
    ws = [_k.expect(f"w[{i}]", ws[i], (*lead, sizes[i], sizes[i + 1]), w_dt,
                    dev) for i in range(n_layers)]
    vs = [_k.expect(f"v[{i}]", vs[i], (b, sizes[i + 1]), state_dt, dev)
          for i in range(n_layers)]
    trs = [_k.expect(f"trace[{i}]", traces[i], (b, sizes[i]), state_dt, dev)
           for i in range(n_layers + 1)]
    ths = [_k.expect(f"theta[{i}]", thetas[i], (4, sizes[i], sizes[i + 1]),
                     th_dt, dev) if plastic[i] else None
           for i in range(n_layers)]
    if teach is not None:      # float32 on the float kernels
        teach = teach.to(device=dev, dtype=torch.int32 if quant else
                         torch.float32).expand(
            k_steps, b, sizes[-1]).contiguous()
    per = b if fleet else 1               # scales and seeds per stream
    scs = [_k.per_stream(s, per, torch.float32, dev) for s in scales] \
        if quant else [None] * n_layers
    sd = _k.per_stream(seed, per, torch.int32, dev) if quant else None
    outs = torch.empty((k_steps, b, sizes[-1]), dtype=state_dt, device=dev)
    w_out = [torch.empty_like(w) for w in ws]
    v_out = [torch.empty_like(v) for v in vs]
    tr_out = [torch.empty_like(t) for t in trs]
    a.drives, a.outs = _k.ptr(drives), _k.ptr(outs)
    a.teach, a.seed = _k.ptr(teach), _k.ptr(sd)
    for i in range(n_layers):
        a.w_in[i], a.w_out[i] = _k.ptr(ws[i]), _k.ptr(w_out[i])
        a.theta[i], a.scale[i] = _k.ptr(ths[i]), _k.ptr(scs[i])
        a.v_in[i], a.v_out[i] = _k.ptr(vs[i]), _k.ptr(v_out[i])
    for i in range(n_layers + 1):
        a.tr_in[i], a.tr_out[i] = _k.ptr(trs[i]), _k.ptr(tr_out[i])
        a.sizes[i] = sizes[i]
    a.n_layers, a.k_steps, a.batch = n_layers, k_steps, b
    a.spiking_mask = sum(1 << i for i in range(n_layers) if spiking[i])
    a.plastic_mask = sum(1 << i for i in range(n_layers) if plastic[i])
    a.w_clip = w_clip
    a.f = _k.f_params(tau_m, v_th, v_reset, trace_decay)
    if quant:
        a.q = _k.q_params(qcfg, v_th, v_reset, batch=1 if fleet else b)
    a.bf16 = int(state_dt == torch.bfloat16)
    a.theta_bf16 = int(th_dt == torch.bfloat16)
    alive = (drives, ws, vs, trs, ths, teach, scs, sd)
    return ((outs, tuple(w_out), tuple(v_out), tuple(tr_out)), alive,
            th_dt.itemsize)


_fleet_plans: dict = {}         # plan key -> fleet_plan with its grid


def _fleet_entry(name: str):
    """``rollout`` (args, quant, smem, stream) or ``rollout_occupancy``
    (args, quant, smem, &blocks) of csrc/rollout.cu."""
    fn = getattr(_build.library("rollout.cu"), name)
    fn.argtypes = [ctypes.POINTER(_RolloutArgs), ctypes.c_int,
                   ctypes.c_size_t,
                   _P if name == "rollout" else ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return fn


def _fill_plan(a, plan: dict) -> None:
    """The plan's fields of a `_RolloutArgs`."""
    a.block_b, a.warps, a.ctas = plan["tile"], plan["warps"], \
        plan.get("ctas", 1)
    a.theta_in_smem = int(plan["theta"] == "smem")
    a.double_buffer = int(plan["buffers"] != "single")


def fleet_launch(device, sizes, batch: int, block_b, plastic, *,
                 quant: bool, telemetry: bool = False, bf16: bool = False,
                 theta_bf16: bool = False, pool: int | None = None) -> dict:
    """`fleet_plan` on ``device`` with its persistent grid: the SM count and
    the CTAs one SM holds of the instantiation the flags select, asked of
    the card once per plan key (sizes, B, block_b, flags, device, pool).
    ``block_b=None`` takes the largest tile that fits (`fleet_fit`).

    ``pool``: the launch is a shard of a pool of that many streams; its
    tile is at most the pool's and its warps a stream are the pool's, so
    each stream sums in the order the whole pool's launch would."""
    plastic = tuple(bool(p) for p in plastic)
    pool = None if pool in (None, batch) else int(pool)
    key = (tuple(sizes), batch, block_b, plastic, quant, telemetry, bf16,
           theta_bf16, torch.device(device), pool)
    plan = _fleet_plans.get(key)
    if plan is None:
        wb, sb = (1, 4) if quant else (2, 2) if bf16 else (4, 4)
        kw = dict(quant=quant, limit=_k.smem_limit(device), w_bytes=wb,
                  s_bytes=sb, theta_bytes=2 if theta_bf16 else 4)
        if pool is not None:
            whole = (fleet_fit(sizes, pool, plastic, **kw) if block_b is None
                     else fleet_plan(sizes, pool, block_b, plastic, **kw))
            block_b, kw["warps"] = whole["tile"], whole["warps"]
        plan = (fleet_fit(sizes, batch, plastic, **kw) if block_b is None
                else fleet_plan(sizes, batch, block_b, plastic, **kw))
        a = _RolloutArgs()
        a.n_layers = len(sizes) - 1
        for i, n in enumerate(sizes):
            a.sizes[i] = n
        a.plastic_mask = sum(1 << i for i, p in enumerate(plastic) if p)
        a.telemetry, a.bf16, a.theta_bf16 = int(telemetry), int(bf16), \
            int(theta_bf16)
        _fill_plan(a, plan)
        blocks = ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(_fleet_entry("rollout_occupancy")(
                ctypes.byref(a), int(quant), plan["smem"],
                ctypes.byref(blocks)), "rollout_occupancy")
            sms = torch.cuda.get_device_properties(
                device).multi_processor_count
        if blocks.value < 1:
            raise ValueError(
                f"fleet rollout: a CTA of {plan['threads']} threads and "
                f"{plan['smem']} bytes does not fit an SM")
        plan = _fleet_plans[key] = fleet_plan(
            sizes, batch, plan["tile"], plastic, sms=sms,
            occupancy=blocks.value, **kw)
    return plan


def rollout(drives, ws, thetas, vs, traces, *, spiking, plastic,
            tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
            trace_decay: float = 0.8, w_clip: float = 4.0, qcfg=None,
            scales=None, seed=None, teach=None, active=None,
            block_b=None, telemetry: bool = False):
    """K fused timesteps of the whole layer stack.

    Args:
      drives:  (K, B, N0) time-major input window (int32 fixed point when
               ``qcfg``, else float32 or bfloat16, the state's dtype).
      ws:      per-layer fleet weights (B, N_i, M_i), or shared weights
               (N_i, M_i) (`rollout_shared`); int8 when ``qcfg``.
      thetas:  per-layer packed (4, N_i, M_i) rules; None where not plastic.
      vs:      per-layer membranes (B, M_i).
      traces:  L+1 population traces (B, N_i); traces[0] is the input.
      spiking/plastic: per-layer bool sequences.
      qcfg/scales/seed: fixed-point mode — per-layer (B,) weight scales and
               the (B,) base step counters.
      teach:   optional (K, B, M_last) teaching current for the last layer.
      active:  optional (B,) slot mask, constant over the window.
      block_b: streams per tile: the CTA's stream groups, each running one
               stream's window at a time (`fleet_plan`); None takes the
               largest tile of at most `MAX_TILE` that fits (`fleet_fit`).
      telemetry: fleet only — also return the window's (B, 3) telemetry
               row (the kernel's telemetry variant).

    Returns ``(outs, ws, vs, traces)``, outs (K, B, M_last), plus the
    telemetry row with ``telemetry``.  A CPU tensor runs `rollout_plain`; a
    CUDA tensor launches the fleet kernel (counted in
    ``rollout.launches``, its telemetry variant also in
    ``rollout.telemetry_launches``; its plan kept in ``rollout.last_plan``)
    or, for shared weights, `rollout_shared`.
    """
    spiking, plastic = _layer_flags(spiking, plastic, thetas)
    if not _k.on_card(drives):
        return rollout_plain(
            drives, ws, thetas, vs, traces, spiking=spiking, plastic=plastic,
            tau_m=tau_m, v_th=v_th, v_reset=v_reset, trace_decay=trace_decay,
            w_clip=w_clip, qcfg=qcfg, scales=scales, seed=seed, teach=teach,
            active=active, telemetry=telemetry)
    if ws[0].ndim != 3:
        if active is not None:
            raise ValueError("active slot masks are a fleet-mode contract")
        if telemetry:
            raise ValueError("telemetry is a fleet-mode contract (per-slot "
                             "rows need a leading stream rank)")
        return rollout_shared(
            drives, ws, thetas, vs, traces, spiking=spiking, plastic=plastic,
            tau_m=tau_m, v_th=v_th, v_reset=v_reset, trace_decay=trace_decay,
            w_clip=w_clip, qcfg=qcfg, scales=scales, seed=seed, teach=teach)
    b, quant = drives.shape[1], qcfg is not None
    sizes = [drives.shape[2]] + [w.shape[-1] for w in ws]
    a = _RolloutArgs()
    out, alive, _ = _window_args(
        a, drives, ws, thetas, vs, traces, fleet=True, spiking=spiking,
        plastic=plastic, tau_m=tau_m, v_th=v_th, v_reset=v_reset,
        trace_decay=trace_decay, w_clip=w_clip, qcfg=qcfg, scales=scales,
        seed=seed, teach=teach)
    keep = []                 # 16-byte aligned copies of offset rules
    for i, th in enumerate(alive[4]):
        if th is not None and th.data_ptr() % 16:
            keep.append(th.clone())
            a.theta[i] = keep[-1].data_ptr()
    act = _k.active_mask(active, b, drives.device)
    a.active = _k.ptr(act)
    tel = (torch.empty((b, 3), dtype=torch.float32, device=drives.device)
           if telemetry else None)
    a.tel, a.telemetry = _k.ptr(tel), int(telemetry)
    a.sat_q = sat_threshold_q(v_th, qcfg) if quant else 0
    a.sat_f = sat_threshold(v_th)
    plan = fleet_launch(drives.device, sizes, b, block_b, plastic,
                        quant=quant, telemetry=telemetry, bf16=bool(a.bf16),
                        theta_bf16=bool(a.theta_bf16),
                        pool=_k.pool_batch(b))
    _fill_plan(a, plan)
    _build.check(_fleet_entry("rollout")(ctypes.byref(a), int(quant),
                                         plan["smem"], _k.stream_of(drives)),
                 "rollout")
    rollout.last_plan = plan
    rollout.launches += 1
    rollout.telemetry_launches += int(telemetry)
    rollout.bf16_launches += a.bf16
    return out if tel is None else out + (tel,)


rollout.launches = 0
rollout.telemetry_launches = 0      # the telemetry variant's share
rollout.bf16_launches = 0           # the bfloat16 instantiation's share
rollout.last_plan = None            # the last fleet launch's plan


_shared_plans: dict = {}        # plan key -> shared_plan
_shared_work: dict = {}         # (plan key, stream) -> [bus, progress, ticket]
_ROUTE_CODES = {name: code for code, name in enumerate(ROUTES)}
_NO_THETA = len(ROUTES)         # csrc/rollout_shared.cu kNone


def _shared_launcher():
    fn = _build.library("rollout_shared.cu").rollout_shared
    if fn.restype is not ctypes.c_int:
        fn.argtypes = [ctypes.POINTER(_SharedRolloutArgs), ctypes.c_int,
                       ctypes.c_size_t, _P]
        fn.restype = ctypes.c_int
    return fn


def rollout_shared(drives, ws, thetas, vs, traces, *, spiking, plastic,
                   tau_m: float = 2.0, v_th: float = 1.0,
                   v_reset: float = 0.0, trace_decay: float = 0.8,
                   w_clip: float = 4.0, qcfg=None, scales=None, seed=None,
                   teach=None):
    """K fused timesteps of a shared-weight layer stack in ONE cooperative
    launch of ``csrc/rollout_shared.cu`` (counted in
    ``rollout_shared.launches``), its layers pipelined across CTAs as
    `shared_plan` assigns them (the plan is kept per sizes, B, flags,
    dtypes and device; the bus and the CTAs' progress words per plan and
    stream).

    Arguments as `rollout` with ws (N_i, M_i), per-layer scales () and a
    scalar seed; state is batched (B, ·).  A CPU tensor runs
    `rollout_plain`.  Raises where the layers cannot be co-resident.
    """
    spiking, plastic = _layer_flags(spiking, plastic, thetas)
    if not _k.on_card(drives):
        return rollout_plain(
            drives, ws, thetas, vs, traces, spiking=spiking, plastic=plastic,
            tau_m=tau_m, v_th=v_th, v_reset=v_reset, trace_decay=trace_decay,
            w_clip=w_clip, qcfg=qcfg, scales=scales, seed=seed, teach=teach)
    k_steps, b, n_layers = drives.shape[0], drives.shape[1], len(ws)
    quant = qcfg is not None
    sizes = [drives.shape[2]] + [w.shape[-1] for w in ws]
    a = _SharedRolloutArgs()
    out, alive, theta_bytes = _window_args(
        a, drives, ws, thetas, vs, traces, fleet=False, spiking=spiking,
        plastic=plastic, tau_m=tau_m, v_th=v_th, v_reset=v_reset,
        trace_decay=trace_decay, w_clip=w_clip, qcfg=qcfg, scales=scales,
        seed=seed, teach=teach)
    dev = drives.device
    w_bytes = 1 if quant else 2 if a.bf16 else 4
    key = (tuple(sizes), b, plastic, quant, w_bytes, theta_bytes, dev)
    plan = _shared_plans.get(key)
    if plan is None:
        plan = _shared_plans[key] = shared_plan(
            sizes, b, plastic, quant,
            torch.cuda.get_device_properties(dev).multi_processor_count,
            _k.smem_limit(dev), w_bytes, theta_bytes)
    stream = _k.stream_of(drives)
    work = _shared_work.get((key, stream))
    if work is None:
        dt = torch.int32 if quant else torch.float32
        work = _shared_work[(key, stream)] = [
            [torch.empty((plan["bus_depth"], 2, b, m), dtype=dt, device=dev)
             for m in sizes[1:-1]],
            torch.zeros(sum(plan["ctas"]), dtype=torch.int32, device=dev), 0]
    bus, progress, ticket = work
    keep = []                 # 16-byte aligned copies of offset views
    first = 0
    for i in range(n_layers):
        for field, checked in (("w_in", alive[1]), ("theta", alive[4])):
            p = getattr(a, field)[i]
            if p is not None and p % 16:
                keep.append(checked[i].clone())
                getattr(a, field)[i] = keep[-1].data_ptr()
        w_plane, th_plane = plan["w"][i], plan["theta"][i]
        a.first_cta[i], a.cols[i] = first, plan["cols"][i]
        first += plan["ctas"][i]
        a.w_route[i] = _ROUTE_CODES[w_plane[0]]
        a.w_width[i], a.w_box[i] = w_plane[1], w_plane[2]
        a.th_route[i] = (_NO_THETA if th_plane is None
                         else _ROUTE_CODES[th_plane[0]])
        a.th_width[i], a.th_box[i] = (0, 0) if th_plane is None \
            else th_plane[1:]
        a.bus[i] = _k.ptr(bus[i]) if i < n_layers - 1 else None
    a.first_cta[n_layers] = first
    a.progress, a.bus_depth, a.base = _k.ptr(progress), plan["bus_depth"], \
        ticket
    err = _shared_launcher()(ctypes.byref(a), int(quant), plan["smem"],
                             stream)
    if err == 82:        # cudaErrorCooperativeLaunchTooLarge
        raise RuntimeError(
            f"shared-weight rollout: {first} CTAs of {plan['smem']} bytes "
            f"cannot all be resident on this card; the window needs one "
            f"co-resident grid")
    _build.check(err, "rollout_shared")
    work[2] = (ticket + k_steps) & 0xFFFFFFFF
    rollout_shared.launches += 1
    rollout_shared.bf16_launches += a.bf16
    return out


rollout_shared.launches = 0
rollout_shared.bf16_launches = 0    # the bfloat16 instantiation's share
