"""Dual-engine steps: wrappers of the CUDA kernels and their plain versions.

One call = one SNN timestep of one synaptic layer — the Forward Engine
(psum, neuron, trace) and the Plasticity Engine (four-term dw, weights
rewritten) fused in one launch.

  * `fleet_step`    — B request streams, each with its own weights
                      ``(B, N, M)`` under one shared rule theta; float32
                      or bfloat16; kernel ``csrc/fleet_step.cu``
                      ``fleet_step_f32`` / ``fleet_step_bf16``.
  * `fleet_step_q`  — the same on the fixed-point datapath (int8 weights,
                      int32 membranes and traces); ``fleet_step_q``.
  * `shared_step`   — B activation rows sharing ONE weight matrix
                      ``(N, M)``, batch-averaged dw; float32 or bfloat16;
                      kernel ``csrc/shared_step.cu`` ``shared_step_f32`` /
                      ``shared_step_bf16``.
  * `shared_step_q` — its fixed-point twin; ``shared_step_q``.

The fixed-point kernels are bit for bit equal to their plain versions.
A float call takes every state operand in one dtype, float32 or bfloat16,
and the rule in that dtype or float32; a bfloat16 call computes in float32
and rounds each output once (the Pallas bodies' generic dtype).

``telemetry=True`` on the fleet steps launches the kernels' telemetry
variant, which writes the raw (B, 3) float32 per-slot row of
`ref._fleet_telemetry_raw` itself; it is appended to the four outputs.

The fleet kernels run a persistent grid of per-stream warp groups whose
launch `fleet_step_plan` sizes (`fleet_step_launch` on the card); the
shared-step kernels a grid of column tiles whose fan-in a thread block
cluster may share, as `shared_step_plan` decides (`shared_step_launch`).

The backend follows the tensors: a CPU tensor takes the plain version
(``ref.dual_engine_fleet_step[_q]``), a CUDA tensor launches the kernel, and
anything else raises.  Each wrapper counts its kernel launches in
``<wrapper>.launches``, the fleet steps those of their telemetry variant
also in ``<wrapper>.telemetry_launches``, and the float wrappers their
bfloat16 launches also in ``<wrapper>.bf16_launches``.
"""
from __future__ import annotations

import ctypes
import math

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
FLOAT_DTYPES = (torch.float32, torch.bfloat16)    # the float kernels' types
DEFAULT_SMEM_LIMIT = 232448       # H100: 227 KB of dynamic shared memory
MAX_THREADS = 1024                # csrc/fleet.cuh kMaxThreads
BARRIER_GROUPS = 15               # named barriers 1..15: groups of > 1 warp
BARRIER_BYTES = 16                # two mbarriers (csrc/fleet.cuh kBarBytes)
# Synapses a thread of a stream's tile, which set a stream's warps: 16 in
# float, 32 in fixed point (its stochastic round makes the step bound by
# arithmetic, so it takes the most streams an SM holds, one warp each)
STEP_SYNAPSES_PER_THREAD = 16
STEP_SYNAPSES_PER_THREAD_Q = 32
STEP_DOUBLE_TILE = 8              # streams a double-buffered CTA, at most
STEP_THETA_SHARE = 4              # a resident rule: <= 1/4 of shared memory

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
        "scale", "seed", "events", "v_out", "trace_post_out", "w_out",
        "tel")] + [
        (name, ctypes.c_int) for name in (
            "batch", "n", "m", "plastic", "spiking")] + [
        ("w_clip", ctypes.c_float), ("f", FParams), ("q", QParams),
        ("telemetry", ctypes.c_int), ("sat_q", ctypes.c_int),
        ("sat_f", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "theta_bf16", "scale_stride", "seed_stride")] + [
        ("scale_val", ctypes.c_float)] + [
        (name, ctypes.c_int) for name in (
            "seed_val", "warps", "tile", "ctas", "theta_in_smem",
            "double_buffer", "smem")]


class _SharedStepArgs(ctypes.Structure):
    """``SharedStepArgs`` of csrc/shared_step.cu."""
    _fields_ = [(name, _P) for name in (
        "x", "w", "theta", "v", "trace_pre", "trace_post", "teach", "scale",
        "seed", "events", "v_out", "trace_post_out", "w_out")] + [
        (name, ctypes.c_int) for name in (
            "batch", "n", "m", "plastic", "spiking")] + [
        ("w_clip", ctypes.c_float), ("f", FParams), ("q", QParams),
        ("theta_bf16", ctypes.c_int), ("scale_val", ctypes.c_float),
        ("seed_val", ctypes.c_int)] + [
        (name, ctypes.c_int) for name in (
            "cols", "split", "rows", "threads", "vec", "chunk_rows",
            "stages", "stage_x", "w_route", "w_width", "th_route",
            "th_width", "smem")]


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


def float_dtype(what: str, operands, thetas=()) -> torch.dtype:
    """The element type of one float kernel call: float32 or bfloat16, the
    same for every ``(name, tensor)`` operand; each rule (None skipped) in
    that type or float32.  Raises on any other dtype and on a mix."""
    name0, t0 = operands[0]
    dt = t0.dtype
    if dt not in FLOAT_DTYPES:
        raise ValueError(f"{what}: the float kernels take float32 or "
                         f"bfloat16; got {name0} {dt}")
    for name, t in operands:
        if t.dtype != dt:
            raise ValueError(f"{what}: every operand in one dtype; got "
                             f"{name} {t.dtype} beside {name0} {dt}")
    for th in thetas:
        if th is not None and th.dtype not in (dt, torch.float32):
            raise ValueError(f"{what}: theta must be {dt} or float32; got "
                             f"{th.dtype}")
    return dt


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
    """The (B,) slot mask as bytes the kernels read (nonzero = active): a
    contiguous bool or uint8 mask on ``device`` as it is, anything else
    converted."""
    if active is None:
        return None
    if tuple(active.shape) != (b,):
        raise ValueError(f"active slot mask must have shape ({b},); got "
                         f"{tuple(active.shape)}")
    if active.device == device and active.is_contiguous() \
            and active.dtype in (torch.bool, torch.uint8):
        return active
    return (active.to(device) != 0).to(torch.uint8).contiguous()


def stream_scalar(val, b: int, dtype, device):
    """A fleet kernel's per-stream scalar (scale or seed) as ``(tensor,
    stride, value)``: a (B,) tensor read at stride 1, a 0-d tensor on
    ``device`` read at stride 0, or a number (a missing seed is 0; a 0-d
    tensor elsewhere, its value) passed by value with no tensor."""
    if val is None:
        return None, 0, 0
    if torch.is_tensor(val) and val.ndim:
        return expect("per-stream operand", val.to(device=device, dtype=dtype),
                      (b,), dtype, device), 1, 0
    if torch.is_tensor(val) and val.device == device:
        return val.to(dtype), 0, 0
    # the value the plain version holds: torch.as_tensor(val, dtype), which
    # raises on a seed outside int32
    return None, 0, torch.as_tensor(val, dtype=dtype).item()


def smem_limit(device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin",
                       DEFAULT_SMEM_LIMIT))


def _al(x: int, a: int = 16) -> int:
    return (x + a - 1) // a * a


def fleet_step_plan(b: int, n: int, m: int, plastic: bool, *, sms: int,
                    limit: int = DEFAULT_SMEM_LIMIT, w_bytes: int = 4,
                    s_bytes: int = 4, theta_bytes: int = 4,
                    occupancy: int | None = None) -> dict:
    """The fleet-step kernels' launch (``csrc/fleet_step.cu``) for B streams
    of an (N, M) layer on a card of ``sms`` SMs.

    * ``warps``: a stream's group, the power of two (at most 32) that gives
      each thread about `STEP_SYNAPSES_PER_THREAD` synapses
      (`STEP_SYNAPSES_PER_THREAD_Q` in fixed point, ``w_bytes`` 1).
    * ``theta``: "smem" (loaded once per CTA) where the plastic rule takes
      at most 1 / `STEP_THETA_SHARE` of ``limit``, else "l2".
    * ``buffers`` and ``tile`` (groups a CTA): "single" with the streams an
      SM takes in one wave, ceil(B / sms), where that many single-buffered
      groups fit; else "double" (the next stream fetched while one
      computes) with as many groups as fit, at most `STEP_DOUBLE_TILE`
      (two such CTAs an SM overlap loads and stores best); else "single"
      with as many as fit.  At most 1024 threads, and 15 groups of more
      than one warp.  Where the resident rule leaves no room for one group
      it goes through L2; where nothing fits this raises ValueError — the
      kernel does not fall back.
    * ``role_smem``: bytes of the rule, a stream buffer (weights, input,
      pre traces, membranes and post traces in their device types), the new
      post traces, the warps' telemetry partials and the buffers'
      mbarriers; ``slot`` a group's; ``smem`` the CTA's total with the
      rule's mbarrier — the layout csrc/fleet_step.cu checks.
    * With ``occupancy`` (CTAs an SM holds): ``ctas_per_sm`` and ``ctas``,
      the persistent grid, sms * occupancy CTAs or fewer where the tiles
      run out.

    ``w_bytes``/``s_bytes``: a weight and a state element in device memory
    (1/4 int8, 2/2 bfloat16, 4/4 float32); ``theta_bytes`` a coefficient.
    """
    nm = n * m
    want = -(-nm // (32 * (STEP_SYNAPSES_PER_THREAD_Q if w_bytes == 1
                           else STEP_SYNAPSES_PER_THREAD)))
    warps = 1
    while warps < want and warps < 32:
        warps *= 2
    cap = MAX_THREADS // (32 * warps)
    if warps > 1:
        cap = min(cap, BARRIER_GROUPS)
    buf = _al(nm * w_bytes) + 2 * _al(n * s_bytes) + 2 * _al(m * s_bytes)
    post, red = _al(m * 4), _al(warps * 3 * 4)
    rule = 4 * nm * theta_bytes
    need = max(1, -(-b // sms))
    routes = ("smem", "l2") if plastic and rule * STEP_THETA_SHARE <= limit \
        else ("l2",)
    for theta in routes:
        th = _al(rule) if theta == "smem" else 0
        room = limit - BARRIER_BYTES - th
        slot = {k: k * buf + post + red + BARRIER_BYTES for k in (1, 2)}
        fits = {k: min(cap, room // slot[k]) for k in (1, 2)}
        if fits[1] >= need:
            buffers, tile = "single", need
        elif fits[2] >= 1:
            buffers, tile = "double", min(fits[2], STEP_DOUBLE_TILE)
        elif fits[1] >= 1:
            buffers, tile = "single", fits[1]
        else:
            continue
        break
    else:
        raise ValueError(
            f"fleet step: one stream of an ({n}, {m}) layer needs "
            f"{BARRIER_BYTES + slot[1]} bytes of shared memory with the rule "
            f"read through L2; a CTA may use {limit}")
    k = 1 if buffers == "single" else 2
    plan = dict(warps=warps, tile=tile, threads=32 * warps * tile,
                buffers=buffers, theta=theta,
                role_smem=dict(theta=th, buffer=buf, post=post,
                               telemetry=red, barriers=BARRIER_BYTES,
                               slot=slot[k]),
                smem=BARRIER_BYTES + th + tile * slot[k])
    if occupancy is not None:
        plan.update(ctas_per_sm=occupancy,
                    ctas=min(sms * occupancy, -(-b // tile)))
    return plan


_step_plans: dict = {}          # plan key -> fleet_step_plan with its grid
_KINDS = {"float32": 0, "bfloat16": 1, "int8": 2}   # fleet_step_occupancy


def _fill_plan(a, plan: dict) -> None:
    """The plan's fields of a `_FleetStepArgs`."""
    a.warps, a.tile, a.ctas = plan["warps"], plan["tile"], \
        plan.get("ctas", 1)
    a.theta_in_smem = int(plan["theta"] == "smem")
    a.double_buffer = int(plan["buffers"] == "double")
    a.smem = plan["smem"]


def fleet_step_launch(device, b: int, n: int, m: int, plastic: bool, *,
                      kind: str, telemetry: bool = False,
                      theta_bf16: bool = False) -> dict:
    """`fleet_step_plan` on ``device`` with its persistent grid: the SM
    count and the CTAs one SM holds of the instantiation ``kind``
    ("float32", "bfloat16", "int8") and the flags select, asked of the card
    once per plan key.  Raises where a CTA does not fit an SM."""
    key = (b, n, m, bool(plastic), kind, bool(telemetry), bool(theta_bf16),
           torch.device(device))
    plan = _step_plans.get(key)
    if plan is None:
        eb = 2 if kind == "bfloat16" else 4
        kw = dict(limit=smem_limit(device),
                  w_bytes=1 if kind == "int8" else eb,
                  s_bytes=4 if kind == "int8" else eb,
                  theta_bytes=2 if theta_bf16 else 4,
                  sms=torch.cuda.get_device_properties(
                      device).multi_processor_count)
        plan = fleet_step_plan(b, n, m, plastic, **kw)
        a = _FleetStepArgs(n=n, m=m, plastic=int(plastic),
                           telemetry=int(telemetry),
                           theta_bf16=int(theta_bf16))
        _fill_plan(a, plan)
        blocks = ctypes.c_int(0)
        fn = _build.library("fleet_step.cu").fleet_step_occupancy
        fn.argtypes = [ctypes.POINTER(_FleetStepArgs), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            _build.check(fn(ctypes.byref(a), _KINDS[kind],
                            ctypes.byref(blocks)), "fleet_step_occupancy")
        if blocks.value < 1:
            raise ValueError(
                f"fleet step: a CTA of {plan['threads']} threads and "
                f"{plan['smem']} bytes does not fit an SM")
        plan = _step_plans[key] = fleet_step_plan(
            b, n, m, plastic, occupancy=blocks.value, **kw)
    return plan


# The shared-step kernels' launch (csrc/shared_step.cu, kernel.py
# shared_step_plan).
STEP_PIECE = 16             # bytes of w a thread's piece: 4, 8 or 16 weights
STEP_MAX_PIECES = 8         # pieces of a column tile's row, at most
STEP_MAX_CLUSTER = 8        # CTAs sharing a fan-in (a portable cluster)
STEP_ROW_ALIGN = 8          # a CTA's rows: a multiple of 8 (16 for bulk)
STEP_CHUNK_ROWS = 128       # rows of a TMA box and of a rule chunk, about
STEP_SYNAPSES = 4           # synapses of a thread, about: sets the threads
STEP_THREADS = (128, 512)   # threads of a CTA, at least and at most
STEP_RING = 2               # rule chunks a ring holds, at least
STEP_CHUNK = 8              # batch rows of one psum pass (kChunk)
# csrc/slab.cuh Route of each copy route the shared step takes
STEP_ROUTES = {"tma": 0, "cp.async": 1, "l2": 3, "none": 4, "bulk": 5}
STEP_BYTES = {"float32": (4, 4), "bfloat16": (2, 2), "int8": (1, 4)}


def step_route(n: int, m: int, c: int, e: int, tiles: int) -> tuple:
    """``(route, piece bytes)`` of a CTA's block of a row-major ``(n, m)``
    plane of ``e``-byte elements in tiles of ``c`` columns: TMA where the
    rows are in 16-byte pieces; one bulk copy where a tile is the whole row
    and the plane is in 16-byte pieces; cp.async of the widest piece (16, 8
    or 4 bytes) that divides a row; else "l2" (not staged by a copy
    engine)."""
    if m * e % 16 == 0 and c * e % 16 == 0:
        return "tma", 16
    if tiles == 1 and n * m * e % 16 == 0:
        return "bulk", 16
    for width in (16, 8, 4):
        if m * e % width == 0:
            return "cp.async", width
    return "l2", 0


def shared_step_plan(b: int, n: int, m: int, plastic: bool, dtype: str, *,
                     sms: int, smem: int = DEFAULT_SMEM_LIMIT,
                     theta_bf16: bool = False,
                     occupancy: int | None = None) -> dict:
    """The shared-step kernels' launch (``csrc/shared_step.cu``) for B rows
    of an (N, M) layer in ``dtype`` ("float32", "bfloat16", "int8"; the rule
    bfloat16 with ``theta_bf16``) on a card of ``sms`` SMs whose CTAs may
    use ``smem`` bytes of shared memory.

    * ``vec``: weights of a thread's piece, 16 bytes of w (4, 8 or 16), or 1
      where M's rows are not in 16-byte pieces.
    * ``cols``: columns of a tile, the fewest 16-byte pieces (at most
      `STEP_MAX_PIECES`, and 32 pieces) that leave at most ``sms`` tiles;
      where rows are not in 16-byte pieces but each plane is, one tile of
      the whole row (its blocks contiguous: one bulk copy each).
    * ``split``: the tile's fan-in cut into ``split`` shares of ``rows``
      rows (a multiple of 8, of 16 for a bulk copy) across a cluster, as
      many as the SMs the tiles leave, at most `STEP_MAX_CLUSTER`; more
      where a share's slab does not fit.  ``ctas`` = tiles x split.
    * ``w``, ``theta``: each plane's copy route (`step_route`); ``rule``
      "resident" (every chunk of the rule slab held), "ring" (``stages``
      chunks at a time) where it does not fit, "l2" (read in the update)
      where no ring fits or no copy engine takes the rows, "none" for a
      frozen layer.  ``chunk_rows``: rows of a TMA box and of a rule chunk,
      about `STEP_CHUNK_ROWS`, their bytes a multiple of 128 (16 rows for
      a bulk copy).
    * ``stage_x``: the input events and pre traces of a CTA's rows staged
      in shared memory, where they fit beside the rest.
    * ``threads``: a power of two, about `STEP_SYNAPSES` synapses each,
      within `STEP_THREADS`.
    * ``role_smem``: bytes of the w slab, the rule's stages, the staged
      rows, the partial psums, the post traces and their means, the warps'
      partials and the mbarriers; ``smem`` the total with 128 bytes to
      align the base — the layout csrc/shared_step.cu checks.
    * With ``occupancy`` (CTAs an SM holds): ``ctas_per_sm``.

    Raises ValueError where a share's w slab does not fit even at the
    largest cluster — the kernel does not fall back."""
    if dtype not in STEP_BYTES or (theta_bf16 and dtype != "bfloat16"):
        raise ValueError(f"shared step: no kernel for {dtype} with a "
                         f"{'bfloat16' if theta_bf16 else 'float32'} rule")
    we, sb = STEP_BYTES[dtype]
    tb = 2 if theta_bf16 else 4
    piece = STEP_PIECE // we
    vec = piece if m * we % 16 == 0 else 1

    def share(c: int, want: int) -> tuple:
        """(rows of a share, shares) of the fan-in cut for ``want``."""
        align = 16 if "bulk" in (step_route(n, m, c, we, -(-m // c))[0],
                                 step_route(n, m, c, tb, -(-m // c))[0]) \
            else STEP_ROW_ALIGN
        rows = _al(-(-n // want), align)
        return rows, -(-n // rows)

    c = piece
    while -(-m // c) > sms and c < min(STEP_MAX_PIECES * piece, 32 * vec):
        c *= 2
    # rows not in 16-byte pieces of a plane that is: one tile of the whole
    # row, each plane's block one bulk copy (not cp.async pieces)
    whole = piece
    while whole < m:
        whole *= 2
    if -(-m // c) > 1 and whole // vec <= 32 and all(
            step_route(n, m, whole, e, 1)[0] == "bulk"
            for e in ((we, tb) if plastic else (we,))):
        c = whole
    most = min(STEP_MAX_CLUSTER, max(1, -(-n // STEP_ROW_ALIGN)))
    tiles = -(-m // c)
    w_plane = step_route(n, m, c, we, tiles)
    th_plane = step_route(n, m, c, tb, tiles) if plastic else ("none", 0)
    pw = m if w_plane[0] == "bulk" else c
    pt = m if th_plane[0] == "bulk" else c
    step = 1
    for plane, pitch, e in ((w_plane, pw, we), (th_plane, pt, tb)):
        if plane[0] == "tma":
            step = max(step, 128 // math.gcd(128, pitch * e))
        elif plane[0] == "bulk":
            step = max(step, 16)
    staged = th_plane[0] in ("tma", "bulk", "cp.async")
    bars = lambda st: _al((1 + st) * 8)
    for want in range(min(most, max(1, sms // -(-m // c))), most + 1):
        rows, split = share(c, want)
        threads = STEP_THREADS[0]
        while threads < rows * c // STEP_SYNAPSES \
                and threads < STEP_THREADS[1]:
            threads *= 2
        r = _al(-(-rows // -(-rows // STEP_CHUNK_ROWS)), step)
        chunks = -(-rows // r)
        roles = dict(w=_al(chunks * r * pw * we, 128), ps=_al(b * c * 4),
                     tp=_al(b * c * 4), post=_al(c * 4),
                     red=_al(threads // 32 * STEP_CHUNK * c * 4))
        base = sum(roles.values()) + 128
        stage = _al(4 * r * pt * tb, 128)
        rule = "none" if not plastic else "l2"
        stages = 0
        if staged:       # every chunk held, else the largest ring
            for st in [chunks] + list(range(chunks - 1, STEP_RING - 1, -1)):
                if base + st * stage + bars(st) <= smem:
                    rule = "resident" if st == chunks else "ring"
                    stages = st
                    break
        used = base + stages * stage + bars(stages)
        if used <= smem:
            break
    else:
        raise ValueError(
            f"shared step: a CTA's share of an ({n}, {m}) layer at B = {b} "
            f"({rows} rows x {c} columns) needs {used} bytes of shared "
            f"memory; a CTA may use {smem}")
    if rule == "l2":
        th_plane = ("l2", 0)
    xs = 2 * _al(b * rows * sb)
    stage_x = used + xs <= smem
    roles.update(theta=stages * stage if stages else 0,
                 staged_rows=xs if stage_x else 0, barriers=bars(stages))
    plan = dict(vec=vec, cols=c, tiles=tiles, split=split, rows=rows,
                ctas=tiles * split, threads=threads, chunk_rows=r,
                chunks=chunks, stages=stages, rule=rule, stage_x=stage_x,
                w=w_plane, theta=th_plane, role_smem=roles,
                smem=used + (xs if stage_x else 0))
    if occupancy is not None:
        plan["ctas_per_sm"] = occupancy
    return plan


_shared_plans: dict = {}        # plan key -> shared_step_plan with occupancy


def _fill_shared(a, plan: dict) -> None:
    """The plan's fields of a `_SharedStepArgs`."""
    for field in ("cols", "split", "rows", "threads", "vec", "chunk_rows",
                  "stages", "smem"):
        setattr(a, field, plan[field])
    a.stage_x = int(plan["stage_x"])
    a.w_route, a.w_width = STEP_ROUTES[plan["w"][0]], plan["w"][1]
    a.th_route, a.th_width = STEP_ROUTES[plan["theta"][0]], plan["theta"][1]


def shared_step_launch(device, b: int, n: int, m: int, plastic: bool, *,
                       kind: str, theta_bf16: bool = False) -> dict:
    """`shared_step_plan` on ``device``, asked of the card once per plan key:
    the instantiation may use the card's shared memory, ``ctas_per_sm`` is
    what the occupancy query gives and, for a cluster, ``clusters`` the
    clusters the card holds at once.  Raises where a CTA or a cluster does
    not fit."""
    key = (b, n, m, bool(plastic), kind, bool(theta_bf16),
           torch.device(device))
    plan = _shared_plans.get(key)
    if plan is None:
        kw = dict(sms=torch.cuda.get_device_properties(
            device).multi_processor_count, smem=smem_limit(device),
                  theta_bf16=theta_bf16)
        plan = shared_step_plan(b, n, m, plastic, kind, **kw)
        a = _SharedStepArgs(batch=b, n=n, m=m, plastic=int(plastic),
                            theta_bf16=int(theta_bf16))
        _fill_shared(a, plan)
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
        fn = _build.library("shared_step.cu").shared_step_occupancy
        fn.argtypes = [ctypes.POINTER(_SharedStepArgs), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            _build.check(fn(ctypes.byref(a), _KINDS[kind],
                            ctypes.byref(blocks), ctypes.byref(clusters)),
                         "shared_step_occupancy")
        if blocks.value < 1 or (plan["split"] > 1 and clusters.value < 1):
            raise ValueError(
                f"shared step: a CTA of {plan['threads']} threads and "
                f"{plan['smem']} bytes (cluster of {plan['split']}) does not "
                f"fit the card")
        plan = _shared_plans[key] = shared_step_plan(
            b, n, m, plastic, kind, occupancy=blocks.value, **kw)
        plan["clusters"] = clusters.value
    return plan


def _launch(entry: str, x, w, theta, v, trace_pre, trace_post, *, state_dt,
            plastic, spiking, w_clip, teach, active, telemetry, v_th,
            scale=None, seed=None, f=None, q=None, qcfg=None):
    """Check operands, allocate outputs, launch one fleet-step kernel (the
    telemetry variant, which writes the raw (B, 3) row, with
    ``telemetry``).  A float kernel takes teach in float32 and the rule in
    float32 or bfloat16, and sums telemetry in float32."""
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
    wide = torch.int32 if qcfg is not None else torch.float32
    if plastic:     # float32, or bfloat16 beside bfloat16 state
        theta = expect("theta", theta, (4, n, m), torch.float32
                       if qcfg is not None else theta.dtype, dev)
    th_bf16 = plastic and theta.dtype == torch.bfloat16
    if plastic and theta.data_ptr() % 16:   # 16-byte loads of the rule
        theta = theta.clone()
    if teach is not None:
        teach = teach.to(device=dev, dtype=wide).expand(b, m).contiguous()
    active = active_mask(active, b, dev)
    sc, sc_stride, sc_val = stream_scalar(scale, b, torch.float32, dev)
    sd, sd_stride, sd_val = stream_scalar(seed, b, torch.int32, dev)
    events = torch.empty((b, m), dtype=state_dt, device=dev)
    v_out = torch.empty_like(v)
    tp_out = torch.empty_like(trace_post)
    w_out = torch.empty_like(w)
    tel = (torch.empty((b, 3), dtype=torch.float32, device=dev)
           if telemetry else None)
    kind = "int8" if qcfg is not None else (
        "bfloat16" if state_dt == torch.bfloat16 else "float32")
    plan = fleet_step_launch(dev, b, n, m, plastic, kind=kind,
                             telemetry=telemetry, theta_bf16=th_bf16)
    args = _FleetStepArgs(
        ptr(x), ptr(w), ptr(theta) if plastic else None, ptr(v),
        ptr(trace_pre), ptr(trace_post), ptr(teach), ptr(active), ptr(sc),
        ptr(sd), ptr(events), ptr(v_out), ptr(tp_out), ptr(w_out), ptr(tel),
        b, n, m, int(plastic), int(spiking), w_clip, f or FParams(),
        q or QParams(), int(telemetry),
        sat_threshold_q(v_th, qcfg) if qcfg is not None else 0,
        sat_threshold(v_th), int(th_bf16), sc_stride, sd_stride, sc_val,
        sd_val)
    _fill_plan(args, plan)
    fn = getattr(_build.library("fleet_step.cu"), entry)
    fn.argtypes, fn.restype = [ctypes.POINTER(_FleetStepArgs), _P], \
        ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(x)), entry)
    out = (events, v_out, tp_out, w_out)
    return out if tel is None else out + (tel,)


def fleet_step(x, w, theta, v, trace_pre, trace_post, *,
               tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
               trace_decay: float = 0.8, w_clip: float = 4.0,
               plastic: bool = True, spiking: bool = True, teach=None,
               active=None, telemetry: bool = False):
    """Float fleet step (float32 or bfloat16); shapes as
    `ref.dual_engine_fleet_step`.  Returns (events, v_out, trace_post_new,
    w_new), plus the raw (B, 3) float32 telemetry row with ``telemetry``."""
    if not on_card(x):
        return fleet_step_plain(
            x, w, theta, v, trace_pre, trace_post, tau_m=tau_m, v_th=v_th,
            v_reset=v_reset, trace_decay=trace_decay, w_clip=w_clip,
            plastic=plastic, spiking=spiking, teach=teach, active=active,
            telemetry=telemetry)
    dt = float_dtype("float fleet kernel", (
        ("x", x), ("w", w), ("v", v), ("trace_pre", trace_pre),
        ("trace_post", trace_post)), (theta,) if plastic else ())
    bf16 = dt == torch.bfloat16
    out = _launch("fleet_step_bf16" if bf16 else "fleet_step_f32", x, w,
                  theta, v, trace_pre, trace_post, state_dt=dt,
                  plastic=plastic, spiking=spiking, w_clip=w_clip,
                  teach=teach, active=active, telemetry=telemetry, v_th=v_th,
                  f=f_params(tau_m, v_th, v_reset, trace_decay))
    fleet_step.launches += 1
    fleet_step.telemetry_launches += int(telemetry)
    fleet_step.bf16_launches += int(bf16)
    return out


fleet_step.launches = 0
fleet_step.telemetry_launches = 0       # the telemetry variant's share
fleet_step.bf16_launches = 0            # the bfloat16 instantiation's share


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
    out = _launch("fleet_step_q", x, w, theta, v, trace_pre, trace_post,
                  state_dt=torch.int32, plastic=plastic, spiking=spiking,
                  w_clip=w_clip, teach=teach, active=active,
                  telemetry=telemetry, v_th=v_th, scale=scale, seed=seed,
                  q=q_params(qcfg, v_th, v_reset), qcfg=qcfg)
    fleet_step_q.launches += 1
    fleet_step_q.telemetry_launches += int(telemetry)
    return out


fleet_step_q.launches = 0
fleet_step_q.telemetry_launches = 0       # the telemetry variant's share


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` where it starts on 16 bytes (the copy engines' rule), else a
    copy that does."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def teach_operand(teach, b: int, m: int, dtype, device):
    """The (B, M) teaching current a shared-step kernel reads: a contiguous
    (B, M) tensor of ``dtype`` on ``device`` as it is, anything else
    (a (M,) current, another type) converted."""
    if teach is None or (teach.device == device and teach.dtype == dtype
                         and tuple(teach.shape) == (b, m)
                         and teach.is_contiguous()):
        return teach
    return teach.to(device=device, dtype=dtype).expand(b, m).contiguous()


def _launch_shared(entry: str, x, w, theta, v, trace_pre, trace_post, *,
                   state_dt, plastic, spiking, w_clip, teach, scale=None,
                   seed=None, f=None, q=None):
    """Check operands, allocate outputs, launch one shared-step kernel on
    the plan of `shared_step_launch`.  A contiguous teach of the kernel's
    type ((B, M) float32, int32 in fixed point) and a number or 0-d scale
    and seed on the card pass as they are: the call runs no device op
    beside the kernel."""
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
    w = _aligned(expect("w", w, (n, m), w.dtype, dev))
    v = expect("v", v, (b, m), state_dt, dev)
    trace_post = expect("trace_post", trace_post, (b, m), state_dt, dev)
    trace_pre = expect("trace_pre", trace_pre, (b, n), state_dt, dev)
    if plastic:     # float32, or bfloat16 beside bfloat16 state
        theta = _aligned(expect("theta", theta, (4, n, m), torch.float32
                                if q is not None else theta.dtype, dev))
    th_bf16 = plastic and theta.dtype == torch.bfloat16
    teach = teach_operand(teach, b, m, torch.int32 if q is not None
                          else torch.float32, dev)
    sc, _, sc_val = stream_scalar(scale, 1, torch.float32, dev)
    sd, _, sd_val = stream_scalar(seed, 1, torch.int32, dev)
    events = torch.empty((b, m), dtype=state_dt, device=dev)
    v_out = torch.empty_like(v)
    tp_out = torch.empty_like(trace_post)
    w_out = torch.empty_like(w)
    kind = "int8" if q is not None else (
        "bfloat16" if state_dt == torch.bfloat16 else "float32")
    plan = shared_step_launch(dev, b, n, m, plastic, kind=kind,
                              theta_bf16=th_bf16)
    args = _SharedStepArgs(
        ptr(x), ptr(w), ptr(theta) if plastic else None, ptr(v),
        ptr(trace_pre), ptr(trace_post), ptr(teach), ptr(sc), ptr(sd),
        ptr(events), ptr(v_out), ptr(tp_out), ptr(w_out), b, n, m,
        int(plastic), int(spiking), w_clip, f or FParams(), q or QParams(),
        int(th_bf16), sc_val, sd_val)
    _fill_shared(args, plan)
    fn = getattr(_build.library("shared_step.cu"), entry)
    fn.argtypes, fn.restype = [ctypes.POINTER(_SharedStepArgs), _P], \
        ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(x)), entry)
    return events, v_out, tp_out, w_out


def shared_step(x, w, theta, v, trace_pre, trace_post, *,
                tau_m: float = 2.0, v_th: float = 1.0, v_reset: float = 0.0,
                trace_decay: float = 0.8, w_clip: float = 4.0,
                plastic: bool = True, spiking: bool = True, teach=None):
    """Float shared-weight step (float32 or bfloat16); shapes as
    `ref.dual_engine_step` (the kernel takes batched (B, ·) state).
    Returns (events, v_out, trace_post_new, w_new)."""
    if not on_card(x):
        return shared_step_plain(
            x, w, theta, v, trace_pre, trace_post, tau_m=tau_m, v_th=v_th,
            v_reset=v_reset, trace_decay=trace_decay, w_clip=w_clip,
            plastic=plastic, spiking=spiking, teach=teach)
    dt = float_dtype("float shared-step kernel", (
        ("x", x), ("w", w), ("v", v), ("trace_pre", trace_pre),
        ("trace_post", trace_post)), (theta,) if plastic else ())
    bf16 = dt == torch.bfloat16
    out = _launch_shared("shared_step_bf16" if bf16 else "shared_step_f32",
                         x, w, theta, v, trace_pre, trace_post, state_dt=dt,
                         plastic=plastic, spiking=spiking, w_clip=w_clip,
                         teach=teach,
                         f=f_params(tau_m, v_th, v_reset, trace_decay))
    shared_step.launches += 1
    shared_step.bf16_launches += int(bf16)
    return out


shared_step.launches = 0
shared_step.bf16_launches = 0           # the bfloat16 instantiation's share


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
    out = _launch_shared(
        "shared_step_q", x, w, theta, v, trace_pre, trace_post,
        state_dt=torch.int32, plastic=plastic, spiking=spiking, w_clip=w_clip,
        teach=teach, scale=scale, seed=seed,
        q=q_params(qcfg, v_th, v_reset, batch=x.shape[0]))
    shared_step_q.launches += 1
    return out


shared_step_q.launches = 0
