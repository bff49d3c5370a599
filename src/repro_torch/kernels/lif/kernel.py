"""Forward Engine kernel: wrapper of ``csrc/lif_forward.cu`` and its plain
version.

`lif_forward` runs one layer's psum-stationary product, LIF neuron and trace
update without plasticity.  A CPU tensor takes the plain version
(`lif_forward_plain`, any float dtype); a CUDA tensor launches the kernel
(every operand float32, or every one bfloat16) on the plan of
`lif_forward_launch` and counts it in ``lif_forward.launches``, a bfloat16
launch also in ``lif_forward.bf16_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lif import ref as _ref
from repro_torch.kernels.plasticity.kernel import (
    DEFAULT_SMEM_LIMIT, STEP_BYTES, STEP_CHUNK, STEP_ROUTES, STEP_THREADS,
    FParams, _al, _aligned, expect, f_params, float_dtype, on_card,
    shared_step_plan, smem_limit, stream_of)

lif_forward_plain = _ref.lif_forward

_P = ctypes.c_void_p
LIF_KINDS = {"float32": 0, "bfloat16": 1}     # lif_forward_occupancy's kind
# multiply-adds of a pass a thread, about (slab weights x batch rows of the
# pass): with no update to share the threads, fewer warps fold faster where
# a pass is small (the readout at B = 1)
LIF_MACS = 16


class _LifArgs(ctypes.Structure):
    """``LifArgs`` of csrc/lif_forward.cu."""
    _fields_ = [(name, _P) for name in (
        "x", "w", "v", "trace", "spikes", "v_out", "trace_out")] + [
        (name, ctypes.c_int) for name in ("batch", "k", "m")] + [
        ("f", FParams)] + [
        (name, ctypes.c_int) for name in (
            "cols", "split", "rows", "threads", "vec", "chunk_rows",
            "stage_x", "w_route", "w_width", "smem")]


def lif_forward_plan(b: int, k: int, m: int, dtype: str, *, sms: int,
                     smem: int = DEFAULT_SMEM_LIMIT,
                     occupancy: int | None = None) -> dict:
    """The LIF forward kernel's launch (``csrc/lif_forward.cu``) for B rows
    of a (K, M) layer in ``dtype`` ("float32", "bfloat16") on a card of
    ``sms`` SMs whose CTAs may use ``smem`` bytes of shared memory.

    The grid is the frozen shared step's, whose Forward Engine the kernel
    runs (`shared_step_plan` at ``plastic=False``, for the at most
    `STEP_CHUNK` batch rows a pass takes): ``vec`` (weights of a 16-byte
    piece, or 1), ``cols`` (the column tile), ``split`` and ``rows`` (the
    fan-in cut across a cluster), ``ctas``, ``chunk_rows`` and ``w`` (the
    copy route of w and its piece bytes).  Then its own ``threads``, a
    power of two, about `LIF_MACS` multiply-adds of a pass each, within
    `STEP_THREADS`; and its own shared memory: ``role_smem`` the w slab,
    the partial psums of one pass, the warps' partials, the mbarrier and,
    where they fit, the input events of a CTA's rows (``stage_x``);
    ``smem`` the total with 128 bytes to align the base — the layout
    csrc/lif_forward.cu checks.  With ``occupancy`` (CTAs an SM holds):
    ``ctas_per_sm``.

    Raises ValueError for another dtype, an empty operand, and where a
    share's w slab does not fit even at the largest cluster — the kernel
    does not fall back."""
    if dtype not in LIF_KINDS:
        raise ValueError(f"LIF forward kernel: no kernel for {dtype}")
    if min(b, k, m) < 1:
        raise ValueError(f"LIF forward kernel: an empty operand (B = {b}, "
                         f"K = {k}, M = {m})")
    pass_rows = min(b, STEP_CHUNK)
    step = shared_step_plan(pass_rows, k, m, False, dtype, sms=sms,
                            smem=smem)
    e = STEP_BYTES[dtype][0]
    c = step["cols"]
    pitch = m if step["w"][0] == "bulk" else c
    threads = STEP_THREADS[0]
    while threads < step["rows"] * c * pass_rows // LIF_MACS \
            and threads < STEP_THREADS[1]:
        threads *= 2

    def layout(threads: int) -> dict:
        return dict(w=_al(step["chunks"] * step["chunk_rows"] * pitch * e,
                          128),
                    ps=_al(pass_rows * c * 4),
                    red=_al(threads // 32 * STEP_CHUNK * c * 4), barrier=16)
    # the frozen step's count fitted: the same slab, fewer rows of partials
    # and at most its warps fit too
    while sum(layout(threads).values()) + 128 > smem \
            and threads > step["threads"]:
        threads //= 2
    roles = layout(threads)
    used = sum(roles.values()) + 128
    xs = _al(b * step["rows"] * e)
    stage_x = used + xs <= smem
    roles["staged_x"] = xs if stage_x else 0
    plan = {key: step[key] for key in (
        "vec", "cols", "tiles", "split", "rows", "ctas", "chunk_rows",
        "chunks", "w")}
    plan.update(threads=threads, stage_x=stage_x, role_smem=roles,
                smem=used + roles["staged_x"])
    if occupancy is not None:
        plan["ctas_per_sm"] = occupancy
    return plan


def _fill(a: _LifArgs, plan: dict) -> None:
    """The plan's fields of a `_LifArgs`."""
    for field in ("cols", "split", "rows", "threads", "vec", "chunk_rows",
                  "smem"):
        setattr(a, field, plan[field])
    a.stage_x = int(plan["stage_x"])
    a.w_route, a.w_width = STEP_ROUTES[plan["w"][0]], plan["w"][1]


_entries: dict = {}         # C entry name -> ctypes function, typed once


def _entry(name: str):
    fn = _entries.get(name)
    if fn is None:
        fn = getattr(_build.library("lif_forward.cu"), name)
        fn.argtypes = [ctypes.POINTER(_LifArgs)] + (
            [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 2
            if name == "lif_forward_occupancy" else [_P])
        fn.restype = ctypes.c_int
        _entries[name] = fn
    return fn


_plans: dict = {}           # plan key -> lif_forward_plan with occupancy


def lif_forward_launch(device, b: int, k: int, m: int, dtype: str) -> dict:
    """`lif_forward_plan` on ``device``, asked of the card once per plan
    key: the instantiation may use the card's shared memory,
    ``ctas_per_sm`` is what the occupancy query gives and, for a cluster,
    ``clusters`` the clusters the card holds at once.  Raises where a CTA
    or a cluster does not fit."""
    key = (b, k, m, dtype, torch.device(device))
    plan = _plans.get(key)
    if plan is None:
        kw = dict(sms=torch.cuda.get_device_properties(
            device).multi_processor_count, smem=smem_limit(device))
        plan = lif_forward_plan(b, k, m, dtype, **kw)
        a = _LifArgs(batch=b, k=k, m=m)
        _fill(a, plan)
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
        with torch.cuda.device(device):
            _build.check(_entry("lif_forward_occupancy")(
                ctypes.byref(a), LIF_KINDS[dtype], ctypes.byref(blocks),
                ctypes.byref(clusters)), "lif_forward_occupancy")
        if blocks.value < 1 or (plan["split"] > 1 and clusters.value < 1):
            raise ValueError(
                f"LIF forward kernel: a CTA of {plan['threads']} threads and "
                f"{plan['smem']} bytes (cluster of {plan['split']}) does not "
                f"fit the card")
        plan = _plans[key] = lif_forward_plan(b, k, m, dtype,
                                              occupancy=blocks.value, **kw)
        plan["clusters"] = clusters.value
    return plan


def _launch(x, w, v, trace, f: FParams):
    """Check operands, allocate outputs, launch one kernel on the plan of
    `lif_forward_launch` (none for an empty batch or layer): the call runs
    no device op beside the outputs' allocation and the kernel."""
    b, k = x.shape
    m = w.shape[1]
    dev = x.device
    dt = float_dtype("LIF forward kernel", (("x", x), ("w", w), ("v", v),
                                            ("trace", trace)))
    x = expect("x", x, (b, k), dt, dev)
    w = _aligned(expect("w", w, (k, m), dt, dev))
    v = expect("v", v, (b, m), dt, dev)
    trace = expect("trace", trace, (b, m), dt, dev)
    spikes = torch.empty((b, m), dtype=dt, device=dev)
    v_out, tr_out = torch.empty_like(v), torch.empty_like(trace)
    if b == 0 or m == 0:
        return spikes, v_out, tr_out
    bf16 = dt == torch.bfloat16
    plan = lif_forward_launch(dev, b, k, m,
                              "bfloat16" if bf16 else "float32")
    args = _LifArgs(x.data_ptr(), w.data_ptr(), v.data_ptr(),
                    trace.data_ptr(), spikes.data_ptr(), v_out.data_ptr(),
                    tr_out.data_ptr(), b, k, m, f)
    _fill(args, plan)
    entry = "lif_forward_bf16" if bf16 else "lif_forward_f32"
    _build.check(_entry(entry)(ctypes.byref(args), stream_of(x)), entry)
    lif_forward.launches += 1
    lif_forward.bf16_launches += int(bf16)
    return spikes, v_out, tr_out


def lif_forward(x, w, v, trace, *, tau_m: float = 2.0, v_th: float = 1.0,
                v_reset: float = 0.0, trace_decay: float = 0.8):
    """x (B,K), w (K,M), v (B,M), trace (B,M) ->
    (spikes (B,M), v_out (B,M), trace_new (B,M))."""
    if not on_card(x):
        return lif_forward_plain(x, w, v, trace, tau_m=tau_m, v_th=v_th,
                                 v_reset=v_reset, trace_decay=trace_decay)
    return _launch(x, w, v, trace,
                   f_params(tau_m, v_th, v_reset, trace_decay))


lif_forward.launches = 0
lif_forward.bf16_launches = 0       # the bfloat16 instantiation's share
