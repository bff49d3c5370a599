"""The chunked SSD scan: wrapper of ``csrc/ssd.cu`` and its plain version.

`ssd_scan` takes x (B, L, H, P) and B, C (B, L, G, S) in float32 or
bfloat16 (one dtype), read in that layout through their strides (the last
dim must be contiguous), dt (B, L, H) and a (H,) in float32, and returns
y (B, L, H, P) in x's dtype and the final state (B, H, S, P) in float32,
from a zero state.  Head h reads B/C group ``h // (H / G)``: the groups are
never repeated to heads.  Any L: the kernel masks the ragged tail, the
plain version pads it with dt = 0 steps (exact no-ops), so the final state
does not depend on the padding.  A CPU tensor takes the plain version
(`ssd_scan_plain`, the chunked form at ``chunk``); a CUDA tensor launches
the kernel, which walks the sequence in 64-row chunks of its own
(``chunk`` does not reach it), and counts it in ``ssd_scan.launches``.
bfloat16 launches the Hopper kernel (TMA or cp.async ring, wgmma with
G, the state and w o x split into bf16 hi + lo); float32 the CUDA-core
kernel.

Gradients.  Where autograd will differentiate the outputs (grad mode on
and an input requiring grad), `ssd_scan` runs as a
`torch.autograd.Function` that keeps its inputs; its backward is
`ssd_scan_bwd`, which on a CPU tensor takes `ssd_scan_bwd_plain`
(`ref.ssd_scan_bwd_plain`, the gradient written out in the kernel's
order) and on a CUDA tensor launches ``csrc/ssd_bwd.cu`` and counts it in
``ssd_scan.bwd_launches``.  bfloat16 runs four Hopper kernels (`BWD_KERNELS`:
the carries with each chunk's contribution folded in, each (chunk, slab of
a group's heads)'s gradients with every product a wgmma and the float32
operands split hi + lo, d(lg) into ddt, the slabs summed), laid out by
`bwd_plan`; float32 the four CUDA-core kernels.  No atomics: a second
launch gives the same bits.  It recomputes the forward's chunk states
itself.  An unused final state's gradient counts as zero.
`ssd_scan_bwd_attrs` reads each compiled bf16 kernel's registers and local
(spill) bytes.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.plasticity.kernel import on_card, stream_of
from repro_torch.kernels.ssd import ref as _ref

MAX_HEAD_DIM = 64                 # P the kernel's tiles hold
MAX_STATE = 128                   # S the kernel's tiles hold (a multiple of 4)
CHUNK = 64                        # rows of one step of the kernel's walk
# one CTA's shared memory per dtype, recomputed by the C launcher (which
# refuses a disagreeing count).  float32: x (64 x 64), B and C (64 x 128
# each) and the state (128 x 64) as float32, and dt, the log-decay and the
# update weights (64 each), 115,456 bytes.  bfloat16: two ring stages of
# x, B and C as bf16 tiles of 64-element (128-byte) rows, the G tile's
# bf16 hi and lo and the y tile (64 x 64 each), per stage five floats a
# row (dt; lg and dt again, packed by row pairs; exp(lg); w), the stages'
# mbarriers and 1 KB to align the tiles to 1024 bytes, 110,096 bytes.
# Either lets two CTAs share an SM.
_TILE = 2 * CHUNK * 64            # one 64 x 64 bf16 tile
_STAGES = 2
SMEM_BYTES = {
    torch.float32: 4 * (CHUNK * MAX_HEAD_DIM + 2 * CHUNK * MAX_STATE
                        + MAX_STATE * MAX_HEAD_DIM + 3 * CHUNK),
    torch.bfloat16: (_STAGES * 5 * _TILE + 3 * _TILE + 4 * _STAGES * 5 * CHUNK
                     + 8 * _STAGES + 1024)}
ROUTES = ("tma", "cp.async")      # how the bf16 kernel loads x, B and C
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _SsdArgs(ctypes.Structure):
    """``SsdArgs`` of csrc/ssd.cu (strides in elements)."""
    _fields_ = [(name, _P) for name in ("x", "dt", "a", "b", "c", "y",
                                        "state")] + [
        (name, _L) for name in ("x_sb", "x_sl", "x_sh", "dt_sb", "dt_sl",
                                "dt_sh", "b_sb", "b_sl", "b_sg", "c_sb",
                                "c_sl", "c_sg")] + [
        (name, _I) for name in ("batch", "length", "heads", "groups",
                                "head_dim", "state_dim", "dtype", "route")]


class _SsdBwdArgs(ctypes.Structure):
    """``SsdBwdArgs`` of csrc/ssd_bwd.cu (strides in elements)."""
    _fields_ = [(name, _P) for name in (
        "x", "dt", "a", "b", "c", "dy", "dstate", "dx", "ddt", "da", "db",
        "dc", "states", "dstates", "decay", "dbp", "dcp", "dap", "rowp",
        "dotp")] + [
        (name, _L) for name in ("x_sb", "x_sl", "x_sh", "dt_sb", "dt_sl",
                                "dt_sh", "b_sb", "b_sl", "b_sg", "c_sb",
                                "c_sl", "c_sg", "dy_sb", "dy_sl",
                                "dy_sh")] + [
        (name, _I) for name in ("batch", "length", "heads", "groups",
                                "head_dim", "state_dim", "dtype", "slab",
                                "route")]


# the bf16 kernels of csrc/ssd_bwd.cu in the order ``ssd_scan_bwd_attrs``
# reports them (the float32 instantiations keep the CUDA-core kernels
# ssd_bwd_chunk_kernel, ssd_bwd_scan_kernel, ssd_bwd_kernel and
# ssd_bwd_reduce_kernel)
BWD_KERNELS = ("ssd_bwd_walk_kernel", "ssd_bwd_grad_kernel<S<=128>",
               "ssd_bwd_grad_kernel<S<=64>", "ssd_bwd_finish_kernel",
               "ssd_bwd_slab_kernel")
# shared bytes of the backward's kernels, recomputed by the C launcher
# (which refuses a disagreeing count).  bfloat16: the walk holds two stages
# of an operand tile and a 64-column piece of B or C (8 KB each) and dt,
# the emitted state's hi and lo tiles, the step's coefficients and decay,
# two mbarriers and 1 KB to align the tiles to 1024 bytes, 50,976 bytes;
# the gradient CTA (at S <= 64 and S <= 128: NS = 1 or 2 tiles of 64
# columns) B and C (NS tiles each), two stages of x, dy and the hi and lo
# tiles of S_in and dS_out (2 + 4 NS tiles), C B^T by thread (16 KB), dt
# per stage, each warpgroup's four row vectors, N's row sums by warp, the
# <S_in, dS_out> partials, warpgroup 0's dG' sum (its causal 8-column
# blocks, 10 KB), two mbarriers and the 1 KB slack, 145,952 and 227,872
# bytes (one CTA an SM).  float32: the CUDA-core chunk-gradient
# kernel's tiles, 135,488 and 201,536 bytes.
_WALK_SMEM = 2 * 2 * _TILE + 2 * _TILE + 4 * (2 * CHUNK + CHUNK) + 32 + 1024


def _grad_smem(ns):
    return (2 * ns * _TILE + 2 * (2 + 4 * ns) * _TILE + 4 * 32 * 128
            + 4 * (2 * CHUNK + 2 * 4 * CHUNK + 4 * CHUNK) + 16
            + 4 * 128 * 4 * 5 + 16 + 1024)


def _f32_grad_smem(njs):
    ld = CHUNK + 1
    return 4 * (4 * CHUNK * ld + 2 * CHUNK * (16 * njs + 1)
                + 2 * 16 * njs * ld + 9 * CHUNK + 16)


BWD_SMEM_BYTES = {
    torch.bfloat16: {"ssd_bwd_walk_kernel": _WALK_SMEM,
                     "ssd_bwd_grad_kernel<S<=64>": _grad_smem(1),
                     "ssd_bwd_grad_kernel<S<=128>": _grad_smem(2)},
    torch.float32: {"ssd_bwd_kernel<S<=64>": _f32_grad_smem(4),
                    "ssd_bwd_kernel<S<=128>": _f32_grad_smem(8)}}
H100_SMS = 132


def slab_width(batch: int, n_chunks: int, groups: int, per: int,
               sms: int = H100_SMS) -> int:
    """Heads of one group a gradient CTA takes: the width w in 1..per that
    minimises waves x (w + 1), where a wave is ``sms`` CTAs (one an SM) of
    the batch x n_chunks x groups x ceil(per / w) the launch holds and a
    CTA's own work (B and C, C B^T, dG' B and dG'^T C, its partials) counts
    as one more head; the widest at a tie.  csrc/ssd_bwd.cu slab_width is
    the same rule."""
    best, best_cost = 1, None
    for w in range(1, per + 1):
        ctas = batch * n_chunks * groups * -(-per // w)
        cost = -(-ctas // sms) * (w + 1)
        if best_cost is None or cost <= best_cost:
            best, best_cost = w, cost
    return best


def bwd_plan(batch: int, length: int, heads: int, groups: int,
             head_dim: int, state_dim: int, sms: int = H100_SMS) -> dict:
    """The bf16 backward's launch at a shape: ``heads_a_cta`` (the slab of
    a group's heads one gradient CTA sums), ``slabs`` a group,
    ``walk_split`` (64-column pieces of S a walk is cut into),
    ``walk_ctas`` (both directions), ``grad_ctas``, ``finish_warps`` and
    the two kernels' shared bytes.  Raises for a shape the kernels cannot
    take (head_dim over 64, a state over 128 or not a multiple of 4,
    groups that do not divide the heads)."""
    if not 1 <= head_dim <= MAX_HEAD_DIM or not 4 <= state_dim <= MAX_STATE \
            or state_dim % 4 or groups < 1 or heads % groups:
        raise ValueError(
            f"the bf16 SSD backward takes head_dim <= {MAX_HEAD_DIM}, a state "
            f"<= {MAX_STATE} that is a multiple of 4 and groups that divide "
            f"the heads; got P = {head_dim}, S = {state_dim}, H = {heads}, "
            f"G = {groups}")
    n = -(-length // CHUNK)
    per = heads // groups
    w = slab_width(batch, n, groups, per, sms)
    slabs = -(-per // w)
    ns = -(-state_dim // 64)
    grad = "ssd_bwd_grad_kernel<S<=64>" if ns == 1 \
        else "ssd_bwd_grad_kernel<S<=128>"
    smem = BWD_SMEM_BYTES[torch.bfloat16]
    return dict(heads_a_cta=w, slabs=slabs, walk_split=ns,
                walk_ctas=2 * batch * heads * ns,
                grad_ctas=batch * n * groups * slabs,
                finish_warps=batch * heads * n, grad_kernel=grad,
                grad_smem=smem[grad], walk_smem=smem["ssd_bwd_walk_kernel"])


ssd_scan_bwd_plain = _ref.ssd_scan_bwd_plain


def ssd_scan_plain(x, dt, a, bmat, c, *, chunk: int = 64):
    """The chunked form on any L: padded to a multiple of ``chunk`` with
    dt = 0 steps, y cut back to L."""
    length = x.shape[1]
    pad = (-length) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bmat = F.pad(bmat, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    y, state = _ref.ssd_chunked_ref(x, dt, a, bmat, c, chunk=chunk)
    return y[:, :length], state


def _check(x, dt, a, bmat, c):
    b, length, h, p = x.shape
    if bmat.ndim != 4 or bmat.shape[:2] != (b, length) \
            or c.shape != bmat.shape:
        raise ValueError(f"B and C must be (B, L, G, S) with B = {b}, "
                         f"L = {length}; got {tuple(bmat.shape)}, "
                         f"{tuple(c.shape)}")
    g, s = bmat.shape[2], bmat.shape[3]
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    if tuple(dt.shape) != (b, length, h) or tuple(a.shape) != (h,):
        raise ValueError(f"dt must be (B, L, H) = {(b, length, h)} and a "
                         f"(H,); got {tuple(dt.shape)}, {tuple(a.shape)}")
    if not 1 <= p <= MAX_HEAD_DIM or not 1 <= s <= MAX_STATE or s % 4:
        raise ValueError(f"the SSD kernel is built for head_dim <= "
                         f"{MAX_HEAD_DIM} and a state <= {MAX_STATE} that is "
                         f"a multiple of 4; got P = {p}, S = {s}")
    if x.dtype not in _DTYPE_CODE or bmat.dtype != x.dtype \
            or c.dtype != x.dtype:
        raise ValueError(f"the SSD kernel takes float32 or bfloat16 x, B, C "
                         f"of one dtype; got {x.dtype}, {bmat.dtype}, "
                         f"{c.dtype}")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise ValueError(f"dt and a must be float32; got {dt.dtype}, "
                         f"{a.dtype}")
    for name, t in (("dt", dt), ("a", a), ("B", bmat), ("C", c)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    for name, t in (("x", x), ("B", bmat), ("C", c)):
        if t.numel() and t.stride(-1) != 1:
            raise ValueError(f"{name}: the kernel reads the last dim "
                             f"contiguously; got strides {t.stride()}")


def copy_route(*tensors) -> str:
    """How the bf16 kernels load x, B and C (and the backward dy):
    ``"tma"`` when every one has a 16-byte aligned base and strides (but
    the last) that are nonzero whole 16-byte multiples, as a tensor map
    needs; else ``"cp.async"``."""
    def tma_readable(t):
        return t.data_ptr() % 16 == 0 and all(
            st > 0 and st * t.element_size() % 16 == 0
            for st in t.stride()[:-1])
    return ROUTES[0] if all(map(tma_readable, tensors)) else ROUTES[1]


def ssd_scan(x, dt, a, bmat, c, *, chunk: int = 64):
    """x (B,L,H,P), dt (B,L,H), a (H,), bmat/c (B,L,G,S) ->
    (y (B,L,H,P), state_final (B,H,S,P))."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, a, bmat, c)):
        return _Ssd.apply(x, dt, a, bmat, c, chunk)
    return _forward(x, dt, a, bmat, c, chunk)


def _forward(x, dt, a, bmat, c, chunk):
    """The plain version on a CPU tensor, else one launch of the kernel."""
    if not on_card(x):
        return ssd_scan_plain(x, dt, a, bmat, c, chunk=chunk)
    _check(x, dt, a, bmat, c)
    b, length, h, p = x.shape
    g, s = bmat.shape[2], bmat.shape[3]
    a = a.contiguous()
    y = torch.empty((b, length, h, p), dtype=x.dtype, device=x.device)
    state = torch.empty((b, h, s, p), dtype=torch.float32, device=x.device)
    if state.numel() == 0:
        return y, state
    args = _SsdArgs(x.data_ptr(), dt.data_ptr(), a.data_ptr(),
                    bmat.data_ptr(), c.data_ptr(), y.data_ptr(),
                    state.data_ptr(), *x.stride()[:3], *dt.stride(),
                    *bmat.stride()[:3], *c.stride()[:3],
                    b, length, h, g, p, s, _DTYPE_CODE[x.dtype],
                    ROUTES.index(copy_route(x, bmat, c)))
    fn = _build.library("ssd.cu").ssd_scan
    fn.argtypes = [ctypes.POINTER(_SsdArgs), ctypes.c_size_t, _P]
    fn.restype = ctypes.c_int
    _build.check(fn(ctypes.byref(args), SMEM_BYTES[x.dtype], stream_of(x)),
                 "ssd_scan")
    _counts.launches += 1
    return y, state


def ssd_scan_bwd(x, dt, a, bmat, c, dy, dstate=None, *, chunk: int = 64):
    """The gradient (dx, ddt, da, dB, dC) of `ssd_scan` at its inputs for
    the output gradient ``dy`` (B,L,H,P) in x's dtype and the final state's
    ``dstate`` (B,H,S,P) float32, or None for zero.  A CPU tensor takes
    `ssd_scan_bwd_plain` (its chunked form at ``chunk``); a CUDA tensor
    launches ``csrc/ssd_bwd.cu`` (its four kernels, one call, 64-row chunks
    of its own; bf16 as `bwd_plan` lays it out) and counts it in
    ``ssd_scan.bwd_launches``.  dx, dB, dC come back contiguous in x's
    dtype, ddt and da in float32."""
    if not on_card(x):
        return ssd_scan_bwd_plain(x, dt, a, bmat, c, dy, dstate, chunk=chunk)
    _check(x, dt, a, bmat, c)
    b, length, h, p = x.shape
    g, s = bmat.shape[2], bmat.shape[3]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy must be x's shape {tuple(x.shape)}, dtype and "
                         f"device; got {tuple(dy.shape)} {dy.dtype} on "
                         f"{dy.device}")
    if dy.numel() and dy.stride(-1) != 1:
        dy = dy.contiguous()
    if dstate is not None:
        if (tuple(dstate.shape) != (b, h, s, p)
                or dstate.dtype != torch.float32
                or dstate.device != x.device):
            raise ValueError(f"dstate must be float32 {(b, h, s, p)} on "
                             f"{x.device}; got {tuple(dstate.shape)} "
                             f"{dstate.dtype} on {dstate.device}")
        dstate = dstate.contiguous()
    a = a.contiguous()
    dev, f32 = x.device, torch.float32
    dx = torch.empty((b, length, h, p), dtype=x.dtype, device=dev)
    ddt = torch.empty((b, length, h), dtype=f32, device=dev)
    da = torch.zeros((h,), dtype=f32, device=dev)
    db = torch.empty((b, length, g, s), dtype=x.dtype, device=dev)
    dc = torch.empty((b, length, g, s), dtype=x.dtype, device=dev)
    if dx.numel() == 0 or db.numel() == 0:
        return dx, ddt, da, db, dc
    n = -(-length // CHUNK)
    if x.dtype == torch.bfloat16:
        plan = bwd_plan(b, length, h, g, p, s, sms=_sms(dev))
        slab, route = plan["heads_a_cta"], copy_route(x, bmat, c, dy)
        expected = (plan["grad_smem"], plan["walk_smem"])
        # S_in and dS_out as bf16 hi/lo tiles of 64 x 64, 2 S/64 of them a
        # (batch, head, chunk); (B, H, n, 4, 64) d(lg) pieces; a float a
        # (batch, head, chunk) for <S_in, dS_out> and da; a slab's dB, dC
        tiles = b * h * n * plan["walk_split"] * 64 * 64
        sizes = (tiles, tiles, 0, plan["slabs"] * b * length * g * s,
                 plan["slabs"] * b * length * g * s, b * n * h,
                 b * h * n * 4 * CHUNK, b * n * h)
    else:
        slab, route = 0, 0
        expected = (BWD_SMEM_BYTES[f32]["ssd_bwd_kernel<S<=64>" if s <= 64
                                        else "ssd_bwd_kernel<S<=128>"], 0)
        sizes = (b * n * h * s * p, b * n * h * s * p, b * n * h,
                 b * length * h * s, b * length * h * s, b * n * h, 0, 0)
    scratch = torch.empty(sum(sizes), dtype=f32, device=dev)
    ptrs = [t.data_ptr() if t.numel() else None
            for t in scratch.split(sizes)]
    args = _SsdBwdArgs(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        c.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(), *ptrs,
        *x.stride()[:3], *dt.stride(), *bmat.stride()[:3], *c.stride()[:3],
        *dy.stride()[:3], b, length, h, g, p, s, _DTYPE_CODE[x.dtype], slab,
        route if isinstance(route, int) else ROUTES.index(route))
    fn = _build.library("ssd_bwd.cu").ssd_scan_bwd
    fn.argtypes = [ctypes.POINTER(_SsdBwdArgs), ctypes.c_size_t,
                   ctypes.c_size_t, _P]
    fn.restype = ctypes.c_int
    _build.check(fn(ctypes.byref(args), *expected, stream_of(x)),
                 "ssd_scan_bwd")
    _counts.bwd_launches += 1
    return dx, ddt, da, db, dc


_SMS: dict = {}


def _sms(device) -> int:
    """The card's SM count (the plan's wave)."""
    key = torch.device(device).index or 0
    if key not in _SMS:
        _SMS[key] = torch.cuda.get_device_properties(
            key).multi_processor_count
    return _SMS[key]


def ssd_scan_bwd_attrs() -> dict:
    """``{kernel: {registers, local_bytes, shared_bytes, threads}}`` of the
    bf16 kernels of ``csrc/ssd_bwd.cu`` (`BWD_KERNELS`) as compiled
    (``cudaFuncGetAttributes``; ``local_bytes`` a thread are its spills).
    Needs the card."""
    fn = _build.library("ssd_bwd.cu").ssd_scan_bwd_attrs
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int), _I], ctypes.c_int
    out = (ctypes.c_int * (4 * len(BWD_KERNELS)))()
    _build.check(fn(out, len(BWD_KERNELS)), "ssd_scan_bwd_attrs")
    keys = ("registers", "local_bytes", "shared_bytes", "threads")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(BWD_KERNELS)}


class _Ssd(torch.autograd.Function):
    """`ssd_scan` under autograd: the forward keeps its inputs, the
    backward is `ssd_scan_bwd` (a final state nobody reads has no
    gradient: zero)."""

    @staticmethod
    def forward(ctx, x, dt, a, bmat, c, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, a, bmat, c)
        ctx.chunk = chunk
        return _forward(x, dt, a, bmat, c, chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, a, bmat, c = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(x)
        dx, ddt, da, db, dc = ssd_scan_bwd(x, dt, a, bmat, c, dy, dstate,
                                           chunk=ctx.chunk)
        return dx, ddt, da, db, dc, None


_counts = ssd_scan       # counts the launches: a patch of the name leaves
ssd_scan.launches = 0    # the counters alone
ssd_scan.bwd_launches = 0


def blocks_per_sm(dtype=torch.bfloat16) -> int:
    """CTAs of the kernel that one SM holds at once (CUDA's occupancy
    calculator, after the launcher's shared-memory attributes)."""
    fn = _build.library("ssd.cu").ssd_blocks_per_sm
    fn.argtypes, fn.restype = [_I, ctypes.POINTER(_I)], ctypes.c_int
    out = _I(0)
    _build.check(fn(_DTYPE_CODE[dtype], ctypes.byref(out)),
                 "ssd_blocks_per_sm")
    return out.value
