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
order) and on a CUDA tensor launches ``csrc/ssd_bwd.cu`` (four kernels,
one call: the chunks' state contributions, the carries across chunks,
each chunk's gradients, the heads of a group summed; no atomics, so a
second launch gives the same bits) and counts it in
``ssd_scan.bwd_launches``.  It recomputes the forward's chunk states
itself.  An unused final state's gradient counts as zero.
`ssd_scan_bwd_attrs` reads each compiled kernel's registers and local
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
        "dc", "states", "dstates", "decay", "dbp", "dcp", "dap")] + [
        (name, _L) for name in ("x_sb", "x_sl", "x_sh", "dt_sb", "dt_sl",
                                "dt_sh", "b_sb", "b_sl", "b_sg", "c_sb",
                                "c_sl", "c_sg", "dy_sb", "dy_sl",
                                "dy_sh")] + [
        (name, _I) for name in ("batch", "length", "heads", "groups",
                                "head_dim", "state_dim", "dtype")]


# the kernels of csrc/ssd_bwd.cu in the order ``ssd_scan_bwd_attrs``
# reports them
BWD_KERNELS = ("ssd_bwd_chunk_kernel<S<=128>", "ssd_bwd_scan_kernel",
               "ssd_bwd_kernel<S<=128>", "ssd_bwd_kernel<S<=64>",
               "ssd_bwd_reduce_kernel")

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


def copy_route(x, bmat, c) -> str:
    """How the bf16 kernel loads x, B and C: ``"tma"`` when every one has a
    16-byte aligned base and strides (but the last) that are nonzero whole
    16-byte multiples, as a tensor map needs; else ``"cp.async"``."""
    def tma_readable(t):
        return t.data_ptr() % 16 == 0 and all(
            st > 0 and st * t.element_size() % 16 == 0
            for st in t.stride()[:-1])
    return ROUTES[0] if all(map(tma_readable, (x, bmat, c))) else ROUTES[1]


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
    of its own) and counts it in ``ssd_scan.bwd_launches``.  dx, dB, dC
    come back contiguous in x's dtype, ddt and da in float32."""
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
    sizes = (b * n * h * s * p, b * n * h * s * p, b * n * h,
             b * length * h * s, b * length * h * s, b * n * h)
    scratch = torch.empty(sum(sizes), dtype=f32, device=dev)
    states, dstates, decay, dbp, dcp, dap = scratch.split(sizes)
    args = _SsdBwdArgs(
        x.data_ptr(), dt.data_ptr(), a.data_ptr(), bmat.data_ptr(),
        c.data_ptr(), dy.data_ptr(),
        None if dstate is None else dstate.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), da.data_ptr(), db.data_ptr(), dc.data_ptr(),
        *(t.data_ptr() for t in (states, dstates, decay, dbp, dcp, dap)),
        *x.stride()[:3], *dt.stride(), *bmat.stride()[:3], *c.stride()[:3],
        *dy.stride()[:3], b, length, h, g, p, s, _DTYPE_CODE[x.dtype])
    fn = _build.library("ssd_bwd.cu").ssd_scan_bwd
    fn.argtypes = [ctypes.POINTER(_SsdBwdArgs), _P]
    fn.restype = ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(x)), "ssd_scan_bwd")
    _counts.bwd_launches += 1
    return dx, ddt, da, db, dc


def ssd_scan_bwd_attrs() -> dict:
    """``{kernel: {registers, local_bytes, shared_bytes, threads}}`` of the
    kernels of ``csrc/ssd_bwd.cu`` as compiled (``cudaFuncGetAttributes``;
    ``local_bytes`` a thread are its spills), bf16 instantiations.  Needs
    the card."""
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
