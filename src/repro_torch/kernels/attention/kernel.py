"""Flash attention: wrappers of ``csrc/flash_attention.cu`` and
``csrc/flash_attention_bwd.cu`` and their plain versions.

`flash_attention` takes q (B, Sq, H, D) and k/v (B, Skv, HKV, D) in float32
or bfloat16, read in that layout through their strides (the last dim must
be contiguous), and returns (B, Sq, H, D) in q's dtype.  D is one of
`HEAD_DIMS`, the head widths of the repo's configs (16, 24 and 32 in the
smoke configs, 64, 112 in zamba2-7b, 128); the kernel runs at the padded
width 64 or 128, the columns beyond D read as zeros and never stored, so
D = 112 costs what D = 128 costs.  Any other D raises.  Causal masking
puts the queries at the last Sq key positions; ``kv_len`` hides keys at
and beyond it.  A CPU tensor takes the plain version (`ref.mha`); a CUDA
tensor launches the kernel and counts it in ``flash_attention.launches``.

On the card, bfloat16 runs a Hopper kernel: TMA loads through an mbarrier
ring and ``wgmma`` for both products, with P split into two bf16 terms
(P_hi + P_lo) so that P V keeps ~16 bits of P, as the float32 references
need; float32 runs a CUDA-core kernel that holds 1e-5.  TMA reads a bf16
tensor only from a 16-byte-aligned base with strides that are multiples
of 16 bytes, so a bf16 view that fails that raises `ValueError` here: it
is neither copied nor sent another way.

Gradients.  Where autograd will differentiate the output (grad mode on and
q, k or v requiring grad), `flash_attention` runs as a
`torch.autograd.Function`: its forward also writes each row's float32
log-sum-exp (B, H, Sq), and its backward is `flash_attention_bwd`, which on
a CPU tensor takes `flash_attention_bwd_plain` (`ref.mha_bwd`) and on a
CUDA tensor launches ``csrc/flash_attention_bwd.cu`` and counts it in
``flash_attention.bwd_launches``: two kernels, dq per query tile (it
also stores delta = rowsum(dO * O) for the second), then dk and dv per
key tile with GQA summed inside, no atomics, so a second launch gives
the same bits.  In bfloat16 both are Hopper kernels:
TMA loads of q, k, v and dO through an mbarrier ring and ``wgmma`` for
every product, with P and dS split hi + lo before the products that take
them, as the forward splits P; so o and do, like q, k and v, must have a
16-byte-aligned base and strides of whole 16 bytes, or it raises
`ValueError`.  float32 runs CUDA-core kernels that hold 1e-5.
`flash_attention_bwd_attrs` reads each compiled kernel's registers and
local (spill) bytes.  Without grad (serving) the forward launches as
before and writes no log-sum-exp.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.attention import ref as _ref
from repro_torch.kernels.plasticity.kernel import on_card, stream_of

flash_attention_plain = _ref.mha
flash_attention_bwd_plain = _ref.mha_bwd

HEAD_DIMS = (16, 24, 32, 64, 112, 128)   # head widths the kernel takes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong


class _AttnArgs(ctypes.Structure):
    """``AttnArgs`` of csrc/flash_attention.cu (strides in elements)."""
    _fields_ = [(name, _P) for name in ("q", "k", "v", "o")] + [
        (name, _L) for name in ("q_sb", "q_ss", "q_sh", "k_sb", "k_ss",
                                "k_sh", "v_sb", "v_ss", "v_sh")] + [
        (name, _I) for name in ("batch", "sq", "skv", "heads", "kv_heads",
                                "head_dim", "causal", "kv_len", "q_offset",
                                "dtype")] + [("scale", ctypes.c_float),
                                             ("lse", _P)]


_STRIDED = ("q", "k", "v", "o", "do")


class _AttnBwdArgs(ctypes.Structure):
    """``AttnBwdArgs`` of csrc/flash_attention_bwd.cu."""
    _fields_ = [(name, _P) for name in (
        "q", "k", "v", "o", "lse", "dout", "dq", "dk", "dv", "delta",
        "lse2")] + [
        (f"{t}_{s}", _L) for t in _STRIDED for s in ("sb", "ss", "sh")] + [
        (name, _I) for name in ("batch", "sq", "skv", "heads", "kv_heads",
                                "head_dim", "causal", "kv_len", "q_offset",
                                "dtype", "sq_pad")] + [
        ("scale", ctypes.c_float)]


_BWD_ROWS = 64        # the bf16 kernels' scratch rows are padded to this

# the kernels of csrc/flash_attention_bwd.cu in the order
# ``flash_attention_bwd_attrs`` reports them
BWD_KERNELS = ("dq_wgmma_kernel<64>", "dq_wgmma_kernel<128>",
               "dkdv_wgmma_kernel<64>", "dkdv_wgmma_kernel<128>",
               "dq_kernel<64>", "dq_kernel<128>", "dkdv_kernel<64>",
               "dkdv_kernel<128>")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None):
    """q (B,Sq,H,D), k/v (B,Skv,HKV,D) -> (B,Sq,H,D)."""
    if _wants_grad(q, k, v):
        return _Flash.apply(q, k, v, causal, scale, kv_len)
    if not on_card(q):
        return flash_attention_plain(q, k, v, causal=causal, scale=scale,
                                     kv_len=kv_len)
    return _forward(q, k, v, causal, scale, kv_len, with_lse=False)[0]


def _check(q, k, v):
    """The kernels' contract on q (B,Sq,H,D) and k/v (B,Skv,HKV,D)."""
    b, sq, h, d = q.shape
    if k.ndim != 4 or k.shape[0] != b or k.shape[3] != d \
            or v.shape != k.shape:
        raise ValueError(f"k and v must be (B, Skv, HKV, D) with B = {b}, "
                         f"D = {d}; got k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{h} query heads do not group over {hkv} KV heads")
    if d not in HEAD_DIMS:
        raise ValueError(f"the attention kernel is built for head_dim in "
                         f"{HEAD_DIMS}; got {d}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"the attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}: the kernel reads the head dim "
                             f"contiguously; got strides {t.stride()}")
        _check_tma(name, t)


def _check_tma(name, t):
    """A bf16 operand's contract for TMA (and 16-byte loads): a
    16-byte-aligned base and strides of whole 16 bytes."""
    if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(st * 2 % 16 for st in t.stride()[:3])):
        raise ValueError(f"{name}: TMA needs a 16-byte-aligned base and "
                         f"strides of whole 16 bytes; got address "
                         f"{t.data_ptr():#x}, strides {t.stride()} "
                         f"(elements of 2 bytes)")


def _forward(q, k, v, causal, scale, kv_len, with_lse: bool):
    """One launch of the forward kernel: (o, lse (B,H,Sq) float32 or
    None)."""
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = d ** -0.5 if scale is None else scale
    kv_len = skv if kv_len is None else min(kv_len, skv)
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if o.numel() == 0:
        return o, lse
    args = _AttnArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                     *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                     b, sq, skv, h, hkv, d, int(causal), kv_len, skv - sq,
                     _DTYPE_CODE[q.dtype], scale,
                     None if lse is None else lse.data_ptr())
    fn = _build.library("flash_attention.cu").flash_attention
    fn.argtypes, fn.restype = [ctypes.POINTER(_AttnArgs), _P], ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(q)), "flash_attention")
    _counts.launches += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, lse, do, *, causal: bool = True,
                        scale: Optional[float] = None,
                        kv_len: Optional[int] = None):
    """The gradient (dq, dk, dv) of `flash_attention` at q, k, v for the
    output gradient ``do`` (B,Sq,H,D), given the forward's output ``o`` and
    row log-sum-exp ``lse`` (B,H,Sq) float32.  A CPU tensor takes
    `flash_attention_bwd_plain`; a CUDA tensor launches
    ``csrc/flash_attention_bwd.cu`` (its two kernels, one call) and counts
    it in ``flash_attention.bwd_launches``."""
    if not on_card(q):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         scale=scale, kv_len=kv_len)
    _check(q, k, v)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} must be q's shape {tuple(q.shape)}, "
                             f"dtype and device; got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 \
            or not lse.is_contiguous():
        raise ValueError(f"lse must be contiguous float32 {(b, h, sq)}; got "
                         f"{tuple(lse.shape)} {lse.dtype}")
    o, do = (t if t.stride(3) == 1 else t.contiguous() for t in (o, do))
    for name, t in (("o", o), ("do", do)):
        _check_tma(name, t)
    scale = d ** -0.5 if scale is None else scale
    kv_len = skv if kv_len is None else min(kv_len, skv)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    # delta and lse * log2(e), each row padded to whole 64-query blocks
    sq_pad = -(-sq // _BWD_ROWS) * _BWD_ROWS
    scratch = torch.empty((2, b, h, sq_pad), dtype=torch.float32,
                          device=q.device)
    args = _AttnBwdArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        o.data_ptr(), lse.data_ptr(), do.data_ptr(),
                        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                        scratch[0].data_ptr(), scratch[1].data_ptr(),
                        *(st for t in (q, k, v, o, do)
                          for st in t.stride()[:3]),
                        b, sq, skv, h, hkv, d, int(causal), kv_len, skv - sq,
                        _DTYPE_CODE[q.dtype], sq_pad, scale)
    fn = _build.library("flash_attention_bwd.cu").flash_attention_bwd
    fn.argtypes = [ctypes.POINTER(_AttnBwdArgs), _P]
    fn.restype = ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(q)), "flash_attention_bwd")
    _counts.bwd_launches += 1
    return dq, dk, dv


def flash_attention_bwd_attrs() -> dict:
    """``{kernel: {registers, local_bytes, shared_bytes, threads}}`` of
    every kernel of ``csrc/flash_attention_bwd.cu`` as compiled
    (``cudaFuncGetAttributes``; ``local_bytes`` a thread are its spills).
    Needs the card."""
    fn = _build.library("flash_attention_bwd.cu").flash_attention_bwd_attrs
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int), _I], ctypes.c_int
    out = (ctypes.c_int * (4 * len(BWD_KERNELS)))()
    _build.check(fn(out, len(BWD_KERNELS)), "flash_attention_bwd_attrs")
    keys = ("registers", "local_bytes", "shared_bytes", "threads")
    return {name: dict(zip(keys, out[4 * i:4 * i + 4]))
            for i, name in enumerate(BWD_KERNELS)}


class _Flash(torch.autograd.Function):
    """`flash_attention` under autograd: the forward keeps its output and
    row log-sum-exp, the backward is `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, kv_len):
        if on_card(q):
            o, lse = _forward(q, k, v, causal, scale, kv_len, with_lse=True)
        else:
            o, lse = _ref.mha_lse(q, k, v, causal=causal, scale=scale,
                                  kv_len=kv_len)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, scale=scale, kv_len=kv_len)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None


_counts = flash_attention   # counts the launches: a patch of the name
flash_attention.launches = 0          # leaves the counters alone
flash_attention.bwd_launches = 0
