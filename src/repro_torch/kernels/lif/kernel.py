"""Forward Engine kernel: wrapper of ``csrc/lif_forward.cu`` and its plain
version.

`lif_forward` runs one layer's psum-stationary product, LIF neuron and trace
update without plasticity.  A CPU tensor takes the plain version
(`lif_forward_plain`, any float dtype); a CUDA tensor launches the kernel
(every operand float32, or every one bfloat16) and counts it in
``lif_forward.launches``, a bfloat16 launch also in
``lif_forward.bf16_launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.lif import ref as _ref
from repro_torch.kernels.plasticity.kernel import (FParams, expect, f_params,
                                                   float_dtype, on_card,
                                                   stream_of)

lif_forward_plain = _ref.lif_forward

_P = ctypes.c_void_p


class _LifArgs(ctypes.Structure):
    """``LifArgs`` of csrc/lif_forward.cu."""
    _fields_ = [(name, _P) for name in (
        "x", "w", "v", "trace", "spikes", "v_out", "trace_out")] + [
        (name, ctypes.c_int) for name in ("batch", "k", "m")] + [
        ("f", FParams)]


def lif_forward(x, w, v, trace, *, tau_m: float = 2.0, v_th: float = 1.0,
                v_reset: float = 0.0, trace_decay: float = 0.8):
    """x (B,K), w (K,M), v (B,M), trace (B,M) ->
    (spikes (B,M), v_out (B,M), trace_new (B,M))."""
    if not on_card(x):
        return lif_forward_plain(x, w, v, trace, tau_m=tau_m, v_th=v_th,
                                 v_reset=v_reset, trace_decay=trace_decay)
    b, k = x.shape
    m = w.shape[1]
    dev = x.device
    dt = float_dtype("LIF forward kernel", (("x", x), ("w", w), ("v", v),
                                            ("trace", trace)))
    x = expect("x", x, (b, k), dt, dev)
    w = expect("w", w, (k, m), dt, dev)
    v = expect("v", v, (b, m), dt, dev)
    trace = expect("trace", trace, (b, m), dt, dev)
    spikes = torch.empty((b, m), dtype=dt, device=dev)
    v_out, tr_out = torch.empty_like(v), torch.empty_like(trace)
    args = _LifArgs(x.data_ptr(), w.data_ptr(), v.data_ptr(),
                    trace.data_ptr(), spikes.data_ptr(), v_out.data_ptr(),
                    tr_out.data_ptr(), b, k, m,
                    f_params(tau_m, v_th, v_reset, trace_decay))
    bf16 = dt == torch.bfloat16
    entry = "lif_forward_bf16" if bf16 else "lif_forward_f32"
    fn = getattr(_build.library("lif_forward.cu"), entry)
    fn.argtypes, fn.restype = [ctypes.POINTER(_LifArgs), _P], ctypes.c_int
    _build.check(fn(ctypes.byref(args), stream_of(x)), entry)
    lif_forward.launches += 1
    lif_forward.bf16_launches += int(bf16)
    return spikes, v_out, tr_out


lif_forward.launches = 0
lif_forward.bf16_launches = 0       # the bfloat16 instantiation's share
