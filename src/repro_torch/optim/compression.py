"""Symmetric per-tensor int8 quantization (and its inverse).

``scale=None`` derives the scale from the tensor's absolute max (the
gradient-compression mode).  A FIXED ``scale`` quantizes onto a known grid
instead — `snn.quantize_state` moving a float session onto the int8 weight
grid ``2**-w_frac_bits``, where the grid must not depend on the data.
"""
from __future__ import annotations

import torch


def compress_int8(x: torch.Tensor, scale=None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns ``(q int8, scale f32)`` with ``q = clip(round(x / scale),
    -127, 127)`` (round half to even, IEEE division)."""
    xf = x.float()
    if scale is None:
        scale = torch.clamp(xf.abs().max(), min=1e-12) / 127.0
    else:
        scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale) -> torch.Tensor:
    return q.float() * scale
