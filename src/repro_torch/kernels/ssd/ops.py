"""Public entry of the SSD scan and the one-token recurrent step.

``ssd(x, dt, a, bmat, c, chunk=)``: x (B,L,H,P), dt (B,L,H), a (H,),
B/C (B,L,G,S) -> (y (B,L,H,P), final state (B,H,S,P) float32).  The
backend follows the tensors' device: a CUDA tensor launches
``csrc/ssd.cu``, which masks a ragged length in the kernel; a CPU tensor
takes its plain version, which pads the length with dt = 0 steps (see
`kernel.ssd_scan`, whose launch counters this shares).  Under autograd it
runs as a Function whose backward is `kernel.ssd_scan_bwd`
(``csrc/ssd_bwd.cu`` on the card).

`ssd_decode_step` is one step of the recurrence for a decode token, plain
PyTorch as it is plain jnp in the JAX package; it writes the new state IN
PLACE into the cache's state tensor it is given (the JAX package returns an
updated copy).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssd.kernel import ssd_scan as ssd


def ssd_decode_step(state, xt, dtt, a, bt, ct, active=None):
    """state (B,H,S,P) float32, updated in place; xt (B,H,P); dtt (B,H);
    bt/ct (B,G,S), head h reading group ``h // (H / G)``.  ``active (B,)``
    leaves a vacant stream's state as it was (the new rows are selected,
    in the same float32 operations).
    Returns (state, y (B,H,P) float32: the JAX package's step returns
    float32 whatever xt's dtype, and the model computes on in float32)."""
    h, g = xt.shape[1], bt.shape[1]
    if h % g:
        raise ValueError(f"{g} groups do not divide {h} heads")
    xf, dtf = xt.float(), dtt.float()
    bf = bt.float().repeat_interleave(h // g, dim=1)          # (B,H,S)
    cf = ct.float().repeat_interleave(h // g, dim=1)
    da = torch.exp(a.float()[None, :] * dtf)                  # (B,H)
    upd = dtf[..., None, None] * bf[..., :, None] * xf[..., None, :]
    if active is None:
        state.mul_(da[..., None, None]).add_(upd)
    else:
        new = state * da[..., None, None] + upd
        mask = active.to(torch.bool).reshape(-1, 1, 1, 1)
        state.copy_(torch.where(mask, new, state))
    y = torch.einsum("bhs,bhsp->bhp", cf, state)
    return state, y
