"""Mamba2 SSD (state-space duality): the plain PyTorch oracles.

Recurrence per (batch, head) with a state matrix ``state (S, P)``::

    da_t    = exp(A * dt_t)                          # scalar decay, A < 0
    state_t = da_t * state_{t-1} + dt_t * B_t (x) x_t   # outer product
    y_t     = C_t @ state_t                          # (P,)

Layouts: x (B, L, H, P), dt (B, L, H), a (H,), B and C (B, L, G, S) with G
dividing H: head h reads group ``h // (H / G)``.  The JAX package repeats
the groups to heads before its oracles (``(B, L, H, S)``, the case G = H);
here they stay per group and `heads` repeats them where the math needs it.
All arithmetic is float32; y comes back in x's dtype (the JAX package's
``ssd_scan_ref`` returns float32 whatever x's dtype, its chunked form x's
dtype), the state in float32.

  * `ssd_scan_ref`    — the literal recurrence, a loop over L (the ground
                        truth; the decode step is one iteration of it).
  * `ssd_chunked_ref` — the chunked form: a quadratic term within each chunk
                        plus a scan of chunk states across chunks.  The
                        plain version of ``csrc/ssd.cu``.
"""
from __future__ import annotations

from typing import Optional

import torch


def heads(t: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, L, G, S) per group -> (B, L, H, S) per head (a copy): group g
    serves heads ``g * H/G .. (g + 1) * H/G - 1``, as ``jnp.repeat``."""
    g = t.shape[2]
    if n_heads % g:
        raise ValueError(f"{g} groups do not divide {n_heads} heads")
    return t.repeat_interleave(n_heads // g, dim=2)


def ssd_scan_ref(x, dt, a, b, c, state0: Optional[torch.Tensor] = None):
    """x (B,L,H,P), dt (B,L,H), a (H,), b/c (B,L,G,S) ->
    (y (B,L,H,P), state_final (B,H,S,P) float32)."""
    bsz, length, h, p = x.shape
    s = b.shape[-1]
    xf, dtf = x.float(), dt.float()
    bf, cf = heads(b, h).float(), heads(c, h).float()
    a = a.float()
    state = (torch.zeros((bsz, h, s, p), dtype=torch.float32,
                         device=x.device) if state0 is None
             else state0.float())
    ys = []
    for t in range(length):
        dtt = dtf[:, t]                                       # (B,H)
        da = torch.exp(a[None, :] * dtt)
        upd = dtt[..., None, None] * bf[:, t, :, :, None] \
            * xf[:, t, :, None, :]
        state = da[..., None, None] * state + upd             # (B,H,S,P)
        ys.append(torch.einsum("bhs,bhsp->bhp", cf[:, t], state))
    y = (torch.stack(ys, 1) if ys
         else torch.zeros((bsz, 0, h, p), device=x.device))
    return y.to(x.dtype), state


def ssd_chunked_ref(x, dt, a, bmat, c, state0: Optional[torch.Tensor] = None,
                    chunk: int = 64):
    """The chunked SSD: the same result as `ssd_scan_ref` up to float
    rounding.  L must be a multiple of ``chunk``."""
    bsz, length, h, p = x.shape
    s = bmat.shape[-1]
    if length % chunk:
        raise ValueError(f"length {length} is not a multiple of the chunk "
                         f"{chunk}; pad it with dt = 0 steps")
    n = length // chunk
    xc = x.float().reshape(bsz, n, chunk, h, p)
    dtc = dt.float().reshape(bsz, n, chunk, h)
    bc = heads(bmat, h).float().reshape(bsz, n, chunk, h, s)
    cc = heads(c, h).float().reshape(bsz, n, chunk, h, s)
    a = a.float()
    state = (torch.zeros((bsz, h, s, p), dtype=torch.float32,
                         device=x.device) if state0 is None
             else state0.float())

    # cumulative log-decay within each chunk: lg[b,n,t,h] = A_h cumsum(dt)
    lg = a * torch.cumsum(dtc, dim=2)                         # (B,n,Q,H)

    # intra-chunk (the "duality" product): decay(t, z) = exp(lg_t - lg_z)
    # for z <= t, formed only there (the differences are <= 0)
    lgh = lg.permute(0, 1, 3, 2)                              # (B,n,H,Q)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    diff = lgh[..., :, None] - lgh[..., None, :]              # (B,n,H,t,z)
    gate = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    cb = torch.einsum("bnths,bnzhs->bnhtz", cc, bc)
    g = cb * gate * dtc.permute(0, 1, 3, 2)[..., None, :]
    y_intra = torch.einsum("bnhtz,bnzhp->bnthp", g, xc)

    # chunk states: sum_t exp(lg_last - lg_t) dt_t B_t (x) x_t
    chunk_decay = torch.exp(lg[:, :, -1, :])                  # (B,n,H)
    w = torch.exp(lg[:, :, -1:, :] - lg) * dtc                # (B,n,Q,H)
    state_c = torch.einsum("bnths,bnthp->bnhsp", bc * w[..., None], xc)

    # carry across chunks (n is small: L / chunk)
    sins = []
    for i in range(n):
        sins.append(state)
        state = chunk_decay[:, i, :, None, None] * state + state_c[:, i]
    sins = torch.stack(sins, 1)                               # (B,n,H,S,P)

    # inter-chunk output: y_t += exp(lg_t) * C_t @ state_in
    y_inter = torch.einsum("bnths,bnhsp->bnthp", cc, sins) \
        * torch.exp(lg)[..., None]
    y = (y_intra + y_inter).reshape(bsz, length, h, p)
    return y.to(x.dtype), state


def ssd_scan_bwd_plain(x, dt, a, bmat, c, dy, dstate=None, *,
                       chunk: int = 64):
    """The gradient of the chunked scan from a zero state, (y, final
    state) = `ssd_chunked_ref` on any L, for the output gradient ``dy``
    (B,L,H,P) and the final state's ``dstate`` (B,H,S,P) float32 or None
    (zero).  Returns (dx, ddt, da, dB, dC): dx, dB, dC in the dtypes of x,
    B, C (float32 sums rounded once), ddt (B,L,H) and da (H,) float32.

    Written out without autograd, in the order ``csrc/ssd_bwd.cu`` computes
    it, per (batch, chunk, head) with lg the chunk's cumulative
    ``a * cumsum(dt)``, w_z = exp(lg_last - lg_z) dt_z and
    G_tz = (C_t . B_z) exp(lg_t - lg_z) dt_z (z <= t):
      1. the states entering each chunk, S_in, by the forward's carry;
      2. a reverse carry of the state's gradient from ``dstate``,
         dS_in = exp(lg_last) dS_out + sum_t exp(lg_t) C_t (x) dy_t;
      3. within the chunk, with dG_tz = dy_t . x_z:
         dx_z = sum_t G_tz dy_t + w_z dS_out^T B_z,
         dC_t = sum_z dG_tz exp(lg_t - lg_z) dt_z B_z + exp(lg_t) S_in dy_t,
         dB_z = sum_t dG_tz exp(lg_t - lg_z) dt_z C_t + w_z dS_out x_z,
         d(dt_z) = sum_t dG_tz (C_t . B_z) exp(lg_t - lg_z)
                   + exp(lg_last - lg_z) (B_z . dS_out x_z),
         and d(lg) from the decays, the inter-chunk term and the state's;
      4. d(lg) through a reverse cumsum times ``a`` into ddt, and times
         cumsum(dt) into da (summed over batch and length).
    The length is padded to whole chunks with dt = 0 steps, as the forward
    pads it; a head's dB and dC add into its group's in head order."""
    bsz, length, h, p = x.shape
    g, s = bmat.shape[2], bmat.shape[3]
    pad = (-length) % chunk
    f32 = torch.float32
    xf, dyf, dtf = x.float(), dy.float(), dt.float()
    bf, cf = heads(bmat, h).float(), heads(c, h).float()
    if pad:
        xf, dyf, bf, cf = (torch.nn.functional.pad(t, (0, 0, 0, 0, 0, pad))
                           for t in (xf, dyf, bf, cf))
        dtf = torch.nn.functional.pad(dtf, (0, 0, 0, pad))
    n = (length + pad) // chunk
    xc = xf.reshape(bsz, n, chunk, h, p)
    dyc = dyf.reshape(bsz, n, chunk, h, p)
    dtc = dtf.reshape(bsz, n, chunk, h)
    bc = bf.reshape(bsz, n, chunk, h, s)
    cc = cf.reshape(bsz, n, chunk, h, s)
    a = a.float()
    cs = torch.cumsum(dtc, dim=2)                             # (B,n,Q,H)
    lg = a * cs
    el = torch.exp(lg)
    last = torch.exp(lg[:, :, -1, :])                         # (B,n,H)
    w = torch.exp(lg[:, :, -1:, :] - lg) * dtc                # (B,n,Q,H)

    # 1. the state entering each chunk
    state_c = torch.einsum("bnths,bnthp->bnhsp", bc * w[..., None], xc)
    state = torch.zeros((bsz, h, s, p), dtype=f32, device=x.device)
    sins = []
    for i in range(n):
        sins.append(state)
        state = last[:, i, :, None, None] * state + state_c[:, i]
    sins = torch.stack(sins, 1)                               # (B,n,H,S,P)

    # 2. the state's gradient leaving each chunk, carried in reverse
    dsc = torch.einsum("bnths,bnthp->bnhsp", cc * el[..., None], dyc)
    ds = (torch.zeros((bsz, h, s, p), dtype=f32, device=x.device)
          if dstate is None else dstate.float())
    douts = [None] * n
    for i in reversed(range(n)):
        douts[i] = ds
        ds = last[:, i, :, None, None] * ds + dsc[:, i]
    douts = torch.stack(douts, 1)                             # (B,n,H,S,P)

    # 3. within the chunk: the quadratic term (z <= t) ...
    lgh = lg.permute(0, 1, 3, 2)                              # (B,n,H,Q)
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()
    diff = lgh[..., :, None] - lgh[..., None, :]              # (B,n,H,t,z)
    decay = torch.where(tri, torch.exp(torch.where(tri, diff, 0.0)), 0.0)
    dtz = dtc.permute(0, 1, 3, 2)[..., None, :]               # (B,n,H,1,z)
    cb = torch.einsum("bnths,bnzhs->bnhtz", cc, bc)
    dg = torch.einsum("bnthp,bnzhp->bnhtz", dyc, xc)
    gm = cb * decay * dtz
    nm = dg * cb * decay                                      # dG.G / dt_z
    dcb = dg * decay * dtz
    dx = torch.einsum("bnhtz,bnthp->bnzhp", gm, dyc)
    dcm = torch.einsum("bnhtz,bnzhs->bnths", dcb, bc)
    dbm = torch.einsum("bnhtz,bnths->bnzhs", dcb, cc)
    ddt = nm.sum(-2).permute(0, 1, 3, 2)                      # (B,n,Q,H)
    mm = nm * dtz
    dlg = (mm.sum(-1) - mm.sum(-2)).permute(0, 1, 3, 2)
    # ... the inter-chunk term ...
    sdy = torch.einsum("bnhsp,bnthp->bnths", sins, dyc)       # S_in dy_t
    dcm = dcm + el[..., None] * sdy
    dlg = dlg + el * (cc * sdy).sum(-1)
    # ... and the chunk's contribution to the state it passes on
    dsx = torch.einsum("bnhsp,bnzhp->bnzhs", douts, xc)       # dS_out x_z
    dbm = dbm + w[..., None] * dsx
    dx = dx + w[..., None] * torch.einsum("bnhsp,bnzhs->bnzhp", douts, bc)
    dw = (bc * dsx).sum(-1)                                   # (B,n,Q,H)
    ddt = ddt + dw * torch.exp(lg[:, :, -1:, :] - lg)
    dww = dw * w
    dlg = dlg - dww
    dlg[:, :, -1] += dww.sum(2) + last * (sins * douts).sum((-2, -1))

    # 4. lg = a * cumsum(dt)
    da = (dlg * cs).sum((0, 1, 2))
    ddt = ddt + a * torch.flip(torch.cumsum(torch.flip(dlg, (2,)), 2), (2,))

    def cut(t):
        return t.reshape(bsz, n * chunk, *t.shape[3:])[:, :length]

    def groups(t):
        return cut(t).unflatten(2, (g, h // g)).sum(3)

    return (cut(dx).to(x.dtype), cut(ddt), da,
            groups(dbm).to(bmat.dtype), groups(dcm).to(c.dtype))
