"""Mixture-of-Experts FFN with capacity-bounded sort-based dispatch.

Fine-grained MoE as deepseek-moe writes it (shared + routed experts,
top-k) and grok-1's (8 experts, top-2), as in the JAX package: tokens are
routed in float32, sorted by assigned expert (a stable sort), and each
expert takes a buffer of ``cap`` rows; an assignment past its expert's
capacity is dropped (its gate weight 0, its row the trash row), and the
experts' outputs come back weighted by the renormalised gates.

These differ from a direct transcription, none in the result:

* the buffer is laid out expert-major, ``(E, G * cap, D)`` plus one zero
  trash row, so that the expert products are one batched GEMM each and
  the combine gathers from the GEMM's own output (no copy between);
* the combine sums each token's K contributions in float32 in the order
  the JAX package's scatter-add applies them (ascending sorted position,
  i.e. ascending expert id), as K gathers and adds: no atomics, so two
  runs on the card give the same bits;
* under autograd the dispatch and the combine are
  `torch.autograd.Function`s (`_Dispatch`, `_Combine`) whose backwards
  gather in the same order from the index tables the forward builds, and
  the gates reach the sorted assignments through a permutation whose
  backward gathers by its inverse (`_Permute`): no accumulating scatter
  (``index_add_``, ``index_put_(accumulate=True)``, ``scatter_add_``;
  the first and last add atomically on CUDA) runs anywhere in the
  block's backward, so two backwards on the card give the same bits
  too.  Autograd of the indexing forms (`dispatch_plain`,
  `combine_plain`) gives those bits as well, on the CPU and on the card:
  ``index_put_`` with accumulation adds duplicates in index order, and
  the gate gathers' ``scatter_add_`` writes each target once;
* ``groups`` is explicit (default 1): the JAX package resolves
  ``groups <= 0`` from its mesh, which is one group on one device.  No
  serving path sets it; only the parity tests take 2 groups;
* `apply` takes the block's residual and its normed input, which the
  block computes (`transformer._ffn`), so the norm reads the attention
  residual's sum before it rounds, as XLA does.

Nothing in `route` or `apply` reads the device: ``cap`` follows from
shapes, and no op has a data-dependent shape, so a pool step stays
shape-static.  ``token_mask (B, S)`` marks valid tokens: a masked token's
assignments take the sentinel expert ``E`` before the sort, so they sort
behind every real one and never take a capacity row a valid token would
get (the decode pool's no-op contract for vacant slots).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models import layers
from repro_torch.models.layers import ParamDesc, rms_norm, swiglu


def plan(cfg: ModelConfig, stack: int = 0) -> dict:
    """Parameter plan of one MoE FFN (stacked ``stack`` deep if > 0): the
    float32 router, the routed experts' ``(E, D, F)`` gate and up and
    ``(E, F, D)`` down, and with ``n_shared`` the shared experts as one
    SwiGLU of width ``n_shared * d_expert``."""
    moe = cfg.moe
    d, f, e = cfg.d_model, moe.d_expert, moe.num_experts

    def desc(shape, **kw):
        kw.setdefault("dtype", cfg.dtype)
        return ParamDesc((stack, *shape) if stack else shape, **kw)

    p = {
        "norm": desc((d,), init="ones"),
        "router": desc((d, e), fan_in=d, dtype="float32"),
        "w_gate": desc((e, d, f), fan_in=d),
        "w_up": desc((e, d, f), fan_in=d),
        "w_down": desc((e, f, d), fan_in=f),
    }
    if moe.n_shared:
        fs = moe.n_shared * moe.d_expert
        p["ws_gate"] = desc((d, fs), fan_in=d)
        p["ws_up"] = desc((d, fs), fan_in=d)
        p["ws_down"] = desc((fs, d), fan_in=fs)
    return p


def n_groups(batch: int, groups: int) -> int:
    """Dispatch groups ride the batch dim: gcd(batch, groups), at least 1."""
    return max(1, math.gcd(batch, groups))


def capacity(cfg: ModelConfig, tokens_per_group: int) -> int:
    """Buffer rows per expert and group, as the JAX package sizes them."""
    moe = cfg.moe
    return max(int(moe.capacity_factor * tokens_per_group * moe.top_k
                   / moe.num_experts), 1)


@dataclasses.dataclass
class Routing:
    """One dispatch, per group ``g`` and sorted assignment ``j``:

    expert_idx (G, Tg, K)  each token's experts (``E`` where masked)
    gates      (G, Tg, K)  their renormalised float32 gates
    order      (G, Tg*K)   the stable sort of the flat assignments
    inv        (G, Tg*K)   each flat assignment's sorted position
                           (``order``'s inverse)
    tok        (G, Tg*K)   the assignment's token within its group
    w          (G, Tg*K)   its gate weight, 0 where dropped
    keep       (G, Tg*K)   not dropped
    row        (G, Tg*K)   its row of the expert-major buffer
                           ``(E * G * cap + 1, D)``, the last the trash
    cap        rows per expert and group
    """
    expert_idx: torch.Tensor
    gates: torch.Tensor
    order: torch.Tensor
    inv: torch.Tensor
    tok: torch.Tensor
    w: torch.Tensor
    keep: torch.Tensor
    row: torch.Tensor
    cap: int


def route(h, router, cfg: ModelConfig, groups: int = 1, token_mask=None):
    """Routing and dispatch order of the normed tokens ``h (B, S, D)``:
    float32 logits, softmax, top-k (ties to the lower expert id, as
    ``lax.top_k``), the gates renormalised; then the stable
    sort by expert and each assignment's position in its expert's queue.
    Returns a `Routing`."""
    moe = cfg.moe
    b, s, d = h.shape
    e, k = moe.num_experts, moe.top_k
    g_n = n_groups(b, groups)
    tg = b * s // g_n
    logits = h.reshape(g_n, tg, d).float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, expert_idx = (t[..., :k] for t in torch.sort(
        probs, dim=-1, descending=True, stable=True))
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    if token_mask is not None:
        mask = token_mask.reshape(g_n, tg, 1).to(torch.bool)
        expert_idx = torch.where(mask, expert_idx,
                                 torch.full_like(expert_idx, e))
    cap = capacity(cfg, tg)
    flat_e = expert_idx.reshape(g_n, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    pos = (torch.arange(tg * k, device=h.device)
           - torch.searchsorted(sorted_e, sorted_e, side="left"))
    keep = (pos < cap) & (sorted_e < e)
    tok = order // k
    inv = _inverse(order)
    w = torch.where(keep, _Permute.apply(gates.reshape(g_n, tg * k), order,
                                         inv),
                    torch.zeros((), device=h.device))
    grp = torch.arange(g_n, device=h.device)[:, None]
    row = torch.where(keep, sorted_e * (g_n * cap) + grp * cap + pos,
                      torch.full_like(pos, e * g_n * cap))
    return Routing(expert_idx, gates, order, inv, tok, w, keep, row, cap)


def _inverse(perm):
    """The inverse of the permutations ``perm (G, N)`` along the last dim
    (a scatter of positions to unique indices, nothing differentiated)."""
    n = perm.shape[-1]
    return torch.empty_like(perm).scatter_(
        -1, perm, torch.arange(n, device=perm.device).expand(perm.shape))


class _Permute(torch.autograd.Function):
    """``x.gather(-1, perm)`` for a permutation ``perm`` along the last dim,
    whose backward gathers the gradient by the inverse ``inv`` (autograd's
    gather backward is an accumulating scatter)."""

    @staticmethod
    def forward(ctx, x, perm, inv):
        ctx.save_for_backward(inv)
        return x.gather(-1, perm)

    @staticmethod
    def backward(ctx, g):
        inv, = ctx.saved_tensors
        return g.gather(-1, inv), None, None


def _token_tables(r: Routing, tg: int):
    """Each token's K assignments in ascending sorted position (ascending
    expert id), the order in which the JAX package's scatter-adds apply
    them: (pos (G, Tg*K) their sorted positions, token-major; rows (G, Tg,
    K) their buffer rows, the trash row where dropped)."""
    g_n, n = r.order.shape
    k = n // tg
    pos = r.inv.reshape(g_n, tg, k).sort(dim=-1).values.reshape(g_n, n)
    return pos, r.row.gather(-1, pos).reshape(g_n, tg, k)


def _flat_dispatch(r: Routing, cfg: ModelConfig):
    """(each flat assignment's buffer row, its token of the flattened
    ``h``, the buffer's rows before the trash row)."""
    g_n, n = r.order.shape
    tg = n // cfg.moe.top_k
    src = r.tok + torch.arange(g_n, device=r.tok.device)[:, None] * tg
    return (r.row.reshape(-1), src.reshape(-1),
            cfg.moe.num_experts * g_n * r.cap)


def _fill(h, row, src, rows: int):
    d = h.shape[-1]
    buf = h.new_zeros((rows + 1, d))
    buf[row] = h.reshape(-1, d)[src]
    return buf


def dispatch(h, r: Routing, cfg: ModelConfig):
    """The expert-major buffer ``(E * G * cap + 1, D)`` of the normed
    tokens ``h (B, S, D)``: row ``r.row[j]`` holds assignment j's token;
    the rows no token fills are zero, the last (trash) row is never
    read.  Under autograd `_Dispatch`: ``h``'s gradient gathers each
    token's kept rows."""
    if layers._grad_wanted(h):
        tg = r.order.shape[1] // cfg.moe.top_k
        return _Dispatch.apply(h, *_flat_dispatch(r, cfg),
                               _token_tables(r, tg)[1])
    return dispatch_plain(h, r, cfg)


def dispatch_plain(h, r: Routing, cfg: ModelConfig):
    """`dispatch` as indexing, ``buf[row[j]] = h[tok[j]]``: its plain
    version, which autograd differentiates with an accumulating scatter
    into ``h``'s gradient (``index_put_(accumulate=True)``)."""
    return _fill(h, *_flat_dispatch(r, cfg))


class _Dispatch(torch.autograd.Function):
    """`dispatch` under autograd.  Backward: token t's gradient is the sum
    of its K rows' gradients in ascending sorted position, from zero, in
    the gradient's dtype, as the JAX package's scatter-add (the transpose
    of its gather ``xt_g[tok]``) applies them: in bfloat16 each add
    rounds.  A dropped assignment reads the trash row, whose gradient is
    zero (the experts read the rows before it), as JAX slices its trash
    row away.  K gathers and adds: no atomics."""

    @staticmethod
    def forward(ctx, h, row, src, rows, rows_tok):
        ctx.save_for_backward(rows_tok)
        ctx.h_shape = h.shape
        return _fill(h, row, src, rows)

    @staticmethod
    def backward(ctx, g):
        rows_tok, = ctx.saved_tensors
        gh = g.new_zeros((*rows_tok.shape[:2], g.shape[-1]))
        for j in range(rows_tok.shape[-1]):
            gh += g[rows_tok[..., j]]
        return gh.reshape(ctx.h_shape), None, None, None, None


def experts(params, buf, out=None):
    """The routed experts on the expert-major buffer ``buf (E, R, D)``:
    per expert SwiGLU, each product rounded to the operands' dtype and
    silu as ``jax.nn.silu`` rounds.  With ``out (E, R, D)`` (serving, no
    gradient) the last product writes into it in place, so that the
    combine gathers from the GEMM's own output; without, the products
    make new tensors and autograd differentiates them (silu through its
    backward, `layers.silu_bwd`).  Returns the output."""
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    return torch.bmm(layers.silu(g, u), params["w_down"], out=out)


def combine(eo, r: Routing, tg: int):
    """Each token's K expert outputs (rows of ``eo (rows, D)``, its last
    row zero) times their gates, summed in float32 from zero in ascending
    sorted position, as the JAX package's scatter-add applies them.
    Returns (G, Tg, D) float32.  Under autograd `_Combine`."""
    if layers._grad_wanted(eo, r.w):
        pos, rows = _token_tables(r, tg)
        return _Combine.apply(eo, r.w, pos, _inverse(pos), rows)
    return combine_plain(eo, r, tg)


def combine_plain(eo, r: Routing, tg: int):
    """`combine` as indexing: its plain version, which autograd
    differentiates with accumulating scatters (``index_put_(accumulate=
    True)`` into eo's gradient, ``scatter_add_`` into the weights')."""
    pos, rows = _token_tables(r, tg)
    return _weighted_sum(eo, r.w.gather(-1, pos).reshape(rows.shape), rows)


def _weighted_sum(eo, w, rows):
    """``sum_j eo[rows[..., j]] * w[..., j]`` in float32 from zero, j
    ascending (``rows``, ``w`` (G, Tg, K))."""
    out = torch.zeros((*rows.shape[:2], eo.shape[-1]), dtype=torch.float32,
                      device=eo.device)
    for j in range(rows.shape[-1]):
        out += eo[rows[..., j]].float() * w[..., j, None]
    return out


class _Combine(torch.autograd.Function):
    """`combine` under autograd, from the sorted gate weights ``w (G,
    Tg*K)``, the token-major tables of `_token_tables` and ``pos``'s
    inverse.  Backward, for the float32 output gradient ``go``: each kept
    row's gradient is ``go[tok] * w`` rounded to eo's dtype, written once
    (the kept rows are unique; the trash row's gradient is dropped, as
    the JAX package slices the trash row away); each weight's gradient is
    the float32 row dot product ``<go[tok], eo[row]>``, handed back in
    sorted order through the inverse of ``pos``.  No atomics."""

    @staticmethod
    def forward(ctx, eo, w, pos, pos_inv, rows):
        wk = w.gather(-1, pos).reshape(rows.shape)
        ctx.save_for_backward(eo, wk, rows, pos_inv)
        return _weighted_sum(eo, wk, rows)

    @staticmethod
    def backward(ctx, go):
        eo, wk, rows, pos_inv = ctx.saved_tensors
        geo = torch.zeros_like(eo)
        gw = torch.empty_like(wk)
        for j in range(rows.shape[-1]):
            geo[rows[..., j]] = (go * wk[..., j, None]).to(eo.dtype)
            gw[..., j] = (go * eo[rows[..., j]].float()).sum(-1)
        geo[-1] = 0
        return (geo, gw.reshape(pos_inv.shape).gather(-1, pos_inv), None,
                None, None)


def apply(params, x, h, cfg: ModelConfig, groups: int = 1,
          token_mask=None):
    """The residual-added MoE FFN: x (B, S, D) the residual, h (B, S, D)
    its normed input (``params["norm"]``, applied by the block) ->
    (B, S, D)."""
    moe = cfg.moe
    b, s, d = x.shape
    e = moe.num_experts
    r = route(h, params["router"], cfg, groups, token_mask)
    g_n, cap = r.order.shape[0], r.cap
    rows = e * g_n * cap
    buf = dispatch(h, r, cfg)
    ebuf = buf[:rows].view(e, g_n * cap, d)
    if layers._grad_wanted(buf, params["w_gate"], params["w_up"],
                           params["w_down"]):
        eo = torch.cat([experts(params, ebuf).reshape(rows, d),
                        x.new_zeros((1, d))])
    else:
        eo = x.new_zeros((rows + 1, d))
        experts(params, ebuf, eo[:rows].view(e, g_n * cap, d))
    out = combine(eo, r, b * s // g_n).reshape(b, s, d).to(x.dtype)
    if moe.n_shared:
        out = out + swiglu(h, params["ws_gate"], params["ws_up"],
                           params["ws_down"])
    return x + out


def aux_load_balance_loss(params, x, cfg: ModelConfig):
    """The Switch-style load-balance auxiliary of one MoE layer's input
    ``x (B, S, D)`` (its norm applied here), in float32: ``E * sum_e
    frac_e * imp_e``, ``frac`` the share of tokens whose top expert is e
    (ties to the lower id), ``imp`` the mean router probability.  The
    mean over layers is the caller's; the JAX package's training loss
    does not add it, and neither does `transformer.loss_fn`."""
    e = cfg.moe.num_experts
    h = rms_norm(x, params["norm"], cfg.norm_eps)
    probs = torch.softmax(h.float() @ params["router"].float(), dim=-1)
    top1 = probs.argmax(-1)
    frac = torch.nn.functional.one_hot(top1, e).float().mean((0, 1))
    return e * torch.sum(frac * probs.mean((0, 1)))
