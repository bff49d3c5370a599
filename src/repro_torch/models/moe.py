"""Mixture-of-Experts FFN with capacity-bounded sort-based dispatch.

Fine-grained MoE as deepseek-moe writes it (shared + routed experts,
top-k) and grok-1's (8 experts, top-2), as in the JAX package: tokens are
routed in float32, sorted by assigned expert (a stable sort), and each
expert takes a buffer of ``cap`` rows; an assignment past its expert's
capacity is dropped (its gate weight 0, its row the trash row), and the
experts' outputs come back weighted by the renormalised gates.

Three things differ from a direct transcription, none in the result:

* the buffer is laid out expert-major, ``(E, G * cap, D)`` plus one zero
  trash row, so that the expert products are one batched GEMM each and
  the combine gathers from the GEMM's own output (no copy between);
* the combine sums each token's K contributions in float32 in the order
  the JAX package's scatter-add applies them (ascending sorted position,
  i.e. ascending expert id), as K gathers and adds: no atomics, so two
  runs on the card give the same bits;
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
from repro_torch.models.layers import ParamDesc, swiglu


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
    w = torch.where(keep, gates.reshape(g_n, tg * k).gather(-1, order),
                    torch.zeros((), device=h.device))
    grp = torch.arange(g_n, device=h.device)[:, None]
    row = torch.where(keep, sorted_e * (g_n * cap) + grp * cap + pos,
                      torch.full_like(pos, e * g_n * cap))
    return Routing(expert_idx, gates, order, tok, w, keep, row, cap)


def dispatch(h, r: Routing, cfg: ModelConfig):
    """The expert-major buffer ``(E * G * cap + 1, D)`` of the normed
    tokens ``h (B, S, D)``: row ``r.row[j]`` holds assignment j's token;
    the rows no token fills are zero, the last (trash) row is never
    read."""
    g_n, n = r.order.shape
    tg = n // cfg.moe.top_k
    d = h.shape[-1]
    rows = cfg.moe.num_experts * g_n * r.cap
    buf = h.new_zeros((rows + 1, d))
    src = r.tok + torch.arange(g_n, device=h.device)[:, None] * tg
    buf[r.row.reshape(-1)] = h.reshape(g_n * tg, d)[src.reshape(-1)]
    return buf


def experts(params, buf, out):
    """The routed experts on the expert-major buffer ``buf (E, R, D)``,
    written into ``out (E, R, D)``: per expert SwiGLU, each product
    rounded to the operands' dtype and silu as ``jax.nn.silu`` rounds.
    It writes ``out`` in place and has no backward yet: under autograd it
    raises rather than hand back outputs without a gradient."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (buf, params["w_gate"], params["w_up"],
                                      params["w_down"])):
        raise NotImplementedError(
            "the routed experts have no backward yet (dispatch, combine "
            "and the in-place expert product): training the MoE layout is "
            "ROADMAP Queue 1 item 9.7 (MoE training)")
    g = torch.bmm(buf, params["w_gate"])
    u = torch.bmm(buf, params["w_up"])
    return torch.bmm(layers.silu(g, u), params["w_down"], out=out)


def combine(eo, r: Routing, tg: int):
    """Each token's K expert outputs (rows of ``eo (rows, D)``, its last
    row zero) times their gates, summed in float32 from zero in ascending
    sorted position, as the JAX package's scatter-add applies them.
    Returns (G, Tg, D) float32."""
    g_n, n = r.order.shape
    k = n // tg
    inv = torch.empty_like(r.order).scatter_(
        -1, r.order, torch.arange(n, device=eo.device).expand(g_n, n))
    pos = inv.reshape(g_n, tg, k).sort(dim=-1).values.reshape(g_n, n)
    rows = r.row.gather(-1, pos).reshape(g_n, tg, k)
    w = r.w.gather(-1, pos).reshape(g_n, tg, k)
    out = torch.zeros((g_n, tg, eo.shape[-1]), dtype=torch.float32,
                      device=eo.device)
    for j in range(k):
        out += eo[rows[..., j]].float() * w[..., j, None]
    return out


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
    eo = x.new_zeros((rows + 1, d))
    experts(params, buf[:rows].view(e, g_n * cap, d),
            eo[:rows].view(e, g_n * cap, d))
    out = combine(eo, r, b * s // g_n).reshape(b, s, d).to(x.dtype)
    if moe.n_shared:
        out = out + swiglu(h, params["ws_gate"], params["ws_up"],
                           params["ws_down"])
    return x + out
