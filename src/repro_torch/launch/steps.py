"""The train, prefill and decode steps of the launch CLIs.

Each closes over a `ModelConfig` and resolves it through
`models.factory.build`:

    train_step(params, opt_state, batch) -> (params, opt_state, metrics)
    prefill(params, inputs)              -> (last_logits (B,V), cache)
    decode_step(params, cache, tokens)   -> (logits (B,V), cache)

`n_active_params` counts the parameters a token touches and `model_flops`
the useful FLOPs of a step.

PyTorch runs eagerly, so these are plain closures where the JAX package
hands them to ``jax.jit``.

The train step runs every layout: ``dense``, ``ssm``, ``hybrid`` and
``moe``.  Its gradients come from autograd through the hand-written
kernels' own backwards (attention's, the SSD scan's and silu's:
`kernels.attention.kernel.flash_attention_bwd`,
`kernels.ssd.kernel.ssd_scan_bwd`, `layers.silu_bwd`) and, in a MoE
layer, through the dispatch's and combine's own backwards, which gather
and use no atomics (`models.moe`).
Microbatches add into an accumulator (float32 by default) in the JAX
package's order, ``(0 + g0) + g1``, then divide by their count; each
leaf's gradient is folded in the moment autograd produces it (a post-
accumulate-grad hook), and the loss runs on per-layer leaves (views of
each stacked parameter's layers, a MoE segment's ``(L, E, D, F)``
experts down to each layer's ``(E, D, F)``; a zsuper segment's Mamba2
leaves down to each inner block), so that no whole-model gradient of the parameters'
dtype ever exists: at qwen3-4b's width that is 8.2 GiB beside
the 16.4 GiB accumulator.  The optimizer then updates the stacked
parameters in place (`optim.optimizers`), and the views see it.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.checkpoint.manager import flatten, unflatten
from repro_torch.models import factory
from repro_torch.models.config import ModelConfig, torch_dtype

TRAIN_LAYOUTS = ("dense", "ssm", "hybrid", "moe")


def make_loss_fn(cfg: ModelConfig):
    model = factory.build(cfg)

    def loss(params, batch):
        return model.loss_fn(params, batch)
    return loss


def _layer_leaves(params):
    """The tree the loss differentiates: each segment's stacked leaf
    replaced by the list of its layers (views; a zsuper segment's Mamba2
    leaves, stacked over super-block and inner block, by a list of lists),
    every leaf a fresh view that requires grad; returns (tree, [(leaf,
    slot)]) where ``slot = (i, j)`` names the stacked leaf ``i`` and the
    index ``j`` (None, a layer, or a (super-block, inner block) pair) of
    the leaf's gradient in it.  A leaf read more than once (the hybrid's
    shared attention and MLP, once a super-block) gets one summed
    gradient a backward."""
    paths, leaves = flatten(params)
    out, slots = [], []
    for i, (path, leaf) in enumerate(zip(paths, leaves)):
        base = leaf.detach()
        if not path.startswith("['segments']"):
            slots.append((base.requires_grad_(), (i, None)))
            out.append(base)
            continue
        layers = []
        for j in range(base.shape[0]):
            if "['ssm']" in path:            # a zsuper's inner blocks
                inner = [base[j, k].requires_grad_()
                         for k in range(base.shape[1])]
                slots += [(t, (i, (j, k))) for k, t in enumerate(inner)]
                layers.append(inner)
            else:
                layers.append(base[j].requires_grad_())
                slots.append((layers[-1], (i, j)))
        out.append(layers)
    return unflatten(params, out), slots


def make_train_step(cfg: ModelConfig, opt, *, microbatches: int = 1,
                    accum_dtype: str = "float32") -> Callable:
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss"})``;
    ``params`` and ``opt_state`` are updated in place and handed back.
    With ``microbatches`` > 1 the batch's rows split into that many equal
    microbatches, whose gradients add in ``accum_dtype``; with one the
    gradients stay in the parameters' dtype, as the JAX package keeps
    them."""
    if cfg.layout not in TRAIN_LAYOUTS:
        raise ValueError(f"unknown layout {cfg.layout!r}: the port trains "
                         f"{TRAIN_LAYOUTS}")
    loss_fn = make_loss_fn(cfg)
    adt = torch_dtype(accum_dtype)

    def step(params, opt_state, batch):
        tree, slots = _layer_leaves(params)
        leaves = flatten(params)[1]
        b = batch["labels"].shape[0]
        mb = max(microbatches, 1)
        if b % mb:
            raise ValueError(f"batch of {b} rows does not split into "
                             f"{mb} microbatches")
        acc = [torch.zeros(p.shape, dtype=adt if mb > 1 else p.dtype,
                           device=p.device) for p in leaves]

        def fold(leaf, slot):
            i, j = slot
            dst = acc[i] if j is None else acc[i][j]

            def hook(t):
                if mb > 1:
                    dst.add_(t.grad)
                else:
                    dst.copy_(t.grad)
                t.grad = None
            leaf.register_post_accumulate_grad_hook(hook)

        for leaf, slot in slots:
            fold(leaf, slot)
        loss = None
        for k in range(mb):
            part = {key: x[k * (b // mb):(k + 1) * (b // mb)]
                    for key, x in batch.items()}
            l_k = loss_fn(tree, part)
            l_k.backward()
            l_k = l_k.detach()
            loss = l_k if loss is None else loss + l_k
        if mb > 1:                   # the float32 mean, as JAX takes it
            acc = [a.div_(mb) if a.dtype == torch.float32
                   else a.float().div_(mb) for a in acc]
            loss = loss / mb
        del tree, slots
        params, opt_state = opt.update(unflatten(params, acc), opt_state,
                                       params)
        return params, opt_state, {"loss": loss}

    return step


def make_prefill(cfg: ModelConfig, max_len: int):
    model = factory.build(cfg)

    def prefill(params, inputs):
        return model.prefill(params, inputs, max_len)
    return prefill


def make_decode_step(cfg: ModelConfig):
    model = factory.build(cfg)

    def decode(params, cache, tokens):
        return model.decode_step(params, cache, tokens)
    return decode


def n_active_params(cfg: ModelConfig) -> int:
    """Parameters touched per token: all of them for a dense model, the
    top-k of the routed experts for MoE; the input embedding gather (not
    a matmul) excluded, as the JAX package counts them."""
    total = factory.build(cfg).n_params()
    embed = cfg.vocab * cfg.d_model
    if cfg.moe is None:
        return total - embed
    m = cfg.moe
    expert_params = 3 * cfg.d_model * m.d_expert      # gate/up/down per expert
    n_moe_layers = cfg.n_layers - m.first_dense
    inactive = n_moe_layers * (m.num_experts - m.top_k) * expert_params
    return total - embed - inactive


def model_flops(cfg: ModelConfig, kind: str, global_batch: int,
                seq_len: int) -> float:
    """Useful FLOPs per step: 6 N D to train (forward and backward),
    2 N D to prefill, 2 N_active B to decode one token per stream."""
    n_act = n_active_params(cfg)
    if kind == "train":
        return 6.0 * n_act * global_batch * seq_len
    if kind == "prefill":
        return 2.0 * n_act * global_batch * seq_len
    if kind == "decode":
        return 2.0 * n_act * global_batch
    raise ValueError(kind)
