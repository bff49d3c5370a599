"""End-to-end training CLI of the port: the ``dense``, ``ssm``, ``hybrid``
and ``moe`` layouts on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \
        --smoke --steps 50 --ckpt RUN_DIR [--device cpu]

Wires together: config registry -> random init (from ``--seed``) ->
deterministic token pipeline -> AdamW train step (warmup-cosine, the
arch's `launch.specs.TRAIN_SETUP`: microbatches, accumulator and moment
dtypes, remat per block) -> `distributed.FaultTolerantRunner`
(checkpoint/restart, NaN rollback, straggler log).  A second run with the
same ``--ckpt`` resumes from its latest checkpoint.

On a CUDA device every attention block launches the flash-attention
kernel forward (twice a step per microbatch with remat: the forward and
its recompute) and its backward kernel, every MLP the silu kernel and
its backward kernel (a MoE layer's routed experts and its shared experts
one each), every Mamba2 block the SSD scan kernel (#8) and its
backward kernel and silu and its backward twice (the conv's activation
and the output gate), and AdamW its kernel once a parameter leaf; on the
CPU the same code runs their plain versions.  The ``embeddings`` archs take their tokens through the JAX
package's stub frontend, ``one_hot(tokens % d_model, d_model)``.  One
card: ``--data-par`` and ``--model-par`` above 1 raise.  Prints one JSON
object with the first and last loss, the wall time, the rollbacks, the
stragglers and the kernel launches of the run.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke
from repro_torch.core.snn import resolve_device
from repro_torch.data import TokenPipelineConfig, batch_at_step
from repro_torch.distributed import FaultTolerantRunner
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.launch.serve import embed_stub
from repro_torch.launch.specs import apply_setup, train_setup
from repro_torch.launch.steps import make_train_step
from repro_torch.models import factory
from repro_torch.models.layers import silu
from repro_torch.optim import adamw, warmup_cosine
from repro_torch.optim.optimizers import adamw_leaf


def build(arch: str, smoke: bool, global_batch: int, seq_len: int,
          lr: float, total_steps: int, data_par: int = 1,
          model_par: int = 1):
    """(cfg, opt, step_fn) of ``arch``'s training run, as the JAX package's
    ``build`` makes them (there is no mesh: one card)."""
    if data_par > 1 or model_par > 1:
        raise NotImplementedError(
            f"the port trains on one card; --data-par {data_par} / "
            f"--model-par {model_par} wait for ROADMAP Queue 1 item 8 "
            f"(distributed/)")
    cfg = get_smoke(arch) if smoke else get_config(arch)
    setup = train_setup(arch) if not smoke else {}
    cfg = apply_setup(cfg, setup)
    opt = adamw(lr=warmup_cosine(lr, max(total_steps // 20, 1), total_steps),
                moment_dtype=setup.get("moment_dtype", "float32"))
    step_fn = make_train_step(
        cfg, opt, microbatches=setup.get("microbatches", 1),
        accum_dtype=setup.get("accum_dtype", "float32"))
    return cfg, opt, step_fn


def _launches() -> dict:
    return {"flash_attention": flash_attention.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "ssd_scan": ssd_scan.launches,
            "ssd_scan_bwd": ssd_scan.bwd_launches,
            "silu": silu.launches, "silu_bwd": silu.bwd_launches,
            "adamw": adamw_leaf.launches}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", required=True,
                    help="checkpoint directory; a run resumes from it")
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--data-par", type=int, default=1)
    ap.add_argument("--model-par", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels) or cpu (their plain versions)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, opt, step_fn = build(
        args.arch, args.smoke, args.global_batch, args.seq_len, args.lr,
        args.steps, args.data_par, args.model_par)
    model = factory.build(cfg)
    print(f"arch={cfg.name} params={model.n_params() / 1e6:.1f}M "
          f"device={dev}")

    pipe = TokenPipelineConfig(vocab=cfg.vocab, seq_len=args.seq_len,
                               global_batch=args.global_batch,
                               seed=args.seed)
    params = model.init(torch.Generator(dev).manual_seed(args.seed))
    opt_state = opt.init(params)

    def batches(step):
        batch = batch_at_step(pipe, step, device=dev)
        if cfg.input_mode == "embeddings":
            batch = {"inputs": embed_stub(batch["inputs"], cfg),
                     "labels": batch["labels"]}
        return batch

    def wrapped(state, batch):
        p, o, metrics = step_fn(state["params"], state["opt"], batch)
        return {"params": p, "opt": o}, metrics

    ckpt = CheckpointManager(args.ckpt, keep=3)
    runner = FaultTolerantRunner(wrapped, ckpt, save_every=args.save_every)
    state = {"params": params, "opt": opt_state}
    state, start = runner.restore_or_init(state)

    before = _launches()
    t0 = time.time()
    state, history = runner.run(state, batches, args.steps,
                                start_step=start, log_every=args.log_every)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0

    losses = [h["loss"] for h in history]
    print(json.dumps({
        "arch": cfg.name, "device": str(dev), "start_step": start,
        "steps": len(history),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "wall_s": dt,
        "rollbacks": runner.rollbacks,
        "stragglers": runner.monitor.flagged,
        "launches": {k: v - before[k] for k, v in _launches().items()},
    }, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
