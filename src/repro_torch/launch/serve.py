"""Batched serving: prefill + lockstep greedy decode with a KV cache
(``--arch qwen3-4b``), an SSD state and conv window per layer
(``--arch mamba2-1.3b``) or both (``--arch zamba2-7b``: a KV cache per
super-block's shared attention block, an SSD state and conv window per
Mamba2 block), optionally with the FireFly-P plastic adapter (one online
plasticity step per generated token).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --smoke --batch 4 --prompt-len 32 --gen 16 --plastic --device cpu

On a CUDA device every prefill attention launches the flash-attention
kernel, every prefill SSM block the SSD-scan kernel, every MLP and SSM
block of every step the silu kernel, and every decode step with
``--plastic`` the fleet-step kernel (``--adapter-quant``: its fixed-point
twin); on the CPU the same code runs the kernels' plain
versions.  Weights are random, drawn from
``--seed``.  Prints one JSON object with the decode latencies, the
throughput and the kernel launches of the run.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.snn import resolve_device
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.kernels.plasticity.kernel import fleet_step, fleet_step_q
from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.launch.steps import make_decode_step, make_prefill
from repro_torch.models import factory
from repro_torch.models.layers import silu

COUNTERS = (flash_attention, ssd_scan, silu, fleet_step, fleet_step_q)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts, max_len: int, gen: int,
             temperature: float = 0.0, generator=None):
    """Prefill ``prompts (B, S)`` then sample ``gen`` tokens, greedily at
    ``temperature <= 0`` (else from ``generator``).

    Returns (tokens (B, gen), per-step decode latencies in seconds, the
    final cache, the prefill latency in seconds).  Each latency is a host
    clock around work that ends in a device synchronise.
    """
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = prefill(params, prompts)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    outs, lats = [], []
    tok = _sample(logits, temperature, generator)
    for _ in range(gen):
        outs.append(tok)
        t0 = time.perf_counter()
        logits, cache = decode(params, cache, tok[:, None])
        _sync(dev)
        lats.append(time.perf_counter() - t0)
        tok = _sample(logits, temperature, generator)
    return torch.stack(outs, dim=1), lats, cache, prefill_s


def _sample(logits, temperature, generator):
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--plastic", action="store_true",
                    help="attach the FireFly-P plastic adapter at decode")
    ap.add_argument("--adapter-quant", action="store_true",
                    help="with --plastic: fixed-point adapter (int8 W_fast, "
                         "per-stream scales, int32 membranes/traces)")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.adapter_quant and not args.plastic:
        ap.error("--adapter-quant quantizes the plastic adapter; pass "
                 "--plastic too")

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.plastic:
        cfg = cfg.with_(plastic_adapter=True,
                        adapter_neurons=min(128, cfg.d_model),
                        adapter_quant=args.adapter_quant)
    model = factory.build(cfg)
    max_len = args.prompt_len + args.gen
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    for c in COUNTERS:
        c.launches = 0
    toks, lats, _, prefill_s = generate(cfg, params, prompts, max_len,
                                        args.gen, args.temperature, gen)
    out = {
        "arch": cfg.name, "plastic": bool(cfg.plastic_adapter),
        "adapter_quant": bool(cfg.adapter_quant), "device": str(dev),
        "batch": args.batch, "prompt_len": args.prompt_len,
        "generated": int(toks.shape[1]),
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_p50": sorted(lats)[len(lats) // 2] * 1e3,
        "decode_ms_mean": sum(lats) / len(lats) * 1e3,
        "tokens_per_s": args.batch * len(lats) / sum(lats),
        "launches": {c.__name__: c.launches for c in COUNTERS},
    }
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
