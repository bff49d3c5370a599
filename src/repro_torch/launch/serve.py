"""Batched serving: prefill + lockstep greedy decode with a KV cache
(``--arch qwen3-4b``; ``--arch deepseek-moe-16b``, and ``--arch
grok-1-314b --smoke``, whose FFNs are routed experts), an SSD state and
conv window per layer (``--arch mamba2-1.3b``) or both (``--arch
zamba2-7b``: a KV cache per super-block's shared attention block, an SSD
state and conv window per Mamba2 block), optionally with the FireFly-P
plastic adapter (one online plasticity step per generated token).  Every
arch of `configs.ARCHS` serves; ``--kv-quant`` keeps the KV cache as int8
codes with a float32 scale per position and head.  The ``embeddings``
archs (musicgen-medium, pixtral-12b) take their prompt through the JAX
package's stub frontend, ``one_hot(prompt % d_model, d_model)``; their
decode feeds tokens through the embedding table.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --smoke --batch 4 --prompt-len 32 --gen 16 --plastic --device cpu

On a CUDA device every prefill attention launches the flash-attention
kernel, every prefill SSM block the SSD-scan kernel, every MLP, MoE FFN
(its routed experts, and its shared experts if any) and SSM block of
every step the silu kernel, and every decode step with
``--plastic`` the fleet-step kernel (``--adapter-quant``: its fixed-point
twin); on the CPU the same code runs the kernels' plain
versions.  Weights are random, drawn from
``--seed``.  Prints one JSON object with the decode latencies, the
throughput, the parameter counts (all, and those a token touches) and the
kernel launches of the run.

With ``--session-dir`` the adapter's per-stream fast weights become
SESSIONS: each batch row is a named user (``--users``) admitted into a
`serving.AdapterPool` before decode and evicted (persisted) after, so a
second run with the same directory resumes every user's plastic memory bit
for bit.  ``--flight-dir`` runs the adapter flight recorder over the decode
loop (one recorder launch a step on the card) and writes one incident
bundle per flagged stream and a ``flight_summary.json``;
``--metrics-json`` / ``--metrics-interval`` / ``--metrics-port`` export the
metrics registry.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, get_smoke
from repro_torch.core.snn import resolve_device
from repro_torch.kernels.attention.kernel import flash_attention
from repro_torch.kernels.plasticity.fused import rollout
from repro_torch.kernels.plasticity.kernel import fleet_step, fleet_step_q
from repro_torch.kernels.ssd.kernel import ssd_scan
from repro_torch.launch.steps import (make_decode_step, make_prefill,
                                     n_active_params)
from repro_torch.models import factory, plastic
from repro_torch.models.layers import silu
from repro_torch.obs import (AdapterFlightRecorder, HealthConfig,
                             MetricsRegistry, phase, serve_metrics)
from repro_torch.obs import recorder as _recorder
from repro_torch.obs import watchdog
from repro_torch.serving import AdapterPool, SessionStore

COUNTERS = (flash_attention, ssd_scan, silu, fleet_step, fleet_step_q,
            rollout)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(cfg, params, prompts, max_len: int, gen: int,
             temperature: float = 0.0, generator=None, adapters=None,
             registry=None, watch=None, metrics_json=None,
             metrics_interval: int = 0, flight=None):
    """Prefill ``prompts (B, S)`` then sample ``gen`` tokens, greedily at
    ``temperature <= 0`` (else from ``generator``).

    Returns (tokens (B, gen), per-step decode latencies in seconds, the
    final cache, the prefill latency in seconds).  Each latency is a host
    clock around work that ends in a device synchronise.

    `adapters`: optional `serving.AdapterPool` whose admitted users are the
    batch rows (user b in slot b).  Its pool tree replaces the fresh
    prefill cache's adapter entry, so each stream resumes its user's
    learned fast weights; after the loop the learned rows go back into the
    pool (the caller evicts to persist).

    `registry`: optional `obs.MetricsRegistry`: per-step decode latencies
    into ``serve_decode_seconds`` and throughput into
    ``serve_tokens_per_s``.  `watch`: optional `RecompileWatchdog`, armed
    from loop iteration 1 on (iteration 0 loads the decode's kernel
    libraries).  `metrics_json` with ``metrics_interval > 0``: a registry
    snapshot every `metrics_interval` decode steps.

    `flight`: optional `obs.AdapterFlightRecorder` (needs the plastic
    adapter): each decode step's adapter cache before and after feeds its
    ring and detectors.  The adapter step writes new tensors, so the
    cache's previous adapter entry is the "before" state as it stands.
    """
    prefill = make_prefill(cfg, max_len)
    decode = make_decode_step(cfg)
    dev = prompts.device
    m_decode = (registry.histogram("serve_decode_seconds",
                                   "per-token decode step latency")
                if registry is not None else None)
    _sync(dev)
    t0 = time.perf_counter()
    with phase("serve.prefill"):
        logits, cache = prefill(params, prompts)
    _sync(dev)
    prefill_s = time.perf_counter() - t0
    if adapters is not None:
        # the pool IS the adapter state: one admitted row per batch stream
        cache["adapter"] = adapters.pool
    if flight is not None and "adapter" not in cache:
        raise ValueError("flight recording needs a plastic adapter in the "
                         "cache (cfg.plastic_adapter=True)")
    outs, lats = [], []
    tok = _sample(logits, temperature, generator)
    armed = False
    try:
        for i in range(gen):
            if i == 1 and watch is not None:
                watch.arm()
                armed = True
            outs.append(tok)
            before = cache.get("adapter")
            t0 = time.perf_counter()
            with phase("serve.decode_step"):
                logits, cache = decode(params, cache, tok[:, None])
                _sync(dev)
            dt = time.perf_counter() - t0
            lats.append(dt)
            if flight is not None:
                flight.observe(before, cache["adapter"])
            if m_decode is not None:
                m_decode.observe(dt)
            tok = _sample(logits, temperature, generator)
            if (metrics_json and metrics_interval > 0 and registry is not None
                    and (i + 1) % metrics_interval == 0):
                registry.to_json(metrics_json)
    finally:
        if armed:
            watch.disarm()
    if registry is not None and lats:
        registry.gauge("serve_tokens_per_s",
                       "steady-state decode throughput (whole batch)"
                       ).set(prompts.shape[0] * len(lats) / sum(lats))
    if adapters is not None:
        # hand the learned rows back to the pool
        adapters.pool = cache["adapter"]
        adapters.advance_steps(gen)
    return torch.stack(outs, dim=1), lats, cache, prefill_s


def _sample(logits, temperature, generator):
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.float() / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def embed_stub(tokens, cfg):
    """The JAX package's stub frontend of an ``input_mode="embeddings"``
    arch: tokens (B, S) -> one-hot frame embeddings (B, S, d_model) in
    ``cfg.adtype``."""
    return torch.nn.functional.one_hot(
        tokens.long() % cfg.d_model, cfg.d_model).to(cfg.adtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--plastic", action="store_true",
                    help="attach the FireFly-P plastic adapter at decode")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache: int8 codes and one float32 scale "
                         "per position and KV head")
    ap.add_argument("--adapter-quant", action="store_true",
                    help="with --plastic: fixed-point adapter (int8 W_fast, "
                         "per-stream scales, int32 membranes/traces)")
    ap.add_argument("--session-dir", default=None,
                    help="with --plastic: durable per-user session store "
                         "for the adapter fast weights; each batch row is a "
                         "user whose learned W_fast persists across runs")
    ap.add_argument("--users", default=None,
                    help="comma-separated user ids for the batch rows "
                         "(default user0..user{B-1}); needs --session-dir")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--metrics-json", default=None,
                    help="write a metrics-registry JSON snapshot here "
                         "(final, plus periodic with --metrics-interval)")
    ap.add_argument("--metrics-interval", type=int, default=0,
                    help="with --metrics-json: also dump every N decode "
                         "steps (0 = final snapshot only)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="serve the metrics registry over HTTP on this "
                         "port for the run's duration (/metrics Prometheus "
                         "text, /metrics.json snapshot; 0 = ephemeral)")
    ap.add_argument("--flight-dir", default=None,
                    help="with --plastic: run the adapter flight recorder "
                         "over the decode loop and write one incident "
                         "bundle (JSON + NPZ ring dump) per flagged "
                         "stream into this directory")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if (args.session_dir or args.users) and not args.plastic:
        ap.error("--session-dir/--users require --plastic (sessions are "
                 "the adapter's fast-weight state)")
    if args.users and not args.session_dir:
        ap.error("--users names the rows of a durable session store; "
                 "pass --session-dir too")
    if args.adapter_quant and not args.plastic:
        ap.error("--adapter-quant quantizes the plastic adapter; pass "
                 "--plastic too")
    if args.flight_dir and not args.plastic:
        ap.error("--flight-dir records the plastic adapter's health "
                 "channels; pass --plastic too")

    dev = resolve_device(args.device)
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    if args.plastic:
        cfg = cfg.with_(plastic_adapter=True,
                        adapter_neurons=min(128, cfg.d_model),
                        adapter_quant=args.adapter_quant)
    if args.kv_quant:
        cfg = cfg.with_(kv_quant=True)
    model = factory.build(cfg)
    max_len = args.prompt_len + args.gen
    gen = torch.Generator(dev).manual_seed(args.seed)
    params = model.init(gen)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev)
    if cfg.input_mode == "embeddings":
        prompts = embed_stub(prompts, cfg)

    registry = MetricsRegistry()
    watch = watchdog.install(registry)
    watch.reset()
    metrics_server = None
    if args.metrics_port is not None:
        metrics_server = serve_metrics(registry, port=args.metrics_port)
    flight = None
    counters = COUNTERS
    if args.flight_dir is not None:
        flight = AdapterFlightRecorder(
            HealthConfig(), slots=args.batch,
            qcfg=plastic.QUANT if args.adapter_quant else None, device=dev)
        counters += (_recorder.record_step,)
    store = users = pool = None
    if args.session_dir is not None:
        store = SessionStore(root=args.session_dir, capacity=args.batch,
                             registry=registry)
        users = (args.users.split(",") if args.users
                 else [f"user{b}" for b in range(args.batch)])
        if len(users) != args.batch:
            raise SystemExit(f"--users needs exactly {args.batch} ids, "
                             f"got {len(users)}")
        if len(set(users)) != len(users):
            raise SystemExit(
                "--users ids must be unique: two rows sharing a session "
                "would silently overwrite each other's learned state")
        # user b lands in pool slot b (admission fills free slots in
        # order), restoring persisted fast weights through the store's
        # validated checkout
        pool = AdapterPool(cfg, slots=args.batch, store=store,
                           registry=registry, device=dev)
        for u in users:
            pool.admit(u)

    for c in counters:
        c.launches = 0
    try:
        toks, lats, _, prefill_s = generate(
            cfg, params, prompts, max_len, args.gen, args.temperature, gen,
            adapters=pool, registry=registry, watch=watch,
            metrics_json=args.metrics_json,
            metrics_interval=args.metrics_interval, flight=flight)
        launches = {c.__name__: c.launches for c in counters}
        tokens_learned = None
        if pool is not None:
            tokens_learned = [int(pool._steps[pool.user_slot[u]])
                              for u in users]
            for u in users:         # evict = slot copy + write-through
                pool.evict(u)
        out = {
            "arch": cfg.name, "plastic": bool(cfg.plastic_adapter),
            "adapter_quant": bool(cfg.adapter_quant), "device": str(dev),
            "n_params": model.n_params(),
            "n_active_params": n_active_params(cfg),
            "batch": args.batch, "prompt_len": args.prompt_len,
            "generated": int(toks.shape[1]),
            "prefill_ms": prefill_s * 1e3,
            "decode_ms_p50": sorted(lats)[len(lats) // 2] * 1e3,
            "decode_ms_mean": sum(lats) / len(lats) * 1e3,
            "tokens_per_s": args.batch * len(lats) / sum(lats),
            "recompiles_after_warmup": watch.violations,
            "launches": launches,
        }
        if watch.violations:
            out["recompile_signatures"] = watch.violation_signatures
        if store is not None:
            out["sessions"] = {
                "users": users, "resumed": store.restores,
                "created": store.creates, "tokens_learned": tokens_learned}
        if flight is not None:
            uid_by_slot = dict(enumerate(users)) if users else None
            incidents = flight.dump(args.flight_dir, uid_by_slot=uid_by_slot,
                                    registry=registry, watchdog=watch)
            out["flight"] = {
                "dir": args.flight_dir, "steps_recorded": flight.pos,
                "flagged_slots": flight.flagged_slots(),
                "incidents": incidents}
        if args.metrics_json:
            registry.to_json(args.metrics_json)
            out["metrics_json"] = args.metrics_json
        if metrics_server is not None:
            out["metrics_port"] = metrics_server.server_address[1]
    finally:
        if metrics_server is not None:
            metrics_server.shutdown()
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
