"""Procedural token pipeline: deterministic, restartable, shard-aware.

The batch for step N is a pure function of (seed, step, shard): any host
rebuilds any step, so a restart needs no data-loader state beyond the step
counter, and a host draws only its own shard (`host_batch`).

The process is the JAX package's: a topic, drawn per block of
``topic_block`` tokens, picks one of ``n_topics`` unigram tables (a
Zipf law over the vocab, permuted per topic), and a copy channel repeats
the previous token with probability ``p_copy``.  The draws come from a
`torch.Generator` on the caller's device seeded from (seed, step, shard),
so they are not the JAX package's bits; the distribution is.

Per topic the table is a permutation of one Zipf law, so a token is drawn
as a Zipf RANK (one inverse-CDF draw for every position, whatever its
topic) and mapped through its topic's permutation: the (rows, S + 1,
vocab) table of logits that the JAX package indexes (5 GB at qwen3-4b's
vocab and 2 x 4097 tokens) never exists.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.snn import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_topics: int = 16
    zipf_a: float = 1.1
    p_copy: float = 0.25
    topic_block: int = 64          # tokens per topic segment


_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def _seed(*words: int) -> int:
    """A 63-bit generator seed mixed from integers (splitmix64 steps)."""
    h = 0
    for w in words:
        h = (h + _MIX + (w & ((1 << 64) - 1))) & ((1 << 64) - 1)
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & ((1 << 64) - 1)
        h ^= h >> 31
    return h & _MASK


def _rank_to_token(cfg: TokenPipelineConfig, device) -> torch.Tensor:
    """(n_topics, vocab): topic t's token of Zipf rank r (0 the most
    likely), a fixed seeded permutation per topic."""
    gen = torch.Generator(device)
    out = torch.empty((cfg.n_topics, cfg.vocab), dtype=torch.long,
                      device=device)
    for t in range(cfg.n_topics):
        gen.manual_seed(_seed(cfg.seed ^ 0x5EED, t))
        out[t] = torch.randperm(cfg.vocab, generator=gen, device=device)
    return out


def _zipf_cdf(cfg: TokenPipelineConfig, device) -> torch.Tensor:
    """The cumulative Zipf law over ranks, p(r) ~ (r + 1)^-a, float64."""
    r = torch.arange(1, cfg.vocab + 1, dtype=torch.float64, device=device)
    w = r.pow(-cfg.zipf_a)
    cdf = torch.cumsum(w, 0)
    return cdf / cdf[-1]


def draw(cfg: TokenPipelineConfig, step: int, shard=(0, 1), device=None):
    """The raw draws of step ``step``'s shard: ``(tokens, topics, copy)``,
    each (rows, S + 1): the token each position draws, its topic and
    whether the copy channel fires there (the first position never
    copies)."""
    i, n = shard
    rows = cfg.global_batch // n
    dev = resolve_device(device)
    gen = torch.Generator(dev)
    gen.manual_seed(_seed(cfg.seed, step, i))
    s_plus = cfg.seq_len + 1
    n_blocks = -(-s_plus // cfg.topic_block)
    topics = torch.randint(0, cfg.n_topics, (rows, n_blocks), generator=gen,
                           device=dev)
    topics = topics.repeat_interleave(cfg.topic_block, dim=1)[:, :s_plus]
    u = torch.rand((rows, s_plus), generator=gen, dtype=torch.float64,
                   device=dev)
    ranks = torch.searchsorted(_zipf_cdf(cfg, dev), u, right=True)
    ranks.clamp_(max=cfg.vocab - 1)
    toks = _rank_to_token(cfg, dev)[topics, ranks]
    copy = torch.rand((rows, s_plus), generator=gen, device=dev) < cfg.p_copy
    copy[:, 0] = False
    return toks, topics, copy


def batch_at_step(cfg: TokenPipelineConfig, step: int, shard=(0, 1),
                  device=None) -> dict:
    """Tokens and labels of global step ``step``, restricted to
    ``shard = (i, n)``: ``{"inputs": (B/n, S), "labels": (B/n, S)}``, int64
    on ``device`` (None: the card), the labels the inputs shifted left
    (next-token prediction)."""
    toks, _, copy = draw(cfg, step, shard, device)
    # a copied position repeats the last position that drew its own token
    pos = torch.arange(toks.shape[1], device=toks.device)
    src = torch.where(copy, torch.zeros_like(pos), pos).cummax(dim=1).values
    seq = toks.gather(1, src)
    return {"inputs": seq[:, :-1], "labels": seq[:, 1:]}


def host_batch(cfg: TokenPipelineConfig, step: int, host_id: int,
               n_hosts: int, device=None) -> dict:
    """The slice of step ``step`` this host feeds to its devices."""
    return batch_at_step(cfg, step, shard=(host_id, n_hosts), device=device)
