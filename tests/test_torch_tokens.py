"""The port's token pipeline (`data.tokens`) on the CPU: shapes and the
next-token shift, a batch as a pure function of (seed, step, shard), and
its statistics against the JAX package's pipeline (jitted): the copy
channel's rate, the rate at which a token repeats its predecessor, the
topic blocks and the Zipf law's rank slope.  The two packages draw from
different generators, so the statistics, never the bits, are compared.
"""
import jax
import numpy as np
import pytest
import torch

from repro.data.tokens import TokenPipelineConfig as JCfg
from repro.data.tokens import batch_at_step as j_batch_at_step
from repro_torch.data import TokenPipelineConfig, batch_at_step, host_batch
from repro_torch.data import tokens as T

CFG = dict(vocab=4096, seq_len=511, global_batch=32, seed=3)


def _port(step=0, shard=(0, 1), **kw):
    return batch_at_step(TokenPipelineConfig(**{**CFG, **kw}), step, shard,
                         device="cpu")


def test_shapes_and_shift():
    b = _port()
    assert b["inputs"].shape == b["labels"].shape == (32, 511)
    assert b["inputs"].dtype == b["labels"].dtype == torch.int64
    assert torch.equal(b["inputs"][:, 1:], b["labels"][:, :-1])
    assert int(b["inputs"].min()) >= 0 and int(b["inputs"].max()) < 4096


def test_pure_function_of_seed_step_and_shard():
    a, b = _port(step=5), _port(step=5)
    assert torch.equal(a["inputs"], b["inputs"])
    assert not torch.equal(a["inputs"], _port(step=6)["inputs"])
    assert not torch.equal(a["inputs"], _port(step=5, seed=4)["inputs"])
    s0, s1 = _port(step=5, shard=(0, 2)), _port(step=5, shard=(1, 2))
    assert s0["inputs"].shape == (16, 511)
    assert not torch.equal(s0["inputs"], s1["inputs"])
    h = host_batch(TokenPipelineConfig(**CFG), 5, 1, 2, device="cpu")
    assert torch.equal(h["inputs"], s1["inputs"])


def _repeat_rate(seq):
    seq = np.asarray(seq)
    return float((seq[:, 1:] == seq[:, :-1]).mean())


def _jax(step):
    cfg = JCfg(**CFG)
    out = jax.jit(lambda s: j_batch_at_step(cfg, s))(step)
    return np.concatenate([np.asarray(out["inputs"]),
                           np.asarray(out["labels"])[:, -1:]], 1)


def _seq(step):
    b = _port(step)
    return torch.cat([b["inputs"], b["labels"][:, -1:]], 1).numpy()


def test_copy_channel_rate():
    """The copy channel fires on 0.25 +- 0.02 of the positions after the
    first; the repeat rate (a copy, or a fresh draw equal to the token
    before it) is JAX's within 0.02."""
    cfg = TokenPipelineConfig(**CFG)
    rates = [float(T.draw(cfg, s, device="cpu")[2][:, 1:].float().mean())
             for s in range(4)]
    assert abs(np.mean(rates) - 0.25) <= 0.02
    port = np.mean([_repeat_rate(_seq(s)) for s in range(4)])
    jax_ = np.mean([_repeat_rate(_jax(s)) for s in range(4)])
    assert abs(port - jax_) <= 0.02
    # a copied position repeats the last freshly drawn token
    toks, _, copy = T.draw(cfg, 0, device="cpu")
    seq = _seq(0)
    fresh = ~copy.numpy()
    assert np.array_equal(seq[fresh], toks.numpy()[fresh])
    assert np.all(seq[:, 1:][copy.numpy()[:, 1:]]
                  == seq[:, :-1][copy.numpy()[:, 1:]])


def test_topics_change_per_block():
    cfg = TokenPipelineConfig(**CFG)
    _, topics, _ = T.draw(cfg, 0, device="cpu")
    t = topics.numpy()
    assert t.shape == (32, 512)
    assert (t.reshape(32, 8, 64) == t.reshape(32, 8, 64)[:, :, :1]).all()
    assert len(np.unique(t)) == cfg.n_topics


def _rank_slope(seqs, top=100):
    """Slope of log frequency against log rank over the most frequent
    tokens of the pooled sequences."""
    counts = np.sort(np.bincount(np.concatenate([s.ravel() for s in seqs]),
                                 minlength=CFG["vocab"]))[::-1][:top]
    r = np.arange(1, top + 1)
    return float(np.polyfit(np.log(r), np.log(counts), 1)[0])


def test_zipf_rank_slope_matches_jax():
    port = _rank_slope([_seq(s) for s in range(6)])
    jax_ = _rank_slope([_jax(s) for s in range(6)])
    assert port < -0.5
    assert abs(port - jax_) <= 0.1, (port, jax_)


@pytest.mark.parametrize("vocab", [151936, 50])
def test_vocab_extremes(vocab):
    """qwen3-4b's vocab draws without a (rows, S, vocab) table, and a
    vocab below the topic block still covers its ranks."""
    b = batch_at_step(TokenPipelineConfig(vocab=vocab, seq_len=64,
                                          global_batch=2, seed=1), 0,
                      device="cpu")
    assert int(b["inputs"].max()) < vocab and int(b["inputs"].min()) >= 0
