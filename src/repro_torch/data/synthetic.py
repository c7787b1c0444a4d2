"""Deterministic synthetic data pipeline (offline container: no SST-2/MNLI).

Two task families, both sharded and reproducible from (seed, step):

  * LM streams — markov-ish token sequences with planted n-gram structure so
    perplexity decreases measurably during the example training runs.
  * Classification — SST-2/MNLI proxies of matched geometry: class-dependent
    token statistics over a BERT-sized vocab; used by the Table I/II accuracy
    benchmarks with the paper's BERT-tiny/BERT-small architectures.

The iterator contract matches a real cluster loader: `batch_at(step)` is a
pure function of (seed, step, shard), so restarts and elastic re-sharding
resume identically without data state in the checkpoint.

The port's own copy of `repro/data/synthetic.py` (numpy only, so the port
imports nothing of the JAX package): the same generators, draw for draw, so
both packages train on the same batches (tests/test_torch_substrates.py
holds them bit-equal).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMStreamConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2          # planted n-gram order


class LMStream:
    """Deterministic LM token stream with learnable structure."""

    def __init__(self, cfg: LMStreamConfig, shard: int = 0, num_shards: int = 1):
        self.cfg = cfg
        self.shard, self.num_shards = shard, num_shards
        assert cfg.global_batch % num_shards == 0
        self.local_batch = cfg.global_batch // num_shards
        root = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # planted bigram transition: each token strongly prefers ~8 successors
        self._succ = root.integers(0, v, size=(v, 8))

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 65_537 + self.shard)
        b, t, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, t), np.int32)
        toks[:, 0] = rng.integers(0, v, b)
        explore = rng.random((b, t)) < 0.15
        choice = rng.integers(0, 8, (b, t))
        randtok = rng.integers(0, v, (b, t))
        for i in range(1, t):
            nxt = self._succ[toks[:, i - 1], choice[:, i]]
            toks[:, i] = np.where(explore[:, i], randtok[:, i], nxt)
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100, np.int32)], 1)
        return {"tokens": toks, "labels": labels}


@dataclasses.dataclass(frozen=True)
class ClsTaskConfig:
    """SST-2/MNLI-shaped synthetic classification.

    relational=False: class-dependent bag-of-token statistics (easy; solvable
    without attention fidelity).
    relational=True: every class marker appears exactly once; the label is
    WHICH marker occurs earliest — order-sensitive, bag-insensitive, so the
    model must route positional information through attention (this is the
    regime where a softmax surrogate's distortion shows up, mirroring the
    paper's no-retrain drop).
    """
    vocab_size: int = 30522
    seq_len: int = 64
    num_classes: int = 2
    seed: int = 0
    signal_tokens: int = 48      # class-informative token ids per class
    signal_rate: float = 0.22    # fraction of positions carrying signal
    pair: bool = False           # MNLI-style premise/hypothesis pairs
    relational: bool = False


class ClsTask:
    def __init__(self, cfg: ClsTaskConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed + 7)
        self._cls_tokens = root.integers(
            100, cfg.vocab_size, size=(cfg.num_classes, cfg.signal_tokens))
        self._markers = root.integers(50, 100, size=cfg.num_classes)

    def batch_at(self, step: int, batch: int, split: str = "train") -> dict:
        cfg = self.cfg
        salt = {"train": 0, "val": 1 << 30}[split]
        rng = np.random.default_rng(cfg.seed * 31 + step * 131 + salt)
        toks = rng.integers(100, cfg.vocab_size, (batch, cfg.seq_len))
        if cfg.relational:
            # label = which seq_len/num_classes bucket holds the marker token:
            # solvable only by routing positional information through
            # attention (bag statistics are class-independent), yet coarse
            # enough that a calibrated surrogate can recover it after QAT —
            # the paper's drop-then-recover regime.
            k = cfg.num_classes
            span = (cfg.seq_len - 1) // k
            labels = rng.integers(0, k, batch)
            offs = rng.integers(0, span, batch)
            pos = 1 + labels * span + offs
            toks[np.arange(batch), pos] = self._markers[0]
        else:
            labels = rng.integers(0, cfg.num_classes, batch)
            sig_mask = rng.random((batch, cfg.seq_len)) < cfg.signal_rate
            pick = rng.integers(0, cfg.signal_tokens, (batch, cfg.seq_len))
            sig = self._cls_tokens[labels[:, None], pick]
            toks = np.where(sig_mask, sig, toks)
        toks[:, 0] = 1  # [CLS]
        if cfg.pair:
            toks[:, cfg.seq_len // 2] = 2  # [SEP]
        return {"tokens": toks.astype(np.int32), "cls_labels": labels.astype(np.int32)}


def make_embedding_batch(rng: np.random.Generator, batch: int, seq: int,
                         d_model: int, vocab: int) -> dict:
    """Frontend-stub batch for audio/VLM backbones: precomputed embeddings."""
    emb = rng.normal(0, 1, (batch, seq, d_model)).astype(np.float32)
    labels = rng.integers(0, vocab, (batch, seq)).astype(np.int32)
    return {"embeddings": emb, "labels": labels}
