"""Closed-loop traffic: a fixed number of clients, each sending its next
request as soon as its last one is answered.

The mix file gives the client count ("max_batch" means the engine's
max_batch), the prompt and output length distributions (log_uniform or
uniform over [low, high]) and how many requests the warm phase finishes
before the window opens. Sizes come in blocks of `clients` requests:
every block holds the same sizes, the quantiles (i + 0.5) / clients of
the distributions, so any stretch of the run sees the whole size
distribution. The order of the sizes within each block is the same for
every seed, and the run's seed draws the token ids: the engine deals
prefill lanes in slot order, so an order drawn from the seed moved the
TTFT tail by up to 1.6x from seed to seed while two runs of one seed
agreed within 5%. So every seed offers the same work in the same order."""
from __future__ import annotations

import math

import numpy as np

ORDER_SEED = 0      # draws the one order of sizes that every seed replays


def _grid(dist: dict, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    lo, hi = int(dist["low"]), int(dist["high"])
    if dist["dist"] == "log_uniform":
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
        return np.clip(np.rint(v), lo, hi).astype(np.int64)
    if dist["dist"] == "uniform":
        return np.minimum(lo + np.floor(q * (hi - lo + 1)), hi).astype(
            np.int64)
    raise ValueError(f"unknown distribution {dist['dist']!r}")


def resolve(value, engine: dict) -> int:
    """A count of the mix: a number, or the name of an engine setting."""
    return int(engine[value]) if isinstance(value, str) else int(value)


class Traffic:
    """The request stream of one run: request(j) is the j-th request sent,
    whichever client sends it."""

    def __init__(self, mix: dict, engine: dict, vocab: int, seed: int):
        self.clients = resolve(mix["clients"], engine)
        self.warm_requests = resolve(mix["warm_requests"],
                                     dict(engine, clients=self.clients))
        self.check_requests = int(mix["check_requests"])
        self.vocab = int(vocab)
        self.seed = int(seed)
        self._prompt = _grid(mix["prompt_tokens"], self.clients)
        self._new = _grid(mix["new_tokens"], self.clients)
        self._blocks: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def _block(self, b: int):
        if b not in self._blocks:
            rng = np.random.default_rng([ORDER_SEED, b])
            self._blocks[b] = (rng.permutation(self._prompt),
                               rng.permutation(self._new))
        return self._blocks[b]

    def request(self, j: int) -> tuple[np.ndarray, int]:
        """(prompt token ids (n,) int32, new tokens) of request j."""
        b, i = divmod(j, self.clients)
        plen, new = self._block(b)
        rng = np.random.default_rng([self.seed, b, i, 1])
        prompt = rng.integers(0, self.vocab, int(plen[i]), dtype=np.int64)
        return prompt.astype(np.int32), int(new[i])
