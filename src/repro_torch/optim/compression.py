"""int8 gradient compression with stochastic rounding + error feedback —
the port of `repro/optim/compression.py`.

Gradients are quantized per leaf to int8 (symmetric, per-tensor scale)
before the data-parallel reduction, and the quantization residual is fed
back into the next step (error feedback keeps the compression unbiased in
the long run). On one device the reduction is the identity, so this is the
quantize -> dequantize round trip with its residual, as the JAX pjit path
computes it.

The rounding noise is JAX's: leaf i (in JAX's flatten order) draws
`jax.random.uniform(keys[i], shape, minval=-0.5, maxval=0.5)` with
`keys = jax.random.split(rng, n_leaves)`, rebuilt bit for bit by
`serve/prng.py`. Threefry is counter-based, so each leaf is drawn (and
quantized, in place) in pieces of its flat index, CHUNK elements at a
time: a (40, 2048, 8192) leaf needs no int64 word tensors of its whole
size.
"""
from __future__ import annotations

import torch

from repro_torch.core.hccs import true_div
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.serve import prng

CHUNK = 1 << 24                 # noise draws per piece


def _compress_leaf(g, e, key):
    """One leaf: gf = g + e (f32), amax over gf, then each piece's noise,
    q = clip(round(y + noise), -127, 127) (int8 values), deq = q * scale,
    written over g (in its dtype) and e = gf - deq."""
    gf_flat = lambda a, b: g.reshape(-1)[a:b].float() + e.reshape(-1)[a:b]
    n = g.numel()
    amax = None
    for a in range(0, n, CHUNK):
        m = torch.max(torch.abs(gf_flat(a, min(a + CHUNK, n))))
        amax = m if amax is None else torch.maximum(amax, m)
    scale = true_div(amax + 1e-12, 127.0)
    keys = torch.tensor(key, dtype=torch.int64, device=g.device)
    og, oe = g.view(-1), e.view(-1)
    for a in range(0, n, CHUNK):
        b = min(a + CHUNK, n)
        gf = gf_flat(a, b)
        noise = prng.uniform_range(keys, b - a, -0.5, 0.5, start=a)
        q = torch.clamp(torch.round(gf / scale + noise), -127, 127)
        deq = q.to(torch.int8).float() * scale
        og[a:b] = deq.to(g.dtype)
        oe[a:b] = gf - deq


def compress_grads(grads, error, rng):
    """Quantize grads (+error feedback) to int8; returns (deq_grads,
    new_error), written into `grads` and `error` (the train step donates
    both, as the JAX step does).

    error: a tree like grads (f32 residuals) or None on the first step.
    rng: the step's key, a pair of uint32 values."""
    leaves = tree_leaves(grads)
    keys = dict(zip(map(id, leaves), prng.split(rng, len(leaves))))
    if error is None:
        error = tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32),
                         grads)

    def leaf(g, e):
        if g is not None:
            _compress_leaf(g, e, keys[id(g)])

    tree_map(leaf, grads, error)
    return grads, error


def init_error(grads):
    return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)
