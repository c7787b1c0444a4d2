"""JAX's default PRNG (threefry2x32) rebuilt from integer torch ops, so the
port's temperature sampling draws the JAX package's tokens, not just tokens
of the same distribution. Port-only: the JAX engines call `jax.random`.

The parts the engines need, as JAX 0.9 computes them with
`jax_threefry_partitionable` on (its default):

    PRNGKey(seed)        (0, seed) for 0 <= seed < 2**32
    fold_in(key, d)      threefry2x32(key, (0, d))
    split(key, n)        threefry2x32(key, (0, i)), i < n, as (w0, w1)
    bits(key, (n,), 32)  w0 ^ w1 of threefry2x32(key, (hi, lo)) over the
                         flat index i = hi * 2**32 + lo, i < n
    bits 16 / 8          the low 16 / 8 bits of that XOR
    uniform f32          bits32 >> 9 | 0x3F800000, as f32, minus 1
    uniform bf16         bits8 >> 1 | 0x3F80, as bf16, minus 1 (bf16 has 7
                         mantissa bits, under the 8 that make JAX draw 8
                         random bits instead of 16)
    uniform(lo, hi) f32  max(lo, f * (hi - lo) + lo) of that f32 f
    gumbel               -log(-log(max(tiny, u))) in the logits' dtype
    categorical          argmax(gumbel + logits) over the last axis

Words are int64 tensors masked to 32 bits, vectorised over the draw index
(and over rows of keys), on the device of the tensors given. The counter
is the flat index, so a draw of n values can be made in pieces
(`start`): each piece equals its slice of the whole draw.

The bits, the uniform and the bf16 Gumbel noise equal JAX's bit for bit.
f32 Gumbel noise does not always: XLA's CPU `log` is not correctly rounded
(about 14% of f32 results differ from torch's by an ulp), so an f32 draw
agrees with `jax.random.categorical` except where two candidates lie within
an ulp of each other (tests/test_torch_prng.py).
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def prng_key(seed: int = 0) -> tuple[int, int]:
    """`jax.random.PRNGKey(seed)` for a seed in [0, 2**32)."""
    if not 0 <= seed <= MASK32:
        raise ValueError(f"seed {seed} outside [0, 2**32)")
    return (0, int(seed))


def _rotl(v, r: int):
    return ((v << r) | (v >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds, JAX's block function. Keys and counts
    are ints or int64 tensors holding uint32 values (broadcastable);
    returns the two output words the same way."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK32
    return x0, x1


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    """`jax.random.fold_in(key, np.uint32(data))`; a negative `data` wraps
    through uint32."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & MASK32)


def split(key, n: int = 2) -> list[tuple[int, int]]:
    """`jax.random.split(key, n)` (the partitionable form JAX 0.9 runs):
    key i is threefry2x32(key, (0, i)). `key` is a pair of ints or a (2,)
    tensor of uint32 values."""
    k0, k1 = (int(v) for v in key)
    count = torch.arange(n, dtype=torch.int64)
    w0, w1 = threefry2x32(k0, k1, torch.zeros_like(count), count)
    return list(zip(w0.tolist(), w1.tolist()))


def random_bits(keys: torch.Tensor, n: int, width: int = 32,
                start: int = 0) -> torch.Tensor:
    """`jax.random.bits(key, shape, uint<width>)` for each key of `keys`
    ((..., 2) int64): the draws at flat indices [start, start + n) of any
    shape holding at least start + n values, as (..., n) int64 on the keys'
    device."""
    if width not in (8, 16, 32):
        raise ValueError(f"width must be 8, 16 or 32, got {width}")
    k0, k1 = keys[..., :1], keys[..., 1:]
    count = torch.arange(start, start + n, dtype=torch.int64,
                         device=keys.device)
    w0, w1 = threefry2x32(k0, k1, count >> 32, count & MASK32)
    return (w0 ^ w1) & ((1 << width) - 1)


def uniform(keys: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.random.uniform(key, (n,), dtype, minval=tiny, maxval=1)` for
    each key, f32 or bf16: the mantissa bits under an exponent of 0, minus
    1. JAX then takes f * (1 - tiny) + tiny and its max with tiny; 1 - tiny
    rounds to 1 and f + tiny rounds to f for every f > 0, so that is the
    max with tiny."""
    tiny = torch.finfo(dtype).tiny
    if dtype == torch.float32:
        bits = random_bits(keys, n, 32)
        f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    elif dtype == torch.bfloat16:
        bits = random_bits(keys, n, 8)
        f = ((bits >> 1) | 0x3F80).to(torch.int16).view(torch.bfloat16)
    else:
        raise TypeError(f"uniform draws f32 or bf16, not {dtype}")
    return torch.clamp_min(f - 1.0, tiny)


def uniform_range(keys: torch.Tensor, n: int, minval: float,
                  maxval: float, start: int = 0) -> torch.Tensor:
    """`jax.random.uniform(key, shape, jnp.float32, minval, maxval)` at flat
    indices [start, start + n) for each key ((..., 2) int64): the f32 f of
    `uniform`, then max(lo, f * (hi - lo) + lo) with lo, hi the bounds in
    f32, as JAX builds it."""
    bits = random_bits(keys, n, 32, start)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = (torch.tensor(v, dtype=torch.float32, device=keys.device)
              for v in (minval, maxval))
    return torch.maximum(lo, f * (hi - lo) + lo)


def gumbel(keys: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """`jax.random.gumbel(key, (n,), dtype)` (mode "low") for each key."""
    return -torch.log(-torch.log(uniform(keys, n, dtype)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """`jax.random.categorical(key, logits)` row by row: keys (..., 2)
    int64, logits (..., V) f32 or bf16 on the same device. The Gumbel
    noise is drawn in the logits' dtype, as JAX draws it; ties go to the
    first index, as in jnp.argmax. Returns (...,) int64."""
    noise = gumbel(keys, logits.shape[-1], logits.dtype)
    return torch.argmax(noise + logits, dim=-1)
