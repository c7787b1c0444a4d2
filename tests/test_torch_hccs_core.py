"""The port's HCCS core (`repro_torch.core.hccs`) against the JAX package's.

Integer stages are held bit for bit: leading_bit, hccs_scores, normalize in
all four modes, hccs_int and hccs_probs, on seeded int8 rows and on Z at
2^k - 1, 2^k and 2^k + 1. The float forms are held bit for bit too:
hccs_mode_inv over every integer Z the int16 range holds, and the forward
of hccs_qat (hard and soft, five modes, masked) and hccs_static_max_qat.
Tolerance on forward values: none. Every float operation of these functions
is one IEEE operation on integer-valued or identically rounded operands in
both frameworks, and the measured difference on every case here is 0 (the
one exception, XLA:CPU's inexact log2 at Z = 8192, is stated at its test).
The STE gradient has its own measured gate.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hccs as J
from repro.core.constraints import default_params
from repro_torch.core import hccs as P

MODES = ("i16_div", "i8_div", "i16_clb", "i8_clb")
EDGES = sorted({v for k in range(31) for v in (2 ** k - 1, 2 ** k,
                                               2 ** k + 1)
                if 0 < v < 2 ** 31})


def _rows(seed, n=64, cols=48):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (n, cols)).astype(np.int8)


def test_leading_bit_matches_at_powers_of_two():
    z = np.asarray(EDGES + list(range(1, 5000)), np.int32)
    want = np.asarray(J.leading_bit(jnp.asarray(z)))
    got = P.leading_bit(torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.floor(np.log2(z)).astype(np.int32))


@pytest.mark.parametrize("seed", range(3))
def test_hccs_scores_match(seed):
    x = _rows(seed)
    B, S, D = default_params(x.shape[1])
    js, jz = J.hccs_scores(jnp.asarray(x), B, S, D)
    ps, pz = P.hccs_scores(torch.from_numpy(x), B, S, D)
    assert ps.dtype == pz.dtype == torch.int32
    np.testing.assert_array_equal(ps.numpy(), np.asarray(js))
    np.testing.assert_array_equal(pz.numpy(), np.asarray(jz))


@pytest.mark.parametrize("mode", MODES)
def test_normalize_matches_at_leading_bit_edges(mode):
    """Z at 2^k - 1, 2^k, 2^k + 1 (where the clb modes' leading bit moves)
    and 1..4096, against seeded scores in [0, 255]."""
    rng = np.random.default_rng(7)
    z = np.asarray([v for v in EDGES if v <= 32767] + list(range(1, 4097)),
                   np.int32)[:, None]
    s = rng.integers(0, 256, (z.shape[0], 16)).astype(np.int32)
    want = np.asarray(J.normalize(jnp.asarray(s), jnp.asarray(z), mode))
    got = P.normalize(torch.from_numpy(s), torch.from_numpy(z), mode)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("seed", range(2))
def test_hccs_int_and_probs_match(mode, seed):
    x = _rows(10 + seed)
    B, S, D = default_params(x.shape[1])
    jp = J.HCCSParams(B=jnp.int32(B), S=jnp.int32(S), D=jnp.int32(D))
    pp = P.HCCSParams(B=torch.tensor(B), S=torch.tensor(S),
                      D=torch.tensor(D))
    np.testing.assert_array_equal(
        P.hccs_int(torch.from_numpy(x), pp, mode).numpy(),
        np.asarray(J.hccs_int(jnp.asarray(x), jp, mode)))
    got = P.hccs_probs(torch.from_numpy(x), pp, mode)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(J.hccs_probs(jnp.asarray(x), jp, mode)))


@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
def test_mode_inv_matches_over_the_int16_range(mode):
    """Bit-equal at every integer Z, except where XLA:CPU's log2 is itself
    inexact: jnp.log2(8192.) is 12.999999 there, so the JAX package floors
    to 12 where the integer pipeline's leading bit is 13. The port (torch
    and the CUDA kernels' log2f) gives 13 at every power of two; at those
    Z it is held to the leading-bit value instead."""
    z = np.arange(1, 32768, dtype=np.float32)[:, None]
    want = np.asarray(J.hccs_mode_inv(jnp.asarray(z), mode))
    got = P.hccs_mode_inv(torch.from_numpy(z), mode).numpy()
    lb = np.asarray(J.leading_bit(jnp.asarray(z.astype(np.int32))))
    inexact = np.asarray(jnp.floor(jnp.log2(jnp.asarray(z)))) != lb
    assert inexact.sum() <= 1                     # measured: Z = 8192 only
    if mode == "i16_clb":
        truth = np.floor(np.float32(32767) * np.exp2(-lb.astype(np.float32))
                         ).astype(np.float32) / np.float32(32767)
        np.testing.assert_array_equal(got[inexact], truth[inexact])
    np.testing.assert_array_equal(got[~inexact], want[~inexact])
    if mode != "i16_clb":
        np.testing.assert_array_equal(got, want)


def _qat_case(seed, heads=4, q=6, k=40):
    """Float logits (heads, q, k) around the int8 grid (some at exact
    half-integers of the scale, where round-half-even decides), per-head
    scales and theta, and a causal mask with one fully masked row."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.02, 0.08, heads).astype(np.float32)
    x = rng.normal(0, 3, (heads, q, k)).astype(np.float32)
    halves = (rng.integers(-200, 200, (heads, q, k)) + 0.5) \
        * scale[:, None, None]
    x = np.where(rng.random((heads, q, k)) < 0.2, halves, x) \
        .astype(np.float32)
    mask = np.tril(np.ones((q, k), bool), k=k - q)[None].repeat(heads, 0)
    mask[:, 0] = False                          # a row with no live key
    theta = np.stack([rng.integers(120, 200, heads),
                      rng.integers(0, 3, heads),
                      rng.integers(16, 100, heads)], -1).astype(np.int32)
    return x, scale[:, None, None], theta, mask


@pytest.mark.parametrize("hard", [True, False])
@pytest.mark.parametrize("mode", ["wide"] + list(MODES))
def test_hccs_qat_forward_matches(mode, hard):
    x, scale, theta, mask = _qat_case(3 if hard else 4)
    jp = J.HCCSParams(*(jnp.asarray(theta[:, i, None, None])
                        for i in range(3)))
    pp = P.HCCSParams(*(torch.from_numpy(theta[:, i, None, None].copy())
                        for i in range(3)))
    for m in (mask, None):
        want = np.asarray(J.hccs_qat(
            jnp.asarray(x), jnp.asarray(scale), jp, mode=mode, hard=hard,
            mask=None if m is None else jnp.asarray(m)))
        got = P.hccs_qat(torch.from_numpy(x), torch.from_numpy(scale), pp,
                         mode=mode, hard=hard,
                         mask=None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(J.hccs_static_max_qat(
        jnp.asarray(x), jnp.asarray(scale), jp, mask=jnp.asarray(mask)))
    got = P.hccs_static_max_qat(torch.from_numpy(x), torch.from_numpy(scale),
                                pp, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


def test_ste_gradient_matches():
    """The straight-through gradient of the hard i16_div pipeline equals
    jax.grad of the same loss (the STE makes every rounding the identity
    backward; ties at the row max and at the clip bounds split the
    gradient as in JAX). Measured max |d| 7.5e-9 (the frameworks sum the
    backward in other orders); the gate is atol 1e-7 with rtol 1e-5."""
    x, scale, theta, mask = _qat_case(5)
    w = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    jp = J.HCCSParams(*(jnp.asarray(theta[:, i, None, None])
                        for i in range(3)))
    pp = P.HCCSParams(*(torch.from_numpy(theta[:, i, None, None].copy())
                        for i in range(3)))
    jg = jax.grad(lambda v: (J.hccs_qat(v, jnp.asarray(scale), jp,
                                        mask=jnp.asarray(mask))
                             * w).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (P.hccs_qat(xt, torch.from_numpy(scale), pp, mask=torch.from_numpy(mask))
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)


def test_true_div_is_one_division():
    """`number / tensor` in torch is reciprocal(tensor) * number; true_div
    is the IEEE quotient numpy and XLA compute."""
    z = torch.arange(1, 32768, dtype=torch.float32)
    want = np.float32(32767) / z.numpy()
    np.testing.assert_array_equal(P.true_div(32767, z).numpy(), want)
    np.testing.assert_array_equal(P.true_div(z, 255).numpy(),
                                  z.numpy() / np.float32(255))
    assert (32767 / z != torch.from_numpy(want)).any()
