"""The port's public kernel API (`repro_torch.kernels`) against the JAX
package's (`repro.kernels`): the twin of tests/test_kernels.py.

Every case runs the JAX wrapper (its Pallas kernel in interpret mode), the
JAX oracle (`repro/kernels/ref.py`) and the port's wrapper on CPU tensors,
which runs the kernel's plain PyTorch version, on the same numpy inputs
import torch_threads  # noqa: F401  (first: one torch thread a worker)
from a seed. Tolerances:

- hccs_softmax (`hccs_rows`): none. Integer arithmetic throughout; bit-exact
  with the JAX kernel and the oracle in all four modes.
- softmax_reference (`softmax_bf16`): bf16 outputs within 1 bf16 ulp of the
  JAX kernel's (the two frameworks' exp and sum differ in the last f32
  bits; measured: at most 1 ulp on 1 of 65,536 elements); f32 outputs
  within rtol 2e-6 (measured 3.9e-7 at most); row sums within 2e-2, as the
  JAX test allows.
- hccs_attention (`hccs_mha_fused`): exact inputs (small multiples of 2^-3
  and power-of-two scales: every product and sum is exact in f32 in any
  order) bit-identical to the JAX kernel. Random normal inputs within
  atol 1e-6 of the JAX kernel (measured 2.1e-7 at most over these cases;
  a logit one ulp from an int8 bin edge may flip bins, so the gate is ~5x
  the measurement, not 0), and within the JAX test's atol 5e-3 of the
  oracle, which takes its product in the inputs' dtype and divides by
  sqrt(d) where the kernel multiplies by f32(1/sqrt(d)).
- Port identities: the fused kernel's last causal row equals the port's
  `hccs_decode` within 5e-3 (as tests/test_decode_kernel.py allows; the
  decode kernel divides by sqrt(d)), and the fused kernel equals the port's
  blockwise STE attention in mode wide within 1e-6 (measured 1.8e-7; the
  JAX test allows 2e-4).
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import constraints as JC
from repro.kernels import ops as J
from repro.kernels import ref as JREF
from repro_torch import kernels as P
from repro_torch.configs.base import ModelConfig
from repro_torch.core import constraints as PC
from repro_torch.core.hccs import leading_bit
from repro_torch.kernels import ref as PREF
from repro_torch.kernels.attention import hccs_mha_fused, sm_scale
from repro_torch.models.attention import _blockwise_attention

MODES = ["i16_div", "i8_div", "i16_clb", "i8_clb"]
SOFTMAX_RTOL_F32 = 2e-6
FUSED_ATOL = 1e-6
ORACLE_ATOL = 5e-3
BLOCKWISE_ATOL = 1e-6


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _theta(n, rows):
    B, S, D = JC.default_params(n)
    return np.tile(np.asarray([[B, S, D]], np.int32), (rows, 1))


def _rows_all(x, theta, mode):
    """(JAX kernel, JAX oracle, port) outputs as numpy arrays."""
    got = P.hccs_softmax(torch.from_numpy(x), torch.from_numpy(theta), mode)
    assert got.dtype == torch.int32
    return (np.asarray(J.hccs_softmax(jnp.asarray(x), jnp.asarray(theta),
                                      mode)),
            np.asarray(JREF.hccs_rows_ref(jnp.asarray(x), jnp.asarray(theta),
                                          mode)),
            got.numpy())


# ------------------------------------------------------------- hccs_rows --

@pytest.mark.parametrize("shape", [(1, 32), (7, 64), (16, 128), (65, 130),
                                   (300, 257), (8, 1024)])
@pytest.mark.parametrize("mode", MODES)
def test_hccs_rows_bit_exact(shape, mode):
    x = _rng("rows", shape, mode).integers(-128, 128, shape).astype(np.int8)
    kern, oracle, port = _rows_all(x, _theta(shape[1], shape[0]), mode)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)


def test_hccs_rows_per_row_theta():
    """Different calibration per row (per-head batching), some rows
    uniform (S = 0)."""
    x = _rng("per-row").integers(-128, 128, (6, 64)).astype(np.int8)
    theta = _theta(64, 6)
    theta[3:, 1] = 0
    kern, oracle, port = _rows_all(x, theta, "i16_div")
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)


@pytest.mark.parametrize("mode", MODES)
def test_hccs_rows_degenerate_rows(mode):
    """The three rows of tests/test_attention_modes.py: all at the minimum,
    all at the maximum, one focused maximum."""
    n = 64
    x = np.stack([np.full(n, -128), np.full(n, 127),
                  np.concatenate([[127], np.full(n - 1, -128)])]).astype(
                      np.int8)
    kern, oracle, port = _rows_all(x, _theta(n, 3), mode)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)
    assert (port >= 0).all()
    assert port[2, 0] > port[2, 1]


@pytest.mark.parametrize("mode", MODES)
def test_hccs_rows_full_width_feasible_theta(mode):
    """Rows of granite's attention width (2048 keys) with per-row theta
    drawn from the feasible grid at n = 2048 with S > 0. default_params(2048)
    has S = 0 (every row uniform) and the n-128 calibration breaks
    n * B <= 32767 (every i16/i8 output 0), so either would make a
    bit-identity check vacuous. Every i16 row is non-uniform; the i8 modes'
    255 levels leave most entries of a 2048-key row at 0, so there the rows
    with the smallest B carry the non-zero, non-uniform outputs."""
    n, rows = 2048, 14
    grid = PC.feasible_grid(n)
    grid = grid[grid[:, 1] > 0]
    theta = grid[np.arange(rows) % len(grid)]
    PC.validate_params(theta[:, 0], theta[:, 1], theta[:, 2], n)
    x = _rng("wide", mode).integers(-128, 128, (rows, n)).astype(np.int8)
    kern, oracle, port = _rows_all(x, theta, mode)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)
    spread = port.max(-1) > port.min(-1)
    assert spread.all() if mode.startswith("i16") else spread.any()


@pytest.mark.parametrize("mode", MODES)
def test_hccs_rows_i8_range(mode):
    """Rows that take the i8 modes over their range (at 2048 keys an i8
    output is only ever 0 or 1): theta per row from the whole feasible grid
    at n = 32, logits peaked at 127 with exponential distances of a per-row
    mean, so that some rows put most of Z on a few keys. The i8 outputs take
    at least 32 levels (the port gives 57 and 72 on these rows)."""
    n, rows = 32, 256
    rng = _rng("i8-range", mode)
    grid = PC.feasible_grid(n)
    theta = grid[rng.integers(0, len(grid), rows)]
    mean = rng.uniform(1, 128, (rows, 1))
    x = np.clip(127 - np.floor(rng.exponential(mean, (rows, n))), -128,
                127).astype(np.int8)
    kern, oracle, port = _rows_all(x, theta, mode)
    np.testing.assert_array_equal(port, kern)
    np.testing.assert_array_equal(port, oracle)
    if mode.startswith("i8"):
        assert len(np.unique(port)) >= 32


def test_leading_bit_clz_equals_shift_cascade():
    """csrc/hccs_rows.cu takes floor(log2 z) as 31 - __clz(z | 1); the JAX
    kernel (and the plain version) use a shift cascade. __clz(x) of a
    32-bit x >= 0 is 32 - x.bit_length(). The two agree at 2^k - 1, 2^k and
    2^k + 1 for k = 0..30 (the points where the leading bit moves)."""
    z = sorted({v for k in range(31) for v in (2 ** k - 1, 2 ** k, 2 ** k + 1)
                if v < 2 ** 31})
    clz = [32 - (v | 1).bit_length() for v in z]
    cuda_expr = np.asarray([31 - c for c in clz], np.int32)
    cascade = leading_bit(torch.tensor(z, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(cuda_expr, cascade)


def test_hccs_rows_casts_to_int8_and_checks_its_arguments():
    x = _rng("cast").integers(-300, 300, (5, 40)).astype(np.int32)
    theta = _theta(40, 5)
    got = P.hccs_softmax(torch.from_numpy(x), torch.from_numpy(theta))
    want = J.hccs_softmax(jnp.asarray(x), jnp.asarray(theta))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="mode"):
        P.hccs_softmax(torch.from_numpy(x), torch.from_numpy(theta), "wide")
    with pytest.raises(ValueError, match="theta"):
        P.hccs_softmax(torch.from_numpy(x), torch.from_numpy(theta[:4]))


# ---------------------------------------------------------- softmax_bf16 --

@pytest.mark.parametrize("shape", [(4, 32), (33, 100), (128, 512)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_softmax_reference_kernel(shape, dtype):
    x = _rng("softmax", shape, dtype).normal(0, 2, shape).astype(np.float32)
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(np.asarray(xj).astype(np.float32)).to(
            torch.bfloat16)
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    got = P.softmax_reference(xt)
    assert got.dtype == xt.dtype
    for want in (J.softmax_reference(xj), JREF.softmax_bf16_ref(xj)):
        want = np.asarray(want)
        if dtype == "bfloat16":
            bits = got.view(torch.int16).numpy().astype(np.int32)
            ulps = np.abs(bits - want.view(np.int16).astype(np.int32))
            assert ulps.max() <= 1, ulps.max()
        else:
            np.testing.assert_allclose(got.numpy(), want,
                                       rtol=SOFTMAX_RTOL_F32, atol=0)
    sums = got.float().sum(-1).numpy()
    np.testing.assert_allclose(sums, 1.0, atol=2e-2)


# ------------------------------------------------------- hccs_mha_fused --

def _attn_case(key, b, h, hkv, tq, tk, d, exact=False):
    rng = _rng(*key)
    if exact:
        q = rng.integers(-8, 9, (b, h, tq, d)) / 8.0
        k = rng.integers(-8, 9, (b, hkv, tk, d)) / 8.0
        v = rng.integers(-8, 9, (b, hkv, tk, d)) / 8.0
        scale = 2.0 ** rng.integers(-4, -1, h)
    else:
        q = rng.normal(0, 1, (b, h, tq, d))
        k = rng.normal(0, 1, (b, hkv, tk, d))
        v = rng.normal(0, 1, (b, hkv, tk, d))
        scale = np.full(h, 0.05)
    theta = _theta(tk, h)
    f32 = (lambda a: np.asarray(a, np.float32))
    return f32(q), f32(k), f32(v), f32(scale), theta


def _fused_all(case, causal, dtype="float32"):
    """(JAX kernel, JAX oracle, port) outputs as float32 numpy arrays."""
    q, k, v, scale, theta = case
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jargs = [jnp.asarray(a, jd) for a in (q, k, v)] + [jnp.asarray(scale),
                                                      jnp.asarray(theta)]
    targs = [torch.from_numpy(a).to(td) for a in (q, k, v)] + [
        torch.from_numpy(scale), torch.from_numpy(theta)]
    got = P.hccs_attention(*targs, causal=causal)
    assert got.dtype == td and got.shape == q.shape
    kern = J.hccs_attention(*jargs, causal=causal, block_q=32, block_k=32)
    oracle = JREF.hccs_attention_ref(*jargs, causal=causal)
    f = (lambda a: np.asarray(a, np.float32))
    return f(kern), f(oracle), got.float().numpy()


@pytest.mark.parametrize("gqa", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("tq,tk,d", [(16, 16, 32), (67, 67, 32),
                                     (64, 64, 128)])
def test_fused_attention_random(gqa, tq, tk, d):
    case = _attn_case(("fused", gqa, tq, tk, d), 2, *gqa, tq, tk, d)
    kern, oracle, port = _fused_all(case, causal=True)
    np.testing.assert_allclose(port, kern, rtol=0, atol=FUSED_ATOL)
    np.testing.assert_allclose(port, oracle, rtol=0, atol=ORACLE_ATOL)


@pytest.mark.parametrize("gqa,tq,tk,d,causal", [
    ((4, 2), 40, 56, 64, True),       # Tq < Tk: causal from the start
    ((4, 1), 56, 40, 64, True),       # Tq > Tk: late rows see every key
    ((2, 2), 40, 40, 16, False),
    ((8, 2), 33, 47, 64, False)],
    ids=["tq<tk", "tq>tk", "noncausal", "noncausal-tq!=tk"])
def test_fused_attention_masks(gqa, tq, tk, d, causal):
    case = _attn_case(("mask", gqa, tq, tk, d, causal), 1, *gqa, tq, tk, d)
    kern, oracle, port = _fused_all(case, causal=causal)
    np.testing.assert_allclose(port, kern, rtol=0, atol=FUSED_ATOL)
    np.testing.assert_allclose(port, oracle, rtol=0, atol=ORACLE_ATOL)


@pytest.mark.parametrize("d,causal,dtype", [
    (32, True, "float32"), (64, False, "float32"), (128, True, "bfloat16"),
    (96, True, "float32")])
def test_fused_attention_exact_inputs_bit_identical(d, causal, dtype):
    """At d = 96 the kernel's f32(1/sqrt(d)) differs by an ulp from
    1/sqrt(f32(d)), so this case also shows that the plain version takes the
    JAX kernel's constant."""
    case = _attn_case(("exact", d, causal), 2, 4, 2, 40, 48, d, exact=True)
    kern, _, port = _fused_all(case, causal=causal, dtype=dtype)
    np.testing.assert_array_equal(port, kern)


def test_fused_attention_sm_scale_is_the_kernels_constant():
    """The multiply constant is 1/sqrt(d) taken in double and rounded once
    to f32, as `_fused_kernel`'s `sm_scale`; it equals 1/sqrt(f32(d)) at
    granite's d = 64 but not at d = 96."""
    for d in (32, 64, 96, 128):
        assert sm_scale(d) == float(np.float32(1.0 / float(d) ** 0.5))
    assert sm_scale(64) == 0.125
    assert sm_scale(96) != float(np.float32(1) / np.sqrt(np.float32(96)))


@pytest.mark.parametrize("tq,tk,d,elem,causal,want", [
    # granite's causal prefill: q_int of 64 rows x 2048 keys cached;
    # Q / s region 64 x 68 x 4, ring 2 x 128 x (64 * 4 + 16), exchange
    # 64 x 8 x 4, cache 64 x (2048 + 16)
    (2048, 2048, 64, 4, True, (True, 17408 + 69632 + 2048 + 132096)),
    # its rows see 128 keys under causal: cached, 64 x (128 + 16)
    (128, 8192, 64, 4, True, (True, 17408 + 69632 + 2048 + 9216)),
    # past the cache: Q and s apart, no cache
    (128, 8192, 64, 4, False, (False, 2 * 17408 + 69632 + 2048)),
    (2880, 2880, 64, 4, True, (False, 2 * 17408 + 69632 + 2048)),
    # the last length that fits at d 64 f32, and the first that does not
    (2176, 2176, 64, 4, False, (True, 17408 + 69632 + 2048 + 140288)),
    (2177, 2177, 64, 4, False, (False, 2 * 17408 + 69632 + 2048)),
    # bf16 rows (64 * 2 + 16 bytes); d 128 (Q 64 x 132 x 4) past the cache
    (2048, 2048, 64, 2, True, (True, 17408 + 36864 + 2048 + 132096)),
    (2048, 2048, 128, 4, True, (False, 33792 + 17408 + 135168 + 2048)),
    # d 18 runs at the 32-column tile width (Q 64 x 36 x 4 < the s tile),
    # cache 64 x (256 + 16)
    (200, 200, 18, 4, True, (True, 17408 + 36864 + 2048 + 17408)),
])
def test_fused_plan_and_shared_memory(tq, tk, d, elem, causal, want):
    """The Python mirror of csrc/hccs_fused.cu fused_smem_bytes and the
    variant the wrapper picks, against hand-computed values (chip_smoke.py
    phase 2 holds the mirror against the C formula on the card)."""
    from repro_torch.kernels.attention import MAX_SMEM_BYTES, fused_plan
    assert fused_plan(tq, tk, d, elem, causal) == want
    assert want[1] <= MAX_SMEM_BYTES


def test_fused_plan_refuses_no_shape_the_launch_accepts():
    """Every head dim (1..128), dtype and key count the launch takes fits
    the card's shared memory in the variant fused_plan picks: the recompute
    variant does not grow with the keys."""
    from repro_torch.kernels.attention import (MAX_HEAD_DIM, MAX_SMEM_BYTES,
                                               fused_plan, fused_smem_bytes)
    for d in range(1, MAX_HEAD_DIM + 1):
        for elem in (4, 2):
            assert fused_smem_bytes(d, elem, 1, False) == \
                fused_smem_bytes(d, elem, 1 << 30, False)
            for tk in (1, 63, 64, 65, 1000, 2048, 4096, 1 << 20):
                for causal in (True, False):
                    cache, smem = fused_plan(tk, tk, d, elem, causal)
                    assert smem <= MAX_SMEM_BYTES
                    assert cache or fused_smem_bytes(
                        d, elem, tk, True) > MAX_SMEM_BYTES


def test_fused_attention_checks_its_arguments():
    q, k, v, scale, theta = (torch.from_numpy(a) for a in _attn_case(
        ("checks",), 1, 4, 2, 8, 8, 16))
    with pytest.raises(TypeError, match="share"):
        P.hccs_attention(q, k.to(torch.bfloat16), v, scale, theta)
    with pytest.raises(ValueError, match="inconsistent"):
        P.hccs_attention(q, k[:, :, :, :8], v[:, :, :, :8], scale, theta)
    with pytest.raises(ValueError, match="qint_out"):
        hccs_mha_fused(q, k, v, scale, theta,
                       qint_out=torch.zeros((1, 4, 8, 8), dtype=torch.int8))


# -------------------------------------------------------- port identities --

def test_fused_last_row_equals_port_decode():
    """The twin of tests/test_decode_kernel.py::
    test_decode_matches_fused_prefill_last_row, inside the port."""
    b, h, hkv, t, d = 2, 4, 2, 64, 32
    q, k, v, scale, theta = (torch.from_numpy(a) for a in _attn_case(
        ("last-row",), b, h, hkv, t, t, d))
    full = P.hccs_attention(q, k, v, scale, theta, causal=True)
    dec = P.hccs_decode(q[:, :, -1, :].contiguous(), k, v,
                        torch.full((b,), t, dtype=torch.int32), scale, theta)
    np.testing.assert_allclose(dec.numpy(), full[:, :, -1, :].numpy(),
                               rtol=0, atol=5e-3)


@pytest.mark.parametrize("d", [32, 64])
def test_fused_equals_port_blockwise_wide(d):
    """The twin of tests/test_kernels.py::
    test_fused_attention_matches_model_blockwise_semantics, inside the port:
    the fused kernel computes what the served model's blockwise STE
    attention computes in mode wide."""
    b, h, hkv, t = 1, 4, 2, 64
    q, k, v, scale, theta = (torch.from_numpy(a) for a in _attn_case(
        ("blockwise", d), b, h, hkv, t, t, d))
    fused = P.hccs_attention(q, k, v, scale, theta, causal=True)
    cfg = ModelConfig(name="x", family="dense", num_layers=1, d_model=h * d,
                      num_heads=h, num_kv_heads=hkv, d_ff=1, vocab_size=8,
                      attention_prob="hccs", hccs_mode="wide", block_k=32)
    hc = {"B": theta[:, 0].clone(), "S": theta[:, 1].clone(),
          "D": theta[:, 2].clone(), "scale": scale}
    pos = torch.arange(t)[None].expand(b, t)
    model = _blockwise_attention(q, k, v, pos, None, cfg, hc)
    np.testing.assert_allclose(fused.numpy(), model.numpy(), rtol=0,
                               atol=BLOCKWISE_ATOL)


# ---------------------------------------------------- the public surface --

def test_ref_names_every_plain_version():
    assert set(PREF.__all__) == {
        name for name in dir(JREF) if name.endswith("_ref")}
    x = torch.from_numpy(_rng("ref").integers(-128, 128, (3, 16)).astype(
        np.int8))
    theta = torch.from_numpy(_theta(16, 3))
    np.testing.assert_array_equal(PREF.hccs_rows_ref(x, theta).numpy(),
                                  P.hccs_softmax(x, theta).numpy())


# ------------------------------------------------------------ constraints --

@pytest.mark.parametrize("n", [32, 64, 128, 2048])
def test_feasible_grid_matches(n):
    got, want = PC.feasible_grid(n), JC.feasible_grid(n)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert all(PC.is_feasible(*map(int, row), n) for row in got)


@pytest.mark.parametrize("theta", [
    (9, 1, 8), (128, 0, 200), (9, 2, 8), (17, 0, 8), (0, 0, 8), (9, -1, 8),
    ([9, 10, 11], [1, 1, 1], [8, 8, 8]), ([9, 20], [1, 1], [8, 8])],
    ids=["ok", "d-max", "floor", "int16", "b-zero", "s-neg", "batched-ok",
         "batched-bad"])
def test_validate_params_matches(theta):
    outcomes = []
    for mod in (JC, PC):
        try:
            mod.validate_params(*theta, 2048)
            outcomes.append(None)
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
