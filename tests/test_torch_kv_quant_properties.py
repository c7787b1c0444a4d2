"""Property tests of the port's quantizing fold (`kernels/kv_quant.py`
paged_quant_scatter, plain version on CPU tensors): the twin of
tests/test_kv_quant_properties.py, fuzzed with hypothesis.

  * bit-exact agreement with the numpy model of the running-amax requant
    and with the JAX package's paged_quant_scatter on the same rows;
  * partition independence: any ordered split of the rows into write
    groups folds to the same pool bytes and scales;
  * scales grow monotonically and always cover the rows written so far;
  * the CUDA kernel's algorithm, emulated in numpy, and the K+V plain
    version equal the JAX fold with draft rows and fresh blocks.
"""
from conftest import require_hypothesis

hypothesis = require_hypothesis()

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro.models.attention import paged_quant_scatter as jax_fold  # noqa
from repro_torch.kernels.kv_quant import (KV_QUANT_EPS,  # noqa: E402
                                          KV_QUANT_INV_QMAX,
                                          paged_quant_scatter)

N, HKV, BS, HD = 3, 2, 4, 3


def _np_half_away(x):
    return np.sign(x) * np.floor(np.abs(x) + np.float32(0.5))


def _np_fold(rows, positions):
    pool = np.zeros((N, HKV, BS, HD), np.float32)
    scales = np.zeros((N, HKV), np.float32)
    for x, p in zip(rows, positions):
        blk, r = int(p) // BS, int(p) % BS
        s_new = np.maximum(scales[blk],
                           np.maximum(np.abs(x).max(-1),
                                      np.float32(KV_QUANT_EPS))
                           * KV_QUANT_INV_QMAX)
        ratio = (scales[blk] / s_new).astype(np.float32)
        payload = np.clip(_np_half_away(pool[blk] * ratio[:, None, None]),
                          -128, 127)
        payload[:, r, :] = np.clip(_np_half_away(x / s_new[:, None]),
                                   -128, 127)
        pool[blk] = payload
        scales[blk] = s_new
    return pool.astype(np.int8), scales


def _port_fold_groups(rows, positions, splits):
    pool = torch.zeros((N, HKV, BS, HD), dtype=torch.int8)
    scales = torch.zeros((N, HKV), dtype=torch.float32)
    o = 0
    for g in splits:
        new_kv = torch.tensor(np.stack(rows[o:o + g], axis=1)[None])
        wp = torch.tensor(np.asarray(positions[o:o + g], np.int32)[None])
        paged_quant_scatter(pool, scales, new_kv, wp)
        o += g
    return pool.numpy(), scales.numpy()


@st.composite
def fold_case(draw):
    """Rows written in position order, values over ~4 orders of magnitude
    (running-amax growth and the eps floor), and a random ordered partition
    into write groups."""
    t = draw(st.integers(1, N * BS))
    vals = draw(st.lists(
        st.floats(-100.0, 100.0, width=32, allow_nan=False),
        min_size=t * HKV * HD, max_size=t * HKV * HD))
    rows = [np.asarray(vals[i * HKV * HD:(i + 1) * HKV * HD],
                       np.float32).reshape(HKV, HD) for i in range(t)]
    cuts = sorted(draw(st.sets(st.integers(1, t - 1), max_size=t - 1))) \
        if t > 1 else []
    splits = [b - a for a, b in zip([0] + cuts, cuts + [t])]
    return rows, list(range(t)), splits


@given(fold_case())
@settings(max_examples=60, deadline=None)
def test_fold_matches_numpy_and_jax_and_is_partition_independent(case):
    rows, positions, splits = case
    ref_pool, ref_scales = _np_fold(rows, positions)
    jp, js = jax_fold(jnp.zeros((N, HKV, BS, HD), jnp.int8),
                      jnp.zeros((N, HKV), jnp.float32),
                      jnp.asarray(np.stack(rows, axis=1)[None]),
                      jnp.asarray(np.asarray(positions, np.int32)[None]))
    for groups in ([len(rows)], splits):
        pool, scales = _port_fold_groups(rows, positions, groups)
        np.testing.assert_array_equal(pool, ref_pool, groups)
        np.testing.assert_array_equal(scales, ref_scales, groups)
        np.testing.assert_array_equal(pool, np.asarray(jp), groups)
        np.testing.assert_array_equal(scales, np.asarray(js), groups)


@given(fold_case())
@settings(max_examples=40, deadline=None)
def test_scales_monotone_and_cover_written_rows(case):
    rows, positions, _ = case
    pool = torch.zeros((N, HKV, BS, HD), dtype=torch.int8)
    scales = torch.zeros((N, HKV), dtype=torch.float32)
    prev = np.zeros((N, HKV), np.float32)
    amax_so_far = np.zeros((N, HKV), np.float32)
    for row, p in zip(rows, positions):
        paged_quant_scatter(pool, scales, torch.tensor(row[None, :, None]),
                            torch.tensor([[p]], dtype=torch.int32))
        cur = scales.numpy().copy()
        assert (cur >= prev).all()
        blk = p // BS
        amax_so_far[blk] = np.maximum(amax_so_far[blk], np.abs(row).max(-1))
        assert (amax_so_far[blk] <= 127.0 * cur[blk] * (1 + 1e-6)).all()
        prev = cur


@st.composite
def scan_case(draw):
    """Up to 70 rows (three 32-lane chunks) into any positions, collisions
    and out-of-order targets included, each row a draft row or not, from
    zero or set scales, some blocks listed fresh."""
    t = draw(st.integers(1, 70))
    mags = draw(st.lists(st.sampled_from([1e-9, 0.01, 1.0, 40.0]),
                         min_size=t, max_size=t))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(t, HKV, HD))
            * np.asarray(mags)[:, None, None]).astype(np.float32)
    pos = np.asarray(draw(st.lists(st.integers(0, N * BS - 1), min_size=t,
                                   max_size=t)), np.int32)
    draft = np.asarray(draw(st.lists(st.booleans(), min_size=t,
                                     max_size=t)))
    scales = np.asarray(draw(st.lists(
        st.sampled_from([0.0, 1e-3, 0.05]), min_size=N * HKV,
        max_size=N * HKV)), np.float32).reshape(N, HKV)
    fresh = np.asarray(draw(st.lists(st.integers(0, N - 1), max_size=3)),
                       np.int32)
    pool = rng.integers(-128, 128, (N, HKV, BS, HD)).astype(np.int8)
    return pool, scales, rows, pos, draft, fresh


@given(scan_case())
@settings(max_examples=30, deadline=None)
def test_scan_kernel_emulation_matches_jax_fold(case):
    """The CUDA kernel's algorithm (tests/test_torch_kv_quant.py
    _emulate_scan_kernel: the map-pair scan, the fresh reset, the
    per-element requant) equals the JAX fold after the same reset, and the
    port's K+V plain version equals it on the same rows as K and V."""
    from test_torch_kv_quant import _emulate_scan_kernel

    from repro_torch.kernels.kv_quant import paged_quant_scatter_kv
    pool, scales, rows, pos, draft, fresh = case
    got = _emulate_scan_kernel(pool, scales, rows, pos, draft, fresh)
    reset = scales.copy()
    reset[fresh] = 0.0
    jp, js = jax_fold(jnp.asarray(pool), jnp.asarray(reset),
                      jnp.asarray(rows.transpose(1, 0, 2)[None]),
                      jnp.asarray(pos[None]),
                      draft_rows=jnp.asarray(draft[None]))
    np.testing.assert_array_equal(got[0], np.asarray(jp))
    np.testing.assert_array_equal(got[1], np.asarray(js))
    tp = [torch.tensor(pool) for _ in range(2)]
    ts = [torch.tensor(scales) for _ in range(2)]
    new_kv = torch.tensor(rows.transpose(1, 0, 2)[None])
    paged_quant_scatter_kv(tp[0], ts[0], new_kv, tp[1], ts[1], new_kv,
                           torch.tensor(pos[None]),
                           draft_rows=torch.tensor(draft[None]),
                           fresh_blocks=torch.tensor(fresh))
    for p, s in zip(tp, ts):
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
