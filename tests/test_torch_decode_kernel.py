"""The port's `hccs_packed_prefill` (its plain PyTorch version on CPU
tensors) against the JAX Pallas kernel (interpret mode on the CPU).

Every case has a prefill chunk at successive frontiers (causality inside a
chunk), decode lanes, a zero-length row, pad lanes, sentinel table entries
past and inside a frontier, and a shuffled pool.

(a) Exact inputs: q, k, v and the int8 dequant scale are small multiples of
    2^-3, so every dot product and every s*v sum is exact in f32 in any
    order; q_int must be identical and the outputs equal within rtol 1e-6.
(b) Random normal inputs: the two frameworks sum the dot products in other
    orders, so a logit may land in the neighbouring int8 bin. The flipped
    bins are counted against the bound measured below, and rows without a
    flip are held to the float tolerance measured below.
"""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.kernels.decode import hccs_packed_prefill, packed_qint

HKV, D, BS, NBLK, N_BLOCKS = 2, 16, 8, 6, 24
# token layout: slot 0 a 5-token chunk (frontiers 36..40) and a decode lane
# at 17, slot 1 a decode lane, slot 2 a zero-length row, two pad lanes
SID = [0, 0, 0, 0, 0, 1, 2, 0, -1, -1]
LENS = [36, 37, 38, 39, 40, 13, 0, 17, 0, 0]
# (b) gates. Measured on this suite's 36 seeded random cases (torch 2.13
# CPU against jax 0.9 CPU): 0 flipped bins of 358-716 live logits per case
# and max |d| 1.8e-7 on the outputs. A flip is a legitimate outcome of the
# summation order, so the gate allows two per case; the float gate is ~5x
# the measured drift.
MAX_FLIPS = 2
RANDOM_ATOL = 1e-6


def _case(seed, group, pool, exact):
    rng = np.random.default_rng(seed)
    h = HKV * group
    shape = (N_BLOCKS, HKV, BS, D)
    if exact:
        q = rng.integers(-8, 9, (len(SID), h, D)) / 8.0
        k = rng.integers(-8, 9, shape) / 8.0
        v = rng.integers(-8, 9, shape) / 8.0
        scale = rng.uniform(0.015, 0.03, h)
    else:
        q = rng.normal(0, 1, (len(SID), h, D))
        k = rng.normal(0, 1, shape)
        v = rng.normal(0, 1, shape)
        scale = rng.uniform(0.01, 0.04, h)
    table = np.full((3, NBLK), -1, np.int32)
    blocks = rng.permutation(np.arange(1, N_BLOCKS))
    table[0, :5] = blocks[:5]                     # slot 0: 40 tokens
    table[0, 2] = -1                              # sentinel inside a frontier
    table[1, :2] = blocks[5:7]                    # slot 1: 13 tokens
    theta = np.stack([rng.integers(120, 200, h), rng.integers(0, 2, h),
                      rng.integers(16, 100, h)], -1).astype(np.int32)
    case = dict(q=q.astype(np.float32), block_table=table,
                slot_ids=np.asarray(SID, np.int32),
                lengths=np.asarray(LENS, np.int32),
                scale=scale.astype(np.float32), theta=theta)
    if pool == "int8":
        sc = (np.full((N_BLOCKS, HKV), 0.125) if exact
              else rng.uniform(0.05, 0.2, (N_BLOCKS, HKV)))
        case.update(k_pool=np.clip(np.round(k * 8), -127, 127)
                    .astype(np.int8),
                    v_pool=np.clip(np.round(v * 8), -127, 127)
                    .astype(np.int8),
                    k_scales=sc.astype(np.float32),
                    v_scales=sc[::-1].astype(np.float32).copy())
    else:
        case.update(k_pool=k.astype(np.float32), v_pool=v.astype(np.float32))
    return case


def _jax(case, pool, **kw):
    j = {name: jnp.asarray(a) for name, a in case.items()}
    if pool == "bf16":
        j["k_pool"] = j["k_pool"].astype(jnp.bfloat16)
        j["v_pool"] = j["v_pool"].astype(jnp.bfloat16)
    out = ops.hccs_packed_prefill(
        j["q"], j["k_pool"], j["v_pool"], j["block_table"], j["slot_ids"],
        j["lengths"], j["scale"], j["theta"], k_scales=j.get("k_scales"),
        v_scales=j.get("v_scales"), **kw)
    return np.asarray(out)


def _torch_args(case, pool):
    t = {name: torch.from_numpy(np.ascontiguousarray(a))
         for name, a in case.items()}
    if pool == "bf16":
        t["k_pool"] = t["k_pool"].to(torch.bfloat16)
        t["v_pool"] = t["v_pool"].to(torch.bfloat16)
    t.setdefault("k_scales", None)
    t.setdefault("v_scales", None)
    return t


def _jax_qint(case, pool):
    """The JAX kernel's quantized logits (`_decode_tile.quantized_logits`),
    evaluated with its jnp ops on the gathered keys of each token."""
    q = jnp.asarray(case["q"])
    kp = jnp.asarray(case["k_pool"])
    if pool == "bf16":
        kp = kp.astype(jnp.bfloat16)
    kp = kp.astype(jnp.float32)
    if "k_scales" in case:
        kp = kp * jnp.asarray(case["k_scales"])[:, :, None, None]
    sid = np.maximum(case["slot_ids"], 0)
    tbl = np.maximum(case["block_table"][sid], 0)               # (T, nblk)
    kg = kp[tbl].transpose(0, 2, 1, 3, 4).reshape(len(SID), HKV, -1, D)
    t, h, _ = q.shape
    g = h // HKV
    logits = jnp.einsum("tkgd,tkld->tkgl", q.reshape(t, HKV, g, D), kg)
    logits = logits / float(D) ** 0.5
    logits = logits / jnp.asarray(case["scale"]).reshape(1, HKV, g, 1)
    q_int = jnp.clip(jnp.round(logits), -128., 127.).astype(jnp.int32)
    return np.asarray(q_int).reshape(t, h, -1)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
@pytest.mark.parametrize("inputs", ["exact", "random"])
def test_packed_prefill_matches_jax_kernel(inputs, mode, static_max, pool,
                                           group):
    exact = inputs == "exact"
    seed = zlib.crc32(repr((mode, static_max, pool, group, exact)).encode())
    case = _case(seed, group, pool, exact)
    kw = dict(mode=mode, static_max=static_max)
    want = _jax(case, pool, **kw)
    args = _torch_args(case, pool)
    got = hccs_packed_prefill(**args, **kw).numpy()
    qi, valid = packed_qint(args["q"], args["k_pool"], args["block_table"],
                            args["slot_ids"], args["lengths"], args["scale"],
                            args["k_scales"])
    live = np.broadcast_to(valid.numpy()[:, None, :], qi.shape)
    flipped = (qi.numpy() != _jax_qint(case, pool)) & live
    assert live.sum() > 0
    # pad lanes and the zero-length row return exact zeros
    np.testing.assert_array_equal(got[[6, 8, 9]], 0.0)
    np.testing.assert_array_equal(want[[6, 8, 9]], 0.0)
    if exact:
        assert not flipped.any()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        clean = ~flipped.any(-1)                    # (T, H) rows, no flip
        print(f"{int(flipped.sum())} flipped bins of {int(live.sum())}, "
              f"max |d| {np.abs(got - want)[clean].max():.2e}")
        assert flipped.sum() <= MAX_FLIPS
        np.testing.assert_allclose(got[clean], want[clean], rtol=0,
                                   atol=RANDOM_ATOL)


def test_packed_prefill_causality_and_sentinels():
    """Poisoning KV past a token's frontier, in the sentinel-skipped block
    and in blocks no table owns changes no output that cannot see them."""
    case = _case(0, 2, "f32", exact=False)
    args = _torch_args(case, "f32")
    base = hccs_packed_prefill(**args)
    kp = args["k_pool"].clone()
    vp = args["v_pool"].clone()
    tbl = case["block_table"]
    owned = set(tbl[tbl >= 0].tolist())
    for blk in set(range(N_BLOCKS)) - owned:
        kp[blk], vp[blk] = 1e6, -1e6              # unowned + trash block
    kp[tbl[0, 4], :, 39 - 4 * BS:] = 1e6          # slot 0 rows 39.. only
    vp[tbl[0, 4], :, 39 - 4 * BS:] = 1e6
    args.update(k_pool=kp, v_pool=vp)
    poisoned = hccs_packed_prefill(**args)
    np.testing.assert_array_equal(poisoned[:4].numpy(), base[:4].numpy())
    np.testing.assert_array_equal(poisoned[5:].numpy(), base[5:].numpy())
    assert (poisoned[4] - base[4]).abs().max() > 0  # frontier 40 sees row 39
