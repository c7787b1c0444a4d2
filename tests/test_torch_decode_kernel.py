"""The port's single-query kernels — `hccs_packed_prefill`,
`hccs_paged_decode` and `hccs_decode`, each its plain PyTorch version on CPU
tensors — against the JAX Pallas kernels (interpret mode on the CPU) and
the `repro/kernels/ref.py` oracles.

Every packed case has a prefill chunk at successive frontiers (causality
inside a chunk), decode lanes, a zero-length row, pad lanes, sentinel table
entries past and inside a frontier, and a shuffled pool. Every decode case
has four slots: one frontier cut inside a block, one zero-length row, a
sentinel entry inside a frontier (paged) or stale rows past the frontiers
of an arena whose length is no multiple of any tile (arena).

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
from repro.kernels import ref as REF
from repro_torch.kernels.decode import (decode_qint, hccs_decode,
                                        hccs_packed_prefill,
                                        hccs_paged_decode, packed_qint,
                                        paged_qint)

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
    kp = jnp.asarray(case["k_pool"])
    if pool == "bf16":
        kp = kp.astype(jnp.bfloat16)
    kp = kp.astype(jnp.float32)
    if "k_scales" in case:
        kp = kp * jnp.asarray(case["k_scales"])[:, :, None, None]
    rows = case.get("slot_ids", np.arange(len(case["q"])))
    tbl = np.maximum(case["block_table"][np.maximum(rows, 0)], 0)
    kg = kp[tbl].transpose(0, 2, 1, 3, 4).reshape(len(rows), HKV, -1, D)
    return _jax_qint_of(case["q"], kg, case["scale"])


def _jax_qint_of(q, kg, scale):
    """The quantized logits of queries (R, H, d) against keys
    (R, Hkv, L, d), with the JAX kernel's jnp ops."""
    q = jnp.asarray(q)
    kg = jnp.asarray(kg, jnp.float32)
    t, h, _ = q.shape
    g = h // HKV
    logits = jnp.einsum("tkgd,tkld->tkgl", q.reshape(t, HKV, g, D), kg)
    logits = logits / float(D) ** 0.5
    logits = logits / jnp.asarray(scale).reshape(1, HKV, g, 1)
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


# ------------------------------------------------- hccs_paged_decode / arena --

DEC_LENS = [40, 13, 0, 17]        # slot 0 cut mid-block, slot 2 empty
TMAX = 45                         # arena rows: no multiple of any tile


def _decode_case(seed, kind, pool, exact, inner_sentinel=True):
    """Four slots, one query each (GQA group 2): a paged pool + table
    (shuffled blocks, sentinels past every frontier and, with
    `inner_sentinel`, one inside slot 0's) or a (4, Hkv, TMAX, d) arena
    whose rows past each frontier hold stale values; slot 3 of the arena
    is filled to its last row."""
    rng = np.random.default_rng(seed)
    h = 2 * HKV
    lens = list(DEC_LENS) if kind == "paged" else DEC_LENS[:3] + [TMAX]
    shape = ((N_BLOCKS, HKV, BS, D) if kind == "paged"
             else (len(lens), HKV, TMAX, D))
    if exact:
        q = rng.integers(-8, 9, (len(lens), h, D)) / 8.0
        k = rng.integers(-8, 9, shape) / 8.0
        v = rng.integers(-8, 9, shape) / 8.0
        scale = rng.uniform(0.015, 0.03, h)
    else:
        q = rng.normal(0, 1, (len(lens), h, D))
        k = rng.normal(0, 1, shape)
        v = rng.normal(0, 1, shape)
        scale = rng.uniform(0.01, 0.04, h)
    theta = np.stack([rng.integers(120, 200, h), rng.integers(0, 2, h),
                      rng.integers(16, 100, h)], -1).astype(np.int32)
    case = dict(q=q.astype(np.float32), lengths=np.asarray(lens, np.int32),
                scale=scale.astype(np.float32), theta=theta)
    if kind == "arena":
        case.update(k=k.astype(np.float32), v=v.astype(np.float32))
        return case
    table = np.full((len(lens), NBLK), -1, np.int32)
    blocks = rng.permutation(np.arange(1, N_BLOCKS))
    table[0, :5] = blocks[:5]                     # 40 tokens
    table[1, :2] = blocks[5:7]                    # 13 tokens
    table[3, :3] = blocks[7:10]                   # 17 tokens
    if inner_sentinel:
        table[0, 2] = -1
    case["block_table"] = table
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


def _as(case, pool, lib):
    """The case as jnp or torch arrays, K/V cast to bf16 for pool bf16."""
    if lib == "jax":
        out = {n: jnp.asarray(a) for n, a in case.items()}
        cast = (lambda a: a.astype(jnp.bfloat16))
    else:
        out = {n: torch.from_numpy(np.ascontiguousarray(a))
               for n, a in case.items()}
        cast = (lambda a: a.to(torch.bfloat16))
    if pool == "bf16":
        for n in ("k_pool", "v_pool", "k", "v"):
            if n in out:
                out[n] = cast(out[n])
    return out


def _check_against(got, want, qi, valid, jq, exact):
    """Exact inputs: identical q_int, outputs within rtol 1e-6. Random
    inputs: flipped bins within MAX_FLIPS, rows without a flip within
    RANDOM_ATOL. Rows of length 0 are exact zeros in both."""
    live = np.broadcast_to(valid.numpy()[:, None, :], qi.shape)
    flipped = (qi.numpy() != jq) & live
    np.testing.assert_array_equal(got[2], 0.0)
    np.testing.assert_array_equal(want[2], 0.0)
    if exact:
        assert not flipped.any()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        clean = ~flipped.any(-1)
        assert flipped.sum() <= MAX_FLIPS
        np.testing.assert_allclose(got[clean], want[clean], rtol=0,
                                   atol=RANDOM_ATOL)


@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
@pytest.mark.parametrize("inputs", ["exact", "random"])
def test_paged_decode_matches_jax_kernel(inputs, mode, static_max, pool):
    exact = inputs == "exact"
    seed = zlib.crc32(repr(("paged", mode, static_max, pool, exact)).encode())
    case = _decode_case(seed, "paged", pool, exact)
    kw = dict(mode=mode, static_max=static_max)
    j = _as(case, pool, "jax")
    want = np.asarray(ops.hccs_paged_decode(
        j["q"], j["k_pool"], j["v_pool"], j["block_table"], j["lengths"],
        j["scale"], j["theta"], k_scales=j.get("k_scales"),
        v_scales=j.get("v_scales"), **kw))
    t = _as(case, pool, "torch")
    got = hccs_paged_decode(t["q"], t["k_pool"], t["v_pool"],
                            t["block_table"], t["lengths"], t["scale"],
                            t["theta"], k_scales=t.get("k_scales"),
                            v_scales=t.get("v_scales"), **kw).numpy()
    qi, valid = paged_qint(t["q"], t["k_pool"], t["block_table"],
                           t["lengths"], t["scale"], t.get("k_scales"))
    bf = pool == "bf16"
    jq = _jax_qint(dict(case, k_pool=np.asarray(
        j["k_pool"].astype(jnp.float32)) if bf else case["k_pool"]), "f32")
    _check_against(got, want, qi, valid, jq, exact)


@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
@pytest.mark.parametrize("inputs", ["exact", "random"])
def test_decode_matches_jax_kernel(inputs, mode, static_max, kv):
    exact = inputs == "exact"
    seed = zlib.crc32(repr(("arena", mode, static_max, kv, exact)).encode())
    case = _decode_case(seed, "arena", kv, exact)
    kw = dict(mode=mode, static_max=static_max)
    j = _as(case, kv, "jax")
    want = np.asarray(ops.hccs_decode(j["q"], j["k"], j["v"], j["lengths"],
                                      j["scale"], j["theta"], **kw))
    t = _as(case, kv, "torch")
    got = hccs_decode(t["q"], t["k"], t["v"], t["lengths"], t["scale"],
                      t["theta"], **kw).numpy()
    qi, valid = decode_qint(t["q"], t["k"], t["lengths"], t["scale"])
    jq = _jax_qint_of(case["q"], j["k"].astype(jnp.float32), case["scale"])
    _check_against(got, want, qi, valid, jq, exact)


@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
def test_decode_plain_versions_match_ref_oracles(mode, static_max):
    """Against `repro/kernels/ref.py` hccs_decode_ref (:50) and
    hccs_paged_decode_ref (:93), on a table that keeps the allocator's
    invariant the paged oracle assumes (sentinels only past a frontier)."""
    kw = dict(mode=mode, static_max=static_max)
    for kind in ("paged", "arena"):
        case = _decode_case(zlib.crc32(repr((kind, mode, static_max))
                                       .encode()), kind, "f32", False,
                            inner_sentinel=False)
        j, t = _as(case, "f32", "jax"), _as(case, "f32", "torch")
        if kind == "paged":
            want = REF.hccs_paged_decode_ref(
                j["q"], j["k_pool"], j["v_pool"], j["block_table"],
                j["lengths"], j["scale"], j["theta"], **kw)
            got = hccs_paged_decode(t["q"], t["k_pool"], t["v_pool"],
                                    t["block_table"], t["lengths"],
                                    t["scale"], t["theta"], **kw)
            qi, valid = paged_qint(t["q"], t["k_pool"], t["block_table"],
                                   t["lengths"], t["scale"])
            jq = _jax_qint(case, "f32")
        else:
            want = REF.hccs_decode_ref(j["q"], j["k"], j["v"], j["lengths"],
                                       j["scale"], j["theta"], **kw)
            got = hccs_decode(t["q"], t["k"], t["v"], t["lengths"],
                              t["scale"], t["theta"], **kw)
            qi, valid = decode_qint(t["q"], t["k"], t["lengths"], t["scale"])
            jq = _jax_qint_of(case["q"], case["k"], case["scale"])
        _check_against(got.numpy(), np.asarray(want), qi, valid, jq, False)


def test_paged_decode_equals_contiguous_within_port():
    """Block-table gather over a shuffled pool equals hccs_decode on the
    contiguous equivalent, bit for bit (twin of
    tests/test_decode_kernel.py:184; the port's identities are exact)."""
    case = _decode_case(11, "paged", "f32", False, inner_sentinel=False)
    t = _as(case, "f32", "torch")
    tbl = t["block_table"].clamp(min=0).long()
    contig = (lambda p: p[tbl].permute(0, 2, 1, 3, 4)
              .reshape(4, HKV, NBLK * BS, D).contiguous())
    for mode in ("wide", "i16_div"):
        got = hccs_paged_decode(t["q"], t["k_pool"], t["v_pool"],
                                t["block_table"], t["lengths"], t["scale"],
                                t["theta"], mode=mode)
        want = hccs_decode(t["q"], contig(t["k_pool"]), contig(t["v_pool"]),
                           t["lengths"], t["scale"], t["theta"], mode=mode)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_packed_equals_paged_decode_per_token_within_port():
    """A packed batch of T tokens equals T single-slot paged-decode rows
    through table[slot_ids], bit for bit (twin of
    tests/test_decode_kernel.py:242)."""
    case = _case(5, 2, "f32", exact=False)
    args = _torch_args(case, "f32")
    sid = args["slot_ids"]
    live = sid >= 0
    got = hccs_packed_prefill(**args)[live]
    want = hccs_paged_decode(
        args["q"][live], args["k_pool"], args["v_pool"],
        args["block_table"][sid[live].long()].contiguous(),
        args["lengths"][live].contiguous(), args["scale"], args["theta"])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("kind", ["paged", "arena"])
def test_decode_never_reads_dead_keys(kind):
    """Poisoning every key no slot may see — rows past each frontier, the
    block behind slot 0's inner sentinel, blocks no table owns and the
    trash block — changes no output."""
    case = _decode_case(3, kind, "f32", False)
    t = _as(case, "f32", "torch")
    if kind == "arena":
        fn = (lambda k, v: hccs_decode(t["q"], k, v, t["lengths"],
                                       t["scale"], t["theta"]))
        k, v = t["k"].clone(), t["v"].clone()
        for s, n in enumerate(case["lengths"]):
            k[s, :, n:], v[s, :, n:] = 1e6, -1e6
    else:
        fn = (lambda k, v: hccs_paged_decode(
            t["q"], k, v, t["block_table"], t["lengths"], t["scale"],
            t["theta"]))
        k, v = t["k_pool"].clone(), t["v_pool"].clone()
        tbl = case["block_table"]
        owned = set(tbl[tbl >= 0].tolist())
        for blk in set(range(N_BLOCKS)) - owned:
            k[blk], v[blk] = 1e6, -1e6
        k[tbl[0, 4], :, 40 - 4 * BS:] = 1e6       # slot 0 past row 40
        k[tbl[3, 2], :, 17 - 2 * BS:] = 1e6       # slot 3 past row 17
    base = fn(t.get("k", t.get("k_pool")), t.get("v", t.get("v_pool")))
    np.testing.assert_array_equal(fn(k, v).numpy(), base.numpy())
