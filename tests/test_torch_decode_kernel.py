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
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import functools
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref as REF
from repro_torch.core.hccs import hccs_mode_inv
from repro_torch.kernels.decode import (NEG_BIG, decode_qint, hccs_decode,
                                        hccs_packed_prefill,
                                        hccs_paged_decode, packed_qint,
                                        paged_qint, sm_denom)

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


# ------------------------------------------- the split-KV sweep (emulated) --
#
# `hccs_decode` and `hccs_packed_prefill` run on the card as the split-KV
# sweep of csrc/hccs_split.cuh, which the CPU cannot run. `_split_sweep`
# emulates its passes in numpy — per (row, head) the logit as one
# sequential fmaf chain, q_int at the live keys, the split maxima (NEG_BIG
# for a split with no live key), m from them (127 under static_max), the
# per-split int Z and f32 s @ V partials in key order, their sum in split
# order, Stage 5 — and is held against the JAX kernels in interpret mode at
# split lengths of 8, 12, 32 and 64 keys over 8-key pool blocks (12 puts
# split boundaries inside blocks). Every case has rows at frontiers
# split - 1, split and split + 1 of each split length, rows of length 0
# and 1, and a long row; the arena is 137 rows (no multiple of any split)
# with stale rows past every frontier; the packed case has sentinel blocks
# inside the long frontier (one of them a whole 8-key split) and pad lanes;
# the paged case gives each frontier a slot of its own, with sentinel
# blocks inside the 133- and 65-key frontiers.
# Exact inputs must be bit-identical; random inputs are held to the gates
# above (MAX_FLIPS, RANDOM_ATOL). On exact inputs every sum is exact in any
# order, so the emulation must equal the port's plain version bit for bit,
# as the CUDA kernel must on the card, and have the JAX kernel's q_int;
# against the JAX output it is held to rtol 1e-6 as in (a): under jit, XLA
# evaluates the reference's i16_div Stage 5 one ulp off the IEEE quotient
# at Z = 14, 28, 37, 47, 56 and 61 (of Z < 40000), which these rows reach.
# Measured on the 120 random arena and packed cases: 0 flipped bins of
# 209,184 live logits, max |d| 1.8e-7 against the JAX kernels; on the 72
# random paged cases 0 of 131,904, max |d| 3.0e-7.

SPLITS = (8, 12, 32, 64)
SPLIT_FRONTS = [7, 8, 9, 11, 12, 13, 31, 32, 33, 63, 64, 65, 0, 1, 133]
SPLIT_TMAX = 137


def _fma_f32(a, b, c):
    """fmaf(a, b, c) in f32: the f32 product is exact in f64, and the sum
    rounds once to f32 (double rounding aside, which these inputs never
    meet)."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def _split_sweep(q, kg, vg, valid, scale, theta, mode, static_max, split):
    """The split-KV sweep's three passes on gathered keys: q (R, H, d) f32;
    kg, vg (R, Hkv, L, d) f32, dequantized; valid (R, L) the live keys.
    Returns the output (R, H, d) f32 and q_int (R, H, L), NEG_BIG at dead
    keys."""
    r, h, d = q.shape
    hkv, length = kg.shape[1], kg.shape[2]
    g = h // hkv
    nsplit = -(-length // split)
    live = valid[:, None, :]
    # pass 1: one fmaf chain per (row, head, key), q_int, split maxima
    qg = np.repeat(q.reshape(r, hkv, g, 1, d), 1, 0)
    kk = kg[:, :, None]                                   # (R, Hkv, 1, L, d)
    dot = np.zeros((r, hkv, g, length), np.float32)
    for c in range(d):
        dot = _fma_f32(qg[..., c], kk[..., c], dot)
    logits = dot.reshape(r, h, length) / np.float32(sm_denom(d))
    logits = logits / scale[None, :, None]
    q_int = np.where(live, np.clip(np.rint(logits), -128, 127), NEG_BIG)
    q_int = q_int.astype(np.int64)
    smax = np.stack([q_int[..., i * split:(i + 1) * split].max(-1)
                     for i in range(nsplit)], -1)          # (R, H, nsplit)
    # pass 2: m, the per-split partial Z (int) and s @ V (f32, key order)
    m = (np.full((r, h, 1), 127) if static_max
         else smax.max(-1, keepdims=True))
    b_, s_, d_ = (theta[:, i].astype(np.int64)[None, :, None]
                  for i in range(3))
    sc = np.where(live, b_ - s_ * np.minimum(m - q_int, d_), 0)
    v = np.repeat(vg, g, axis=1)                          # (R, H, L, d)
    z_part, acc_part = [], []
    for i in range(nsplit):
        acc = np.zeros((r, h, d), np.float32)
        for j in range(i * split, min((i + 1) * split, length)):
            on = live[:, :, j, None]
            acc = np.where(on, _fma_f32(sc[:, :, j, None].astype(np.float32),
                                        v[:, :, j], acc), acc)
        z_part.append(sc[..., i * split:(i + 1) * split].sum(-1))
        acc_part.append(acc)
    # pass 3: the partials in split order, then Stage 5
    acc = np.zeros((r, h, d), np.float32)
    for part in acc_part:
        acc = acc + part
    z = np.maximum(np.sum(z_part, 0).astype(np.float32), 1.0)
    inv = hccs_mode_inv(torch.from_numpy(z), mode).numpy()[..., None]
    return (acc * inv).astype(np.float32), q_int


def _split_rng(kind, pool, exact):
    return np.random.default_rng(zlib.crc32(repr((
        "split", kind, pool, exact)).encode()))


@functools.lru_cache(maxsize=None)
def _split_case(kind, pool, exact):
    """The shared case of every split length (see the section comment):
    kind "arena" — one slot per frontier of SPLIT_FRONTS in a
    (15, Hkv, SPLIT_TMAX, d) arena — "packed" — one token per frontier,
    all owned by slot 0 (the length-0 row by slot 2, the length-1 row by
    slot 1), two pad lanes, slot 0's blocks 1 and 9 sentinels — or
    "paged" — one slot per frontier, each with blocks of its own from a
    shuffled pool, sentinels past every frontier and inside three (the
    133-key row's blocks 1 and 9, the 65-key row's block 4)."""
    rng = _split_rng(kind, pool, exact)
    h = 2 * HKV
    n = len(SPLIT_FRONTS)
    nblk = -(-max(SPLIT_FRONTS) // BS) + 1
    if kind == "arena":
        shape = (n, HKV, SPLIT_TMAX, D)
        rows = n
    elif kind == "packed":
        n_blocks = nblk + 4
        shape = (n_blocks, HKV, BS, D)
        rows = n + 2
    else:
        n_blocks = sum(-(-f // BS) for f in SPLIT_FRONTS) + 4
        shape = (n_blocks, HKV, BS, D)
        rows = n
    if exact:
        q = rng.integers(-8, 9, (rows, h, D)) / 8.0
        k = rng.integers(-8, 9, shape) / 8.0
        v = rng.integers(-8, 9, shape) / 8.0
        scale = rng.uniform(0.015, 0.03, h)
    else:
        q = rng.normal(0, 1, (rows, h, D))
        k = rng.normal(0, 1, shape)
        v = rng.normal(0, 1, shape)
        scale = rng.uniform(0.01, 0.04, h)
    theta = np.stack([rng.integers(120, 200, h), rng.integers(0, 2, h),
                      rng.integers(16, 100, h)], -1).astype(np.int32)
    case = dict(q=q.astype(np.float32), scale=scale.astype(np.float32),
                theta=theta)
    if kind == "arena":
        case.update(k=k.astype(np.float32), v=v.astype(np.float32),
                    lengths=np.asarray(SPLIT_FRONTS, np.int32))
        return case
    blocks = rng.permutation(np.arange(1, n_blocks))
    if kind == "packed":
        sid = [1 if f == 1 else 2 if f == 0 else 0 for f in SPLIT_FRONTS]
        table = np.full((3, nblk), -1, np.int32)
        table[0, :nblk - 1] = blocks[:nblk - 1]
        table[0, [1, 9]] = -1                 # sentinels inside frontiers
        table[1, 0] = blocks[nblk - 1]
        case.update(block_table=table,
                    slot_ids=np.asarray(sid + [-1, -1], np.int32),
                    lengths=np.asarray(SPLIT_FRONTS + [0, 0], np.int32))
    else:
        table = np.full((n, nblk), -1, np.int32)
        c = 0
        for s_, f in enumerate(SPLIT_FRONTS):
            nb = -(-f // BS)
            table[s_, :nb] = blocks[c:c + nb]
            c += nb
        table[SPLIT_FRONTS.index(133), [1, 9]] = -1
        table[SPLIT_FRONTS.index(65), 4] = -1
        case.update(block_table=table,
                    lengths=np.asarray(SPLIT_FRONTS, np.int32))
    if pool == "int8":
        sc = (np.full((n_blocks, HKV), 0.125) if exact
              else rng.uniform(0.05, 0.2, (n_blocks, HKV)))
        case.update(k_pool=np.clip(np.round(k * 8), -127, 127)
                    .astype(np.int8),
                    v_pool=np.clip(np.round(v * 8), -127, 127)
                    .astype(np.int8),
                    k_scales=sc.astype(np.float32),
                    v_scales=sc[::-1].astype(np.float32).copy())
    else:
        case.update(k_pool=k.astype(np.float32), v_pool=v.astype(np.float32))
    return case


@functools.lru_cache(maxsize=None)
def _split_want(kind, pool, exact, mode, static_max):
    """The JAX kernel's output and quantized logits on the shared case, and
    the port's plain version's output."""
    case = _split_case(kind, pool, exact)
    j, t = _as(case, pool, "jax"), _as(case, pool, "torch")
    kw = dict(mode=mode, static_max=static_max)
    if kind == "arena":
        out = ops.hccs_decode(j["q"], j["k"], j["v"], j["lengths"],
                              j["scale"], j["theta"], **kw)
        jq = _jax_qint_of(case["q"], j["k"].astype(jnp.float32),
                          case["scale"])
        plain = hccs_decode(t["q"], t["k"], t["v"], t["lengths"],
                            t["scale"], t["theta"], **kw)
    elif kind == "packed":
        out = ops.hccs_packed_prefill(
            j["q"], j["k_pool"], j["v_pool"], j["block_table"],
            j["slot_ids"], j["lengths"], j["scale"], j["theta"],
            k_scales=j.get("k_scales"), v_scales=j.get("v_scales"), **kw)
        plain = hccs_packed_prefill(
            t["q"], t["k_pool"], t["v_pool"], t["block_table"],
            t["slot_ids"], t["lengths"], t["scale"], t["theta"],
            k_scales=t.get("k_scales"), v_scales=t.get("v_scales"), **kw)
    else:
        out = ops.hccs_paged_decode(
            j["q"], j["k_pool"], j["v_pool"], j["block_table"],
            j["lengths"], j["scale"], j["theta"],
            k_scales=j.get("k_scales"), v_scales=j.get("v_scales"), **kw)
        plain = hccs_paged_decode(
            t["q"], t["k_pool"], t["v_pool"], t["block_table"],
            t["lengths"], t["scale"], t["theta"],
            k_scales=t.get("k_scales"), v_scales=t.get("v_scales"), **kw)
    if kind != "arena":
        kp = dict(case, k_pool=np.asarray(j["k_pool"].astype(jnp.float32)))
        jq = _jax_qint(kp, "int8" if pool == "int8" else "f32")
    return np.asarray(out), jq, plain.numpy()


def _split_inputs(kind, pool, exact):
    """The case's gathered f32 keys and values (R, Hkv, L, d) and live keys
    (R, L), exactly as the kernels read them."""
    case = _split_case(kind, pool, exact)
    t = _as(case, pool, "torch")
    if kind == "arena":
        cols = np.arange(SPLIT_TMAX)
        valid = cols[None, :] < case["lengths"][:, None]
        return t["k"].float().numpy(), t["v"].float().numpy(), valid
    if kind == "packed":
        _, valid = packed_qint(t["q"], t["k_pool"], t["block_table"],
                               t["slot_ids"], t["lengths"], t["scale"],
                               t.get("k_scales"))
        sid = case["slot_ids"]
    else:
        _, valid = paged_qint(t["q"], t["k_pool"], t["block_table"],
                              t["lengths"], t["scale"], t.get("k_scales"))
        sid = np.arange(len(case["q"]))
    tbl = torch.from_numpy(np.maximum(case["block_table"][np.maximum(sid, 0)],
                                      0)).long()
    r, nblk = tbl.shape

    def gather(pool_, scales):
        g = pool_[tbl].float()
        if scales is not None:
            g = g * scales[tbl][..., None, None]
        return g.permute(0, 2, 1, 3, 4).reshape(r, HKV, nblk * BS, D)
    return (gather(t["k_pool"], t.get("k_scales")).numpy(),
            gather(t["v_pool"], t.get("v_scales")).numpy(), valid.numpy())


def _check_split(kind, pool, inputs, mode, static_max, split):
    exact = inputs == "exact"
    case = _split_case(kind, pool, exact)
    want, jq, plain = _split_want(kind, pool, exact, mode, static_max)
    kg, vg, valid = _split_inputs(kind, pool, exact)
    got, qi = _split_sweep(case["q"], kg, vg, valid, case["scale"],
                           case["theta"], mode, static_max, split)
    live = np.broadcast_to(valid[:, None, :], qi.shape)
    flipped = (qi != jq) & live
    assert live.sum() > 0
    empty = np.flatnonzero(~valid.any(-1))
    assert len(empty) >= 1
    np.testing.assert_array_equal(got[empty], 0.0)
    np.testing.assert_array_equal(want[empty], 0.0)
    if exact:
        assert not flipped.any()
        np.testing.assert_array_equal(got, plain)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    else:
        clean = ~flipped.any(-1)
        assert flipped.sum() <= MAX_FLIPS
        np.testing.assert_allclose(got[clean], want[clean], rtol=0,
                                   atol=RANDOM_ATOL)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("kv", ["f32", "bf16"])
@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
@pytest.mark.parametrize("inputs", ["exact", "random"])
def test_split_sweep_matches_jax_decode_kernel(inputs, mode, static_max, kv,
                                               split):
    _check_split("arena", kv, inputs, mode, static_max, split)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
@pytest.mark.parametrize("inputs", ["exact", "random"])
def test_split_sweep_matches_jax_packed_kernel(inputs, mode, static_max,
                                               pool, split):
    _check_split("packed", pool, inputs, mode, static_max, split)


@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("static_max", [False, True])
@pytest.mark.parametrize("mode", ["wide", "i16_div", "i16_clb"])
@pytest.mark.parametrize("inputs", ["exact", "random"])
def test_split_sweep_matches_jax_paged_kernel(inputs, mode, static_max,
                                              pool, split):
    _check_split("paged", pool, inputs, mode, static_max, split)
