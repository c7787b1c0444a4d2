"""The port's paged serving against the JAX package's.

(a) Host half: the allocator, the packed-step scheduler, the lane packer and
    the write targets are copies of the JAX numpy code; on the same seeded
    inputs they must return exactly what the JAX ones return.
(b) End to end: the JAX PagedEngine (packed steps, decode_kernel on, Pallas
    in interpret mode) and the port's PagedEngine on the CPU serve the same
    requests with the same weights. Step counts, the block tables after
    every step and the greedy tokens must be identical.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import copy
import dataclasses

import jax
import numpy as np
import pytest

from repro.models import model as JM
from repro.serve import paged as JP
from repro.serve.engine import Request as JRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode import SPLIT_SWEEP_TOKENS, tile_tokens
from repro_torch.models import model as M
from repro_torch.serve import paged as PP
from repro_torch.serve.engine import Request as PRequest


def _both(fn_name, *args, **kw):
    """Call a host function of both packages; equal results or equal
    exception types."""
    out = []
    for mod in (JP, PP):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kw)))
        except (ValueError, RuntimeError) as e:
            out.append(("raise", type(e).__name__))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_block_allocator_matches(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 12))
    allocs = [JP.BlockAllocator(n), PP.BlockAllocator(n)]
    for _ in range(200):
        op = rng.choice(["alloc", "fork", "free", "bad"])
        live = sorted(allocs[0]._ref)
        results = []
        for a in allocs:
            try:
                if op == "alloc":
                    results.append(a.alloc())
                elif op == "fork" and live:
                    results.append(a.fork(live[seed % len(live)]))
                elif op == "free" and live:
                    a.free([live[-1]])
                    results.append(None)
                else:                            # trash / unknown block
                    a.free([int(rng.integers(0, 2)) * (n + 5)])
                    results.append(None)
            except (ValueError, RuntimeError) as e:
                results.append(type(e).__name__)
        assert results[0] == results[1], op
        assert allocs[0]._free == allocs[1]._free
        assert allocs[0]._ref == allocs[1]._ref
        assert allocs[0].num_free == allocs[1].num_free


@pytest.mark.parametrize("seed", range(4))
def test_schedule_and_packing_match(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(50):
        b = int(rng.integers(1, 9))
        bs = int(rng.choice([8, 16, 32]))
        live = rng.random(b) < 0.8
        remaining = np.where(rng.random(b) < 0.5,
                             rng.integers(0, 100, b), 0)
        budget = int(rng.integers(1, 4 * b * 4))
        cap = int(rng.choice([0, bs, 4 * bs]))
        drafts = rng.integers(0, 4, b) if rng.random() < 0.3 else None
        (sj, tj), (sp, tp) = _both("schedule_step_tokens", live, remaining,
                                   budget, cap, drafts=drafts)
        assert sj == sp
        if sj == "raise":
            assert tj == tp
            continue
        np.testing.assert_array_equal(tj, tp)
        width = int(tj.sum()) + int(rng.integers(0, 5))
        (_, (sid_j, off_j)), (_, (sid_p, off_p)) = _both(
            "pack_slot_ids", tj, width)
        np.testing.assert_array_equal(sid_j, sid_p)
        np.testing.assert_array_equal(off_j, off_p)
        lengths = rng.integers(0, 64, b)
        nblk = -(-(64 + int(tj.max())) // bs)
        tables = rng.integers(1, 64, (b, nblk)).astype(np.int32)
        (_, wj), (_, wpp) = _both("packed_write_positions", tj, off_j,
                                  tables, lengths, bs, width)
        assert wj.dtype == wpp.dtype
        np.testing.assert_array_equal(wj, wpp)


@pytest.mark.parametrize("group", [2, 4])
def test_tile_rows_cut_segments_past_the_split_sweep_width(group):
    """The engine's tile counters: each slot's segment in tiles of
    tile_tokens(group) tokens, group rows a token, at a width past
    SPLIT_SWEEP_TOKENS; nothing at a width the split sweep runs."""
    tq = tile_tokens(group)
    t_valid = np.array([tq * 2 + 1, 1, 0, tq, tq - 1, 0])
    wide = SPLIT_SWEEP_TOKENS + 1
    valid, total = PP.tile_rows(t_valid, wide, tq, group)
    assert valid == int(t_valid.sum()) * group
    assert total == (3 + 1 + 1 + 1) * tq * group
    assert PP.tile_rows(t_valid, SPLIT_SWEEP_TOKENS, tq, group) == (0, 0)
    assert PP.tile_rows(np.zeros(4, int), wide, tq, group) == (0, 0)


@pytest.mark.parametrize("kernel,mode", [("fused", "wide"),
                                         ("static_max", "i16_div")])
def test_engine_matches_jax_engine(tiny_cfg, kernel, mode):
    cfg = tiny_cfg(decode_kernel=kernel, hccs_mode=mode)
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    params = JM.init_params(jax.random.PRNGKey(0), cfg)
    pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                device="cpu")
    rng = np.random.default_rng(3)
    reqs = [(uid, rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for uid, (n, m) in enumerate(zip((5, 9, 19, 40), (4, 6, 8, 5)))]
    kw = dict(max_batch=4, max_len=64, block_size=16)
    jeng = JP.PagedEngine(params, cfg, packed=True, **kw)
    peng = PP.PagedEngine(pparams, pcfg, device="cpu", **kw)
    for uid, prompt, m in reqs:
        jeng.submit(JRequest(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
        peng.submit(PRequest(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    outs = [{}, {}]
    while jeng.busy or peng.busy:
        for eng, out in zip((jeng, peng), outs):
            out.update({r.uid: list(r.out_tokens) for r in eng.step()})
        np.testing.assert_array_equal(jeng._tables, peng._tables)
        assert jeng.occupancy_steps == peng.occupancy_steps
    assert outs[0] == outs[1]
    assert sorted(outs[1]) == [0, 1, 2, 3]
    pad = peng.padding_stats()
    assert jeng.padding_stats() == {k: v for k, v in pad.items()
                                    if k not in PP.TILE_STATS}
    # the port alone counts its packed kernel's tile rows: none here, where
    # every step is narrow enough for the split sweep
    assert max(peng._widths) <= SPLIT_SWEEP_TOKENS
    assert pad["tile_rows_valid"] == pad["tile_rows_total"] == 0
    assert pad["lanes_valid"] > 0
    assert jeng.alloc.num_free == peng.alloc.num_free == jeng.num_blocks - 1
    # the same traffic twice through the port: identical (deterministic)
    again = PP.PagedEngine(pparams, pcfg, device="cpu", **kw)
    for uid, prompt, m in copy.deepcopy(reqs):
        again.submit(PRequest(uid=uid, prompt=prompt, max_new_tokens=m))
    assert {r.uid: r.out_tokens for r in again.run()} == outs[1]
