"""Property tests of the port's refcounted block allocator
(`repro_torch/serve/paged.py` BlockAllocator): the twin of
tests/test_paged_alloc.py. Every trace also drives the JAX package's
allocator, which must return the same blocks and hold the same free list
and refcounts after every operation.

Invariants under arbitrary alloc/fork/free interleavings: conservation
(free + unique live == num_blocks - 1), no aliasing except through fork,
last-free-returns, double/foreign free and trash-block guards, exhaustion
raising without mutating state.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest
from conftest import require_hypothesis

hypothesis = require_hypothesis()

import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.serve.paged import BlockAllocator as JAlloc  # noqa: E402
from repro_torch.serve.paged import (TRASH_BLOCK,  # noqa: E402
                                     BlockAllocator, BlockPoolExhausted)


def _same(a, j):
    assert a._free == j._free and a._ref == j._ref


@st.composite
def alloc_fork_free_trace(draw):
    num_blocks = draw(st.integers(2, 24))
    n_holders = draw(st.integers(1, 6))
    ops = draw(st.lists(
        st.tuples(st.sampled_from(["alloc", "fork", "free_all", "free_one"]),
                  st.integers(0, n_holders - 1),
                  st.integers(0, n_holders - 1)),
        max_size=100))
    return num_blocks, ops


@given(alloc_fork_free_trace())
@settings(max_examples=300, deadline=None)
def test_refcount_conservation_and_no_aliasing(trace):
    num_blocks, ops = trace
    alloc, jalloc = BlockAllocator(num_blocks), JAlloc(num_blocks)
    held: dict[int, list] = {}
    for op, holder, other in ops:
        if op == "alloc":
            try:
                blk = alloc.alloc()
            except BlockPoolExhausted:
                assert alloc.num_free == 0
                continue
            assert blk == jalloc.alloc()
            assert blk != TRASH_BLOCK and 0 < blk < num_blocks
            for refs in held.values():
                assert blk not in refs
            assert alloc.ref(blk) == 1
            held.setdefault(holder, []).append(blk)
        elif op == "fork":
            src_refs = held.get(other)
            if not src_refs:
                with pytest.raises(ValueError):
                    alloc.fork(num_blocks)
                continue
            blk = alloc.fork(src_refs[-1])
            assert blk == jalloc.fork(src_refs[-1]) == src_refs[-1]
            held.setdefault(holder, []).append(blk)
        elif op == "free_all":
            refs = held.pop(holder, [])
            alloc.free(refs)
            jalloc.free(refs)
        else:
            refs = held.get(holder)
            if refs:
                blk = refs.pop()
                alloc.free([blk])
                jalloc.free([blk])
        _same(alloc, jalloc)
        live = set()
        for refs in held.values():
            live.update(refs)
        for blk in live:
            assert alloc.ref(blk) == sum(r.count(blk) for r in held.values())
        assert alloc.num_free + len(live) == num_blocks - 1
        assert alloc.num_live == len(live)


@given(st.integers(2, 16))
@settings(max_examples=50, deadline=None)
def test_exhaustion_raises_before_corruption(num_blocks):
    alloc = BlockAllocator(num_blocks)
    got = [alloc.alloc() for _ in range(num_blocks - 1)]
    assert sorted(got) == list(range(1, num_blocks))
    with pytest.raises(BlockPoolExhausted):
        alloc.alloc()
    assert alloc.num_free == 0
    alloc.free([got[0]])
    assert alloc.alloc() == got[0]


@given(st.integers(2, 16), st.integers(1, 4))
@settings(max_examples=50, deadline=None)
def test_forked_block_survives_until_last_free(num_blocks, n_forks):
    alloc = BlockAllocator(num_blocks)
    blk = alloc.alloc()
    for _ in range(n_forks):
        assert alloc.fork(blk) == blk
    assert alloc.ref(blk) == n_forks + 1
    for i in range(n_forks):
        alloc.free([blk])
        assert alloc.ref(blk) == n_forks - i
        assert blk not in alloc._free
    alloc.free([blk])
    assert alloc.ref(blk) == 0 and alloc.num_free == num_blocks - 1


@given(st.integers(2, 16))
@settings(max_examples=50, deadline=None)
def test_double_free_foreign_free_and_trash_guards(num_blocks):
    alloc = BlockAllocator(num_blocks)
    blk = alloc.alloc()
    alloc.free([blk])
    with pytest.raises(ValueError):
        alloc.free([blk])
    with pytest.raises(ValueError):
        alloc.free([TRASH_BLOCK])
    with pytest.raises(ValueError):
        alloc.fork(TRASH_BLOCK)
    with pytest.raises(ValueError):
        alloc.fork(blk)
    assert alloc.num_free == num_blocks - 1 and alloc.num_live == 0
