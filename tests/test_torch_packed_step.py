"""Property tests for the port's packed-token-step packer
(repro_torch/serve/paged.py), twin of tests/test_packed_step.py, the drafts
contract included; every drawn state also holds the port's schedule, lane
packing and write targets equal to the JAX package's.

The packer is the host half of the token-centric chunked-prefill path: it
turns per-slot progress into a ragged (token, slot_id, position) batch padded
to a fixed budget. These properties pin the contract the device step relies
on: budget respected, every live slot scheduled, contiguous per-slot
segments/positions, and no cross-slot leakage — a token's write position only
ever lands in a block its OWN slot's table row owns, and its causal frontier
never reaches past its own segment.

Needs hypothesis (skips cleanly without it, like the allocator suite).
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np

from conftest import require_hypothesis

hypothesis = require_hypothesis()
from hypothesis import given, settings          # noqa: E402
from hypothesis import strategies as st         # noqa: E402

from repro.serve import paged as jpaged                    # noqa: E402
from repro_torch.serve.paged import (TRASH_BLOCK,  # noqa: E402
                                     pack_slot_ids, packed_write_positions,
                                     schedule_step_tokens)


@st.composite
def step_states(draw):
    """A random mid-flight engine state: live mask, per-slot prompt tokens
    remaining (0 = decoding), per-slot cache frontiers, a budget that can
    schedule every live slot, and an optional per-slot chunk cap."""
    b = draw(st.integers(1, 8))
    live = np.asarray(draw(st.lists(st.booleans(), min_size=b, max_size=b)))
    remaining = np.asarray(
        draw(st.lists(st.integers(0, 40), min_size=b, max_size=b)),
        np.int64) * live
    lengths = np.asarray(
        draw(st.lists(st.integers(0, 60), min_size=b, max_size=b)), np.int64)
    budget = draw(st.integers(max(int(live.sum()), 1), 64))
    chunk_cap = draw(st.one_of(st.none(), st.integers(1, 64)))
    return live, remaining, lengths, budget, chunk_cap


@settings(max_examples=150, deadline=None)
@given(step_states())
def test_schedule_budget_and_liveness(state):
    live, remaining, _, budget, chunk_cap = state
    t_valid = schedule_step_tokens(live, remaining, budget, chunk_cap)
    np.testing.assert_array_equal(
        t_valid, jpaged.schedule_step_tokens(live, remaining, budget,
                                             chunk_cap))
    # budget respected
    assert int(t_valid.sum()) <= budget
    # every live slot scheduled, every dead slot idle
    assert (t_valid[live] >= 1).all()
    assert (t_valid[~live] == 0).all()
    # decode slots take exactly one lane; prefill slots never overshoot
    # their remaining prompt or the per-slot chunk cap
    decode = live & (remaining == 0)
    assert (t_valid[decode] == 1).all()
    prefill = live & (remaining > 0)
    assert (t_valid[prefill] <= remaining[prefill]).all()
    if chunk_cap is not None:
        assert (t_valid[prefill] <= chunk_cap).all()


@settings(max_examples=150, deadline=None)
@given(step_states())
def test_pack_segments_contiguous(state):
    live, remaining, lengths, budget, chunk_cap = state
    t_valid = schedule_step_tokens(live, remaining, budget, chunk_cap)
    width = budget
    sid, off = pack_slot_ids(t_valid, width)
    for got, want in zip((sid, off), jpaged.pack_slot_ids(t_valid, width)):
        np.testing.assert_array_equal(got, want)
    n = int(t_valid.sum())
    # valid lanes form one contiguous run, pad lanes (-1) are the tail
    assert (sid[:n] >= 0).all() and (sid[n:] == -1).all()
    for slot in np.flatnonzero(t_valid > 0):
        lanes = np.flatnonzero(sid == slot)
        # each slot's segment is contiguous at its offset, with its count
        assert len(lanes) == int(t_valid[slot])
        assert lanes[0] == int(off[slot])
        assert (np.diff(lanes) == 1).all()
        # positions are contiguous per slot: lengths[s] + 0..tv-1 — so the
        # per-token causal frontier (position + 1) never reaches past the
        # slot's own segment end (no intra-chunk future leakage)
        positions = lengths[slot] + np.arange(len(lanes))
        assert (positions + 1 <= lengths[slot] + t_valid[slot]).all()


@settings(max_examples=150, deadline=None)
@given(step_states())
def test_write_positions_no_cross_slot_leakage(state):
    live, remaining, lengths, budget, chunk_cap = state
    t_valid = schedule_step_tokens(live, remaining, budget, chunk_cap)
    width = budget
    sid, off = pack_slot_ids(t_valid, width)
    # give every slot its own disjoint block ids, covering the write range
    bs = 8
    b = len(t_valid)
    nblk = int((lengths + t_valid).max() + bs) // bs + 1
    tables = np.arange(1, 1 + b * nblk, dtype=np.int32).reshape(b, nblk)
    wp = packed_write_positions(t_valid, off, tables, lengths, bs, width)
    np.testing.assert_array_equal(
        wp, jpaged.packed_write_positions(t_valid, off, tables, lengths, bs,
                                          width))
    for lane in range(width):
        slot = int(sid[lane])
        blk = int(wp[lane]) // bs
        if slot < 0:
            # pad lanes only ever scatter into the trash block
            assert blk == TRASH_BLOCK
            continue
        # a token's KV bytes land ONLY in a block owned by its own slot's
        # table row — cross-slot leakage is structurally impossible
        assert blk in tables[slot]
        # and at exactly its logical position
        i = lane - int(off[slot])
        gpos = int(lengths[slot]) + i
        assert blk == tables[slot, gpos // bs]
        assert int(wp[lane]) % bs == gpos % bs


@st.composite
def spec_step_states(draw):
    """A step state plus per-slot draft proposals (speculative decoding):
    drafts are drawn for EVERY slot — the scheduler must ignore them on
    prefilling and dead slots (only decode slots verify drafts)."""
    state = draw(step_states())
    b = len(state[0])
    drafts = np.asarray(
        draw(st.lists(st.integers(0, 6), min_size=b, max_size=b)), np.int64)
    return state, drafts


@settings(max_examples=150, deadline=None)
@given(spec_step_states())
def test_schedule_drafts_contract(state_and_drafts):
    """Speculative draft lanes ride the same packer contract: budget and
    chunk cap still bind, every live slot still gets its guaranteed lane,
    draft lanes go ONLY to decode slots, and the leftover budget is dealt
    to decode drafts FIRST (slot order), prefill chunks after."""
    (live, remaining, _, budget, chunk_cap), drafts = state_and_drafts
    t_valid = schedule_step_tokens(live, remaining, budget, chunk_cap,
                                   drafts=drafts)
    np.testing.assert_array_equal(
        t_valid, jpaged.schedule_step_tokens(live, remaining, budget,
                                             chunk_cap, drafts=drafts))
    cap = chunk_cap if chunk_cap is not None else budget
    assert int(t_valid.sum()) <= budget
    assert (t_valid[live] >= 1).all()
    assert (t_valid[~live] == 0).all()
    # decode slots: one committed lane + at most min(drafts, cap-1) draft
    # lanes; prefill slots never read the drafts array at all
    decode = live & (remaining == 0)
    assert (t_valid[decode] <= 1 + np.minimum(drafts[decode],
                                              max(cap, 1) - 1)).all()
    prefill = live & (remaining > 0)
    assert (t_valid[prefill] <= remaining[prefill]).all()
    assert (t_valid[prefill] <= max(cap, 1)).all()
    # drafts-first priority: any prefill slot holding extra lanes means
    # every drafting decode slot already took its full draft allotment
    if (t_valid[prefill] > 1).any():
        want = 1 + np.minimum(drafts[decode], max(cap, 1) - 1)
        assert (t_valid[decode] == want).all()
    # FIFO among drafting decode slots: a later slot only gets draft lanes
    # after every earlier one is maxed out
    drafting = np.flatnonzero(decode & (drafts > 0))
    for a, b_ in zip(drafting, drafting[1:]):
        if t_valid[b_] > 1:
            assert t_valid[a] == 1 + min(int(drafts[a]), max(cap, 1) - 1)
    # all-zero drafts is EXACTLY the pinned non-speculative layout
    base = schedule_step_tokens(live, remaining, budget, chunk_cap)
    spec0 = schedule_step_tokens(live, remaining, budget, chunk_cap,
                                 drafts=np.zeros_like(drafts))
    assert (base == spec0).all()


@settings(max_examples=80, deadline=None)
@given(step_states())
def test_schedule_is_greedy_fifo(state):
    """Leftover budget is dealt to prefilling slots in slot order: a later
    prefilling slot only gets more than its single guaranteed lane after
    every earlier one is either fully scheduled (up to the chunk cap) or
    the budget ran dry."""
    live, remaining, _, budget, chunk_cap = state
    t_valid = schedule_step_tokens(live, remaining, budget, chunk_cap)
    cap = chunk_cap if chunk_cap is not None else budget
    prefill = np.flatnonzero(live & (remaining > 0))
    for a, b_ in zip(prefill, prefill[1:]):
        if t_valid[b_] > 1:
            assert t_valid[a] == min(remaining[a], max(cap, 1))
