"""Property tests of the port's prefix trie (`repro_torch/serve/paged.py`
PrefixTrie, with its chunk keys `prefix_chunk`): the twin of
tests/test_prefix_trie.py. Every trace of test_trie_matches_exact_model also
drives the JAX package's trie, which must give the same answers and hold the
same index, LRU clock and children after every operation.

The trie is the load-bearing index behind both prompt-prefix sharing and
decode-block (multi-turn) sharing: admission walks it to fork cached KV into
new block tables, registration inserts full blocks at the prefill AND decode
frontiers, and eviction reclaims leaf entries under pool pressure. These
tests drive random insert/fork(hold)/match/evict interleavings against an
EXACT dict model keyed on whole token prefixes:

  * match equivalence: the (parent block id, chunk bytes) trie keying is
    collision-free — it always returns exactly the model's longest cached
    full-block prefix, even when equal chunk CONTENT appears under different
    parents;
  * first-writer-wins insert: an existing key is returned untouched and the
    caller's duplicate block is never indexed;
  * leaf-first LRU eviction: evict_one removes precisely the least-recently-
    touched entry among evictable leaves (no indexed children, no holder
    besides the trie), so every surviving chain stays reachable from the
    root and externally-held (in-flight) blocks are never reclaimed;
  * allocator hygiene: the trie's fork/free bookkeeping keeps the refcounted
    pool conserved at every step, and draining evict_one empties both the
    trie and the pool;
  * generated-block insertion: "decode"-origin entries behave exactly like
    prompt entries for matching, and origin survives first-writer-wins.

The whole module skips cleanly when `hypothesis` is not installed (bare
environments run the deterministic trie coverage in
test_torch_serve_engine.py).
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
from conftest import require_hypothesis

hypothesis = require_hypothesis()

import hypothesis.strategies as st  # noqa: E402
from hypothesis import given, settings  # noqa: E402

from repro.serve.paged import BlockAllocator as JAlloc  # noqa: E402
from repro.serve.paged import PrefixTrie as JTrie  # noqa: E402
from repro_torch.serve.paged import (BlockAllocator,  # noqa: E402
                                     PrefixTrie, prefix_chunk)

BS = 8              # block_size for the suite; chunks are BS-token runs
NUM_BLOCKS = 128    # ample pool: exhaustion is the allocator suite's job


def _tokens(chunk_ids):
    """A token sequence built from a tiny chunk alphabet: chunk i is BS
    copies of token i. Distinct chunk-id tuples give distinct sequences,
    while the same chunk id reappearing at different levels / under
    different parents reproduces the equal-content-different-prefix case
    the (parent, chunk bytes) keying must keep apart."""
    return [c for cid in chunk_ids for c in [cid] * BS]


class TrieModel:
    """Exact reference: maps whole chunk-id prefixes -> block id, with its
    own LRU clock mirroring every touch the trie performs."""

    def __init__(self):
        self.blocks = {}    # chunk-id prefix tuple -> block id
        self.origin = {}    # prefix tuple -> "prompt" | "decode"
        self.stamp = {}     # prefix tuple -> last-touch clock
        self.clock = 0

    def touch(self, prefix):
        self.clock += 1
        self.stamp[prefix] = self.clock

    def longest_match(self, chunk_ids):
        out = []
        for j in range(len(chunk_ids)):
            prefix = tuple(chunk_ids[:j + 1])
            if prefix not in self.blocks:
                break
            out.append(self.blocks[prefix])
        return out

    def leaves(self):
        return [p for p in self.blocks
                if not any(q[:-1] == p for q in self.blocks if len(q) > 1)]

    def remove(self, prefix):
        del self.blocks[prefix]
        del self.origin[prefix]
        del self.stamp[prefix]


@st.composite
def trie_traces(draw):
    """Random interleavings of the operations the engine performs: register
    a sequence's full blocks (with a prompt/decode origin split), match a
    sequence and touch its hits (admission), hold/release an external
    reference on a cached block (a live slot or session mapping it), and
    evict one leaf (pool pressure)."""
    seqs = st.lists(st.integers(0, 3), min_size=1, max_size=4)
    ops = draw(st.lists(
        st.one_of(
            st.tuples(st.just("register"), seqs, st.integers(0, 4)),
            st.tuples(st.just("match"), seqs, st.just(0)),
            st.tuples(st.just("hold"), st.integers(0, 10 ** 6), st.just(0)),
            st.tuples(st.just("release"), st.integers(0, 10 ** 6),
                      st.just(0)),
            st.tuples(st.just("evict"), st.just([]), st.just(0)),
        ),
        min_size=1, max_size=40))
    return ops


def _register(trie, model, alloc, chunk_ids, n_prompt):
    """Emulate one slot's frontier-crossing registration of a sequence whose
    first n_prompt chunks are prompt tokens and the rest generated: for each
    level offer a freshly allocated block (the slot's table entry) and keep
    the slot's own reference until "EOS" at the end — exercising both the
    fork-into-index branch and the first-writer-wins branch."""
    tokens = _tokens(chunk_ids)
    held = []
    parent = -1
    for j, _ in enumerate(chunk_ids):
        prefix = tuple(chunk_ids[:j + 1])
        origin = "prompt" if j < n_prompt else "decode"
        candidate = alloc.alloc()
        held.append(candidate)
        got = trie.insert(parent, prefix_chunk(tokens, j, BS), candidate,
                          origin)
        if prefix in model.blocks:
            # first-writer-wins: the existing entry is returned and touched,
            # the candidate (this slot's duplicate) is NOT indexed
            assert got == model.blocks[prefix]
            assert trie.origin((parent, prefix_chunk(tokens, j, BS))) \
                == model.origin[prefix]
        else:
            assert got == candidate
            model.blocks[prefix] = candidate
            model.origin[prefix] = origin
        model.touch(prefix)
        parent = got
    alloc.free(held)                       # free-at-EOS drops the slot refs


@given(trie_traces())
@settings(max_examples=200, deadline=None)
def test_trie_matches_exact_model(ops):
    alloc = BlockAllocator(NUM_BLOCKS)
    trie = PrefixTrie(alloc, BS)
    model = TrieModel()
    jalloc = JAlloc(NUM_BLOCKS)
    jtrie = JTrie(jalloc, BS)
    held = {}                              # block -> external hold count
    for op, arg, extra in ops:
        _mirror(jtrie, jalloc, op, arg, extra, model, held)
        if op == "register":
            _register(trie, model, alloc, arg, extra)
        elif op == "match":
            got = [blk for _, blk in trie.match(_tokens(arg))]
            assert got == model.longest_match(arg)
            # admission touches the keys it maps — mirror in the model
            for key, _ in trie.match(_tokens(arg)):
                trie.touch(key)
            for j in range(len(got)):
                model.touch(tuple(arg[:j + 1]))
        elif op == "hold":
            if model.blocks:
                prefix = sorted(model.blocks)[arg % len(model.blocks)]
                blk = model.blocks[prefix]
                alloc.fork(blk)
                held[blk] = held.get(blk, 0) + 1
        elif op == "release":
            live = [b for b, n in held.items() if n > 0]
            if live:
                blk = sorted(live)[arg % len(live)]
                alloc.free([blk])
                held[blk] -= 1
        else:                              # evict
            evictable = [p for p in model.leaves()
                         if not held.get(model.blocks[p])]
            got = trie.evict_one()
            if not evictable:
                assert got is None
            else:
                # leaf-first LRU: exactly the least-recently-touched
                # unprotected leaf goes
                expect = min(evictable, key=model.stamp.get)
                assert got == model.blocks[expect]
                model.remove(expect)
        # invariants after EVERY op:
        assert len(trie) == len(model.blocks)
        # reachability: each key's parent chain is indexed (or the root)
        for (parent, _), blk in trie._index.items():
            assert parent == -1 or parent in trie._block_key
            assert alloc.ref(blk) >= 1
        # allocator conservation: live blocks are exactly the indexed ones
        # (each holding the trie's ref) — slot candidates all freed at EOS
        assert alloc.num_live == len(set(model.blocks.values()))
        # the JAX trie on the same trace holds the same state
        assert trie._index == jtrie._index and trie._lru == jtrie._lru
        assert trie._children == jtrie._children
        assert trie._kids == jtrie._kids and trie._origin == jtrie._origin
        assert alloc._free == jalloc._free and alloc._ref == jalloc._ref


def _mirror(jtrie, jalloc, op, arg, extra, model, held):
    """Apply one trace operation to the JAX trie BEFORE the port's (the
    model and `held` still describe the state both start from)."""
    if op == "register":
        tokens = _tokens(arg)
        parent, cands = -1, []
        for j in range(len(arg)):
            cands.append(jalloc.alloc())
            parent = jtrie.insert(parent, prefix_chunk(tokens, j, BS),
                                  cands[-1],
                                  "prompt" if j < extra else "decode")
        jalloc.free(cands)
    elif op == "match":
        for key, _ in jtrie.match(_tokens(arg)):
            jtrie.touch(key)
    elif op == "hold":
        if model.blocks:
            jalloc.fork(model.blocks[sorted(model.blocks)[
                arg % len(model.blocks)]])
    elif op == "release":
        live = [b for b, n in held.items() if n > 0]
        if live:
            jalloc.free([sorted(live)[arg % len(live)]])
    else:
        jtrie.evict_one()


@given(st.lists(st.lists(st.integers(0, 3), min_size=1, max_size=4),
                min_size=1, max_size=8))
@settings(max_examples=100, deadline=None)
def test_eviction_drains_trie_and_pool(seqs):
    """With no external holders, leaf-first eviction can always make
    progress: draining evict_one empties the whole trie (every interior node
    eventually becomes a leaf) and returns every block to the pool."""
    alloc = BlockAllocator(NUM_BLOCKS)
    trie = PrefixTrie(alloc, BS)
    model = TrieModel()
    for chunk_ids in seqs:
        _register(trie, model, alloc, chunk_ids, len(chunk_ids))
    evicted = 0
    while trie.evict_one() is not None:
        evicted += 1
        # never orphan: every surviving parent chain intact
        for (parent, _) in trie._index:
            assert parent == -1 or parent in trie._block_key
    assert evicted == len(model.blocks)
    assert len(trie) == 0
    assert alloc.num_free == NUM_BLOCKS - 1
    assert alloc.num_live == 0


@given(st.integers(1, 4), st.integers(0, 3), st.integers(0, 3))
@settings(max_examples=50, deadline=None)
def test_equal_chunk_content_under_distinct_parents(depth, c1, c2):
    """Zero-collision keying: the SAME chunk bytes inserted under two
    different parents are two distinct entries, and matching each full
    sequence returns its own chain."""
    hypothesis.assume(c1 != c2)
    alloc = BlockAllocator(NUM_BLOCKS)
    trie = PrefixTrie(alloc, BS)
    model = TrieModel()
    shared_tail = [0] * depth              # same chunk ids after the fork
    a, b = [c1] + shared_tail, [c2] + shared_tail
    _register(trie, model, alloc, a, len(a))
    _register(trie, model, alloc, b, len(b))
    assert len(trie) == 2 * (depth + 1)    # no level collapsed
    got_a = [blk for _, blk in trie.match(_tokens(a))]
    got_b = [blk for _, blk in trie.match(_tokens(b))]
    assert got_a == model.longest_match(a)
    assert got_b == model.longest_match(b)
    assert set(got_a).isdisjoint(got_b)


@given(st.lists(st.lists(st.integers(0, 3), min_size=1, max_size=4),
                min_size=1, max_size=6),
       st.integers(0, 10 ** 6), st.integers(0, 10 ** 6), st.integers(1, 12))
@settings(max_examples=150, deadline=None)
def test_extend_path_contract(seqs, pick, cut, k):
    """Speculative-drafting contract of extend_path (the trie half of
    trie-driven speculative decoding), on an arbitrary registered forest and
    an arbitrary probe prefix:

      * every full block of probe + drafts re-matches — the draft only ever
        walks indexed chains, so len(match(probe + drafts)) ==
        len(probe + drafts) // BS;
      * at most k tokens are drafted;
      * a probe with a full UNMATCHED block drafts nothing (no chain can
        extend past content the trie has never seen);
      * purity: drafting leaves the trie (index, LRU clock) and the
        allocator untouched — a wrong draft must cost nothing."""
    alloc = BlockAllocator(NUM_BLOCKS)
    trie = PrefixTrie(alloc, BS)
    model = TrieModel()
    for chunk_ids in seqs:
        _register(trie, model, alloc, chunk_ids, len(chunk_ids))
    # probe: a token-level prefix of one registered sequence (cut lands
    # mid-block as often as on a boundary, covering the partial-tail walk)
    base = _tokens(seqs[pick % len(seqs)])
    probe = base[:cut % (len(base) + 1)]

    index0 = dict(trie._index)
    lru0 = dict(trie._lru)
    clock0, live0, free0 = trie._clock, alloc.num_live, alloc.num_free
    drafts = trie.extend_path(probe, k)

    assert len(drafts) <= k
    ext = list(probe) + drafts
    assert len(trie.match(ext)) == len(ext) // BS
    # purity: no index/LRU/allocator side effects
    assert trie._index == index0 and trie._lru == lru0
    assert trie._clock == clock0
    assert alloc.num_live == live0 and alloc.num_free == free0

    # a probe the trie has NOT seen past a full block cannot be extended
    alien = probe + [7] * BS               # token 7 is outside the alphabet
    assert trie.extend_path(alien, k) == []


@given(st.integers(1, 3), st.integers(1, 3))
@settings(max_examples=50, deadline=None)
def test_generated_block_insertion_matches_like_prompt(n_prompt, n_decode):
    """Decode-origin entries (generated blocks) are first-class: a sequence
    registered with a prompt/decode origin split matches end-to-end, the
    origins are preserved, and a later all-prompt re-registration of the
    same content does NOT overwrite them (first writer wins)."""
    alloc = BlockAllocator(NUM_BLOCKS)
    trie = PrefixTrie(alloc, BS)
    model = TrieModel()
    chunk_ids = list(range(n_prompt + n_decode))
    _register(trie, model, alloc, chunk_ids, n_prompt)
    assert trie.origin_counts() == {"prompt": n_prompt, "decode": n_decode}
    # the full mixed-origin chain is matchable like any prompt chain
    assert [blk for _, blk in trie.match(_tokens(chunk_ids))] \
        == model.longest_match(chunk_ids)
    # a follow-up turn re-feeds the same tokens as PROMPT: same entries win
    before = dict(model.blocks)
    _register(trie, model, alloc, chunk_ids, len(chunk_ids))
    assert model.blocks == before
    assert trie.origin_counts() == {"prompt": n_prompt, "decode": n_decode}
