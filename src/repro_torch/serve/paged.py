"""Paged KV-cache serving — the port of `repro/serve/paged.py`.

Layout: a GLOBAL pool of fixed-size KV blocks, (L, N, Hkv, block_size, hd)
per k and v, plus per-request block tables on the host. Logical position p
of slot b lives at pool block table[b, p // block_size], row
p % block_size. Block 0 is the trash block: pad lanes write there and no
request owns it. Admission is FIFO and reservation-gated (a request is
admitted only when the unreserved free blocks cover its worst case), so
alloc-on-frontier-crossing never exhausts the pool mid-flight.

PACKED steps (the default): the step's work — a prefill chunk per
prefilling slot and one token per decoding slot — is flattened into a
ragged (1, width) token batch with per-token slot ids, positions and causal
frontiers, at the smallest rung of a 4-entry width ladder that covers it.
Attention runs the fused `hccs_packed_prefill` kernel, which walks
block_table[slot_ids[t]] for every token.

LOCKSTEP steps (packed=False): a (max_batch, block_size) chunk step while
any slot is still prefilling (decoding slots ride along with one valid
lane), else a (max_batch, 1) decode step. A chunk step's attention is the
STE path over each slot's gathered blocks; a decode step runs the fused
`hccs_paged_decode` kernel (with cfg.decode_kernel on) or the STE path.
Each slot samples from its last valid lane.

Without the fused kernel (decode_kernel="none", the i8 modes, softmax) a
packed step's attention core rides a per-slot (B, Wb) grid instead, Wb the
smallest rung of a grid-width ladder covering the step's largest per-slot
chunk (models/attention.py _packed_attention).

INT8 POOLS (cfg.kv_quant="int8"): the pools are int8 with one f32 scale per
(block, kv head), (L, N, Hkv) per k and v. Writes run a per-row fold
(kernels/kv_quant.py), so a block's bytes are a pure function of its rows
and their order. Blocks allocated since the last step are listed as FRESH,
and their stale scales reset to 0 before the fold; COW copies carry payload
and scales and are not fresh.

PREFIX SHARING (prefix_sharing): blocks are refcounted. As a prefill fills
a block with prompt tokens, it is registered in a PrefixTrie keyed by
(parent block id, chunk token bytes). Admission maps the longest run of
cached full-block chunks of a new prompt into its table with fork() and
starts prefill at the first unmatched token (at least the last token is
re-fed). A writer only ever writes a block of refcount 1: a shared block
in a step's write range is copied first (copy-on-write), so cached KV is
immutable. Index-only leaf blocks are evicted LRU-first under pressure.
DECODE SHARING (decode_sharing, implies prefix sharing) registers blocks
as they fill at the decode frontier too, and SESSIONS (submit(req,
session=)) prepend a session's stored history to each turn's prompt, so a
follow-up turn prefix-matches the whole prior conversation.

SPECULATIVE DECODING (speculative=True, packed steps only): every decoding
slot drafts up to draft_len tokens, continuing its sequence along the
prefix trie (PrefixTrie.extend_path) and topping up from an n-gram prompt
lookup over its own tokens (ngram_propose). The drafts ride the packed step
as extra lanes of the slot (1 + drafts verify lanes); each verify lane's
greedy token is exactly what a never-drafted engine samples at that
position, so the longest matching draft prefix plus the model's own token
at the first mismatch are emitted. Rollback leaves no trace: draft-only
block allocations are freed in reverse allocation order (the free list is
restored exactly); fp pools need nothing (rejected rows lie past the
frontier); int8 pools restore a pre-step snapshot of the drafting slots'
blocks and re-fold only the committed rows (_restore_and_replay), because
draft rows fold with a clamped scale.

OVERLOAD ROBUSTNESS (admission=AdmissionConfig(...), serve/admission.py):
a bounded priority queue with backpressure, deadlines checked at step
boundaries, preemption by block reclaim (a lower-class victim's blocks are
freed and it re-queues with its generated tokens as resume state, its
re-prefill mostly skipped through the trie), and graceful exhaustion: a
step's allocations are journaled, so a BlockPoolExhausted mid-phase is
unwound exactly and a victim preempted instead. The device half of every
step goes through _call_device, which retries in robust mode; its three
seams (_step_fn, _packed_fn, _packed_spec_fn) are what the chaos harness
(serve/chaos.py) wraps.

PIPELINED ASYNC LOOP (async_loop=True, packed steps only): the sync loop
serializes [dispatch N -> land N's tokens -> commit N -> dispatch N+1], so
the card idles while the host samples, finishes, registers and traces. The
async loop enqueues step N+1 BEFORE committing step N:

      card   --[ step N ]------[ step N+1 ]-----[ step N+2 ]-->
                  | sampled_N      ^  | sampled_N+1   ^
                  v  (on device)   |  v               |
      host   --[ dispatch N+1 ]--[ commit N ]--[ dispatch N+2 ]--
                decode lanes read  |  wait on N's event, land its
                sampled_N on the   |  tokens: append, EOS/budget
                card (tok_src)     |  finishes, registration,
                                   |  telemetry, one step late

Frontiers and allocations advance at dispatch, so step N+1 schedules
against post-N state without N's token values (greedy only: the device
argmax equals sample_tokens' greedy path). Budget and cache-full finishes
are predicted and kept out of the next schedule; an EOS slot runs one
extra in-flight step whose writes are inert once its blocks are freed at
commit (position-ordered write-before-read; int8 fresh-block scale
zeroing). Hot or speculative steps commit and then run the sync step
(async_sync_fallbacks). The pools are written in place on one stream, so
stream order serializes the steps as buffer donation does in JAX. A step's
uploads are pinned non-blocking copies (a blocking upload would wait for
the card); its sampled tokens land in pinned memory through a non-blocking
copy and a recorded event, and the commit's wait on that event is the one
host sync of an unprofiled async step. The block tables and lockstep
frontiers are dirty-tracked device mirrors, uploaded again only after a
host-side change.

SAMPLING is per request: greedy, or temperature with the JAX engines'
per-(uid, generation index) keys (serve/engine.py sample_tokens), every
verify lane of a speculative step with its own index. TELEMETRY
(serve/telemetry.py) attributes each step to its phases (admit, schedule,
alloc_cow, device, sample, register, rollback) and traces request
lifecycles; `snapshot()` returns the JAX schema.

The host half (allocator, trie, scheduler, lane packing, write targets,
admission) is the JAX package's numpy code, copied; the device half
replaces the jitted step with donated pools by in-place writes into the
preallocated pool tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.decode import tile_tokens, uses_tiles
from repro_torch.kernels.kv_quant import paged_quant_scatter_kv
from repro_torch.models import model as M
from repro_torch.models.attention import kernel_on
from repro_torch.serve import telemetry as T
from repro_torch.serve.admission import (AdmissionQueue, QueueFull,
                                         RobustnessCounters, as_admission,
                                         choose_victim)
from repro_torch.serve.engine import (BASE_KEY, Request, check_params_device,
                                      kv_cache_byte_stats, sample_tokens,
                                      validate_prompt,
                                      warn_decode_kernel_fallback)

TRASH_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """Raised by BlockAllocator.alloc when the free list is empty — before
    any table entry or pool block is touched, so engine state stays valid."""


class DeviceStepFailed(RuntimeError):
    """A step's device half failed past max_device_retries, every attempt
    before its seam began (so the pools are untouched)."""


class BlockAllocator:
    """Host-side refcounted free-list allocator for the global KV block pool.

    A block is born with one reference (`alloc`), gains references when a new
    holder maps it (`fork`), and `free` drops one reference per entry,
    returning the block to the free list only when the count reaches zero.
    Block 0 (the trash block) is never handed out, forked or freed, and
    exhaustion raises BlockPoolExhausted without mutating state.
    """

    def __init__(self, num_blocks: int):
        if num_blocks < 2:
            raise ValueError(
                f"need >= 2 blocks (1 usable + trash), got {num_blocks}")
        self.num_blocks = num_blocks
        # pop() hands out low block ids first (cosmetic: keeps pools dense)
        self._free = list(range(num_blocks - 1, TRASH_BLOCK, -1))
        self._ref: dict[int, int] = {}        # block -> refcount (>= 1)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_live(self) -> int:
        """Unique live blocks (each counted once regardless of refcount)."""
        return len(self._ref)

    def ref(self, blk) -> int:
        """Current refcount of a block (0 if free / never allocated)."""
        return self._ref.get(int(blk), 0)

    def alloc(self) -> int:
        if not self._free:
            raise BlockPoolExhausted(
                f"KV block pool exhausted: {self.num_blocks - 1} usable "
                f"blocks all live")
        blk = self._free.pop()
        self._ref[blk] = 1
        return blk

    def fork(self, blk) -> int:
        """Add a reference to a live block (a new holder maps it read-only);
        returns the block id for `table[j] = alloc.fork(blk)` chaining."""
        blk = int(blk)
        if blk == TRASH_BLOCK:
            raise ValueError("the trash block is never forked")
        if blk not in self._ref:
            raise ValueError(f"forking block {blk} that is not live")
        self._ref[blk] += 1
        return blk

    def free(self, blocks) -> None:
        """Drop ONE reference per entry; a block only returns to the free
        list when its last reference is dropped."""
        for blk in blocks:
            blk = int(blk)
            if blk == TRASH_BLOCK:
                raise ValueError("the trash block is never freed")
            n = self._ref.get(blk)
            if n is None:
                raise ValueError(f"freeing block {blk} that is not live")
            if n == 1:
                del self._ref[blk]
                self._free.append(blk)
            else:
                self._ref[blk] = n - 1


def prefix_chunk(prompt, j: int, block_size: int) -> bytes:
    """Exact content bytes of prompt chunk j (tokens [j*bs, (j+1)*bs)). The
    prefix index keys on (parent block id, chunk bytes) — a trie: the parent
    id pins the whole history, so two chunks with equal tokens but different
    prefixes stay distinct (zero collisions) at O(block_size) per level
    instead of the O(prefix_len) a whole-prefix key would cost."""
    return np.ascontiguousarray(
        np.asarray(prompt[j * block_size:(j + 1) * block_size],
                   np.int32)).tobytes()


def sequence_chunk(prompt, out_tokens, j: int, block_size: int) -> bytes:
    """Chunk j's bytes of the full sequence prompt + out_tokens, without
    materializing the whole concatenation — registration only ever needs the
    newly filled block's O(block_size) span."""
    lo, hi = j * block_size, (j + 1) * block_size
    plen = len(prompt)
    if hi <= plen:
        return prefix_chunk(prompt, j, block_size)
    head = np.asarray(prompt[lo:plen] if lo < plen else [], np.int32)
    tail = np.asarray(out_tokens[max(lo - plen, 0):hi - plen], np.int32)
    return np.ascontiguousarray(np.concatenate([head, tail])).tobytes()


class PrefixTrie:
    """Exact-content prefix trie over full-block token chunks -> pool block.

    Keys are (parent block id | -1 for the root, chunk bytes): the parent id
    pins the whole history, so equal chunk content under different prefixes
    stays distinct (zero collisions) at O(block_size) per level. The trie
    holds its OWN allocator reference on every indexed block (fork at
    insert, free at evict/clear), so cached KV outlives the registering
    request. Entries carry the origin of their tokens — "prompt" (known at
    submit) or "decode" (generated, possibly a boundary block mixing both) —
    so engine telemetry can split prompt-prefix reuse from decode-block
    (multi-turn) reuse.

    Invariants (property-tested in tests/test_torch_prefix_trie.py):
      * reachability: an indexed key's parent is the root or itself an
        indexed block — match() threads each level's block id into the next
        key, so a chain can never dangle;
      * insert is first-writer-wins: an existing key is touched and
        returned, never replaced (the caller keeps using its own duplicate
        block, which dies with the caller);
      * evict_one only removes LEAF entries (no indexed children) whose
        block has no holder besides the trie (ref == 1), least-recently-
        touched first — so surviving chains stay reachable and in-flight
        writers/holders are structurally protected;
      * every indexed block has refcount >= 1 (the trie's own reference).
    """

    def __init__(self, alloc: BlockAllocator, block_size: int):
        self.alloc = alloc
        self.block_size = block_size
        self._index: dict[tuple, int] = {}   # (parent, chunk bytes) -> block
        self._block_key: dict[int, tuple] = {}      # block -> its trie key
        self._children: dict[int, int] = {}         # parent -> indexed kids
        # parent -> {chunk bytes -> block}: the downward index extend_path
        # drafts from (match() only ever walks exact keys downward; drafting
        # needs "which chunks continue this parent")
        self._kids: dict[int, dict[bytes, int]] = {}
        self._lru: dict[tuple, int] = {}            # key -> last touch
        self._origin: dict[tuple, str] = {}         # key -> prompt | decode
        self._clock = 0

    def __len__(self) -> int:
        return len(self._index)

    def blocks(self):
        """The indexed pool block ids (for pool-hygiene checks)."""
        return self._index.values()

    def origin(self, key: tuple) -> str:
        return self._origin[key]

    def origin_counts(self) -> dict:
        counts = {"prompt": 0, "decode": 0}
        for o in self._origin.values():
            counts[o] += 1
        return counts

    def touch(self, key: tuple):
        self._clock += 1
        self._lru[key] = self._clock

    def match(self, tokens) -> list[tuple[tuple, int]]:
        """Longest contiguous run of full-block chunks of `tokens` present in
        the trie, as [(key, block id), ...] from block 0 up. Each hit's block
        id threads into the next level's key, so the walk stops naturally at
        the first missing level — a deeper entry without its parents is
        unreachable by construction. Pure: does not touch the LRU (callers
        touch the keys they actually map)."""
        bs = self.block_size
        matched = []
        parent, j = -1, 0
        while (j + 1) * bs <= len(tokens):
            key = (parent, prefix_chunk(tokens, j, bs))
            blk = self._index.get(key)
            if blk is None:
                break
            matched.append((key, blk))
            parent, j = blk, j + 1
        return matched

    def extend_path(self, tokens, k: int) -> list[int]:
        """Draft up to k tokens continuing `tokens` along indexed chains:
        after the longest full-block matched path, descend through children
        whose chunk CONTENT starts with the sequence's partial tail (int32
        token bytes, so a bytes-prefix test IS a token-prefix test), reading
        the draft straight out of the stored chunk. Among several matching
        children the most recently touched wins (the trie's own recency
        signal — no extra state). Pure: no LRU touches, no allocator
        effects; a wrong draft is rejected by verification at zero cost.

        Property (tests/test_torch_prefix_trie.py): every full block of
        tokens + drafts re-matches, i.e.
        len(match(tokens + drafts)) == len(tokens + drafts) // block_size."""
        bs = self.block_size
        matched = self.match(tokens)
        parent = matched[-1][1] if matched else -1
        tail = np.ascontiguousarray(
            np.asarray(tokens[len(matched) * bs:], np.int32)).tobytes()
        if len(tail) >= bs * 4:
            return []            # unmatched FULL block: no chain extends it
        out: list[int] = []
        while len(out) < k:
            kids = self._kids.get(parent)
            if not kids:
                break
            best = None
            for chunk, blk in kids.items():
                if chunk.startswith(tail) and len(chunk) > len(tail):
                    stamp = self._lru[(parent, chunk)]
                    if best is None or stamp > best[0]:
                        best = (stamp, chunk, blk)
            if best is None:
                break
            _, chunk, blk = best
            out.extend(np.frombuffer(chunk, np.int32)[len(tail) // 4:]
                       .tolist())
            parent, tail = blk, b""
        return out[:k]

    def insert(self, parent: int, chunk: bytes, blk, origin: str) -> int:
        """Index `blk` under (parent, chunk) and take a reference on it;
        first writer wins — an existing key is touched and its block
        returned, so chains stay rooted in index blocks even when the caller
        holds a COW copy or a duplicate. Returns the indexed block id (the
        caller threads it into the next level's parent)."""
        key = (int(parent), chunk)
        have = self._index.get(key)
        if have is not None:
            self.touch(key)
            return have
        blk = int(blk)
        self._index[key] = self.alloc.fork(blk)
        self._block_key[blk] = key
        self._origin[key] = origin
        self._children[key[0]] = self._children.get(key[0], 0) + 1
        self._kids.setdefault(key[0], {})[key[1]] = blk
        self.touch(key)
        return blk

    def evict_one(self, protect=frozenset()) -> int | None:
        """Reclaim the least-recently-used index-only LEAF block (ref == 1:
        no live slot or session holds it; no indexed children: evicting an
        interior node would orphan its whole subtree — unreachable entries
        squatting on pool blocks). Returns the freed block id, or None when
        nothing is evictable."""
        for key in sorted(self._lru, key=self._lru.get):
            blk = self._index[key]
            if (blk in protect or self.alloc.ref(blk) != 1
                    or self._children.get(blk, 0)):
                continue
            del self._index[key]
            del self._block_key[blk]
            del self._lru[key]
            del self._origin[key]
            parent = key[0]          # a block id, or -1 for the trie root
            self._children[parent] -= 1
            if not self._children[parent]:
                del self._children[parent]
            kids = self._kids[parent]
            del kids[key[1]]
            if not kids:
                del self._kids[parent]
            self.alloc.free([blk])
            return blk
        return None

    def clear(self):
        """Drop every index reference; blocks with no other holder return to
        the free list immediately."""
        blocks = list(self._index.values())
        self._index.clear()
        self._block_key.clear()
        self._children.clear()
        self._kids.clear()
        self._lru.clear()
        self._origin.clear()
        self.alloc.free(blocks)



def schedule_step_tokens(live, remaining, budget: int,
                         chunk_cap: int | None = None, drafts=None):
    """Per-slot token counts for one packed step (pure).

    live: (B,) bool; remaining: (B,) prompt tokens still to feed (0 for
    decoding slots); budget: total token lanes this step. Every live slot is
    scheduled: decode slots take exactly one lane, prefilling slots at least
    one, and the leftover budget is dealt to prefilling slots in slot order
    (greedy FIFO fill), at most `chunk_cap` tokens per slot. Requires
    budget >= live.sum().

    drafts ((B,) int, speculative decoding): proposed draft-token counts per
    DECODE slot; leftover budget is dealt to decode slots' draft lanes FIRST
    (a verified draft advances a whole token, a prefill lane only a prompt
    position), in slot order, still at most chunk_cap lanes per slot."""
    live = np.asarray(live, bool)
    remaining = np.asarray(remaining, np.int64)
    cap = int(chunk_cap) if chunk_cap else int(budget)
    t_valid = np.zeros(live.shape[0], np.int32)
    t_valid[live] = 1
    left = int(budget) - int(t_valid.sum())
    if left < 0:
        raise ValueError(
            f"token budget {budget} below live slot count {live.sum()}")
    if drafts is not None:
        drafts = np.asarray(drafts, np.int64)
        for slot in np.flatnonzero(live & (remaining == 0) & (drafts > 0)):
            take = min(int(drafts[slot]), cap - 1, left)
            t_valid[slot] += take
            left -= take
            if not left:
                break
    for slot in np.flatnonzero(live & (remaining > 0)):
        take = min(int(remaining[slot]) - 1, cap - 1, left)
        t_valid[slot] += take
        left -= take
        if not left:
            break
    return t_valid


def ngram_propose(seq, k: int, max_n: int = 3) -> list[int]:
    """Prompt-lookup drafting fallback: find the longest n-gram suffix of
    `seq` (n = max_n down to 1) that occurred EARLIER in seq, and propose
    the k tokens that followed its most recent earlier occurrence.
    Vectorized numpy (it runs per decoding slot per step). Returns [] when
    no suffix repeats: drafting is best-effort, verification catches
    everything."""
    seq = np.asarray(seq, np.int32)
    n_tot = len(seq)
    for n in range(min(max_n, n_tot - 1), 0, -1):
        suffix = seq[n_tot - n:]
        # all length-n windows at once; candidate starts exclude the suffix
        # itself (the window at n_tot - n), the most recent earlier one wins
        win = np.lib.stride_tricks.sliding_window_view(seq, n)
        hits = np.flatnonzero((win[:-1] == suffix).all(axis=1))
        if len(hits):
            s = int(hits[-1])
            # s + n <= n_tot - 1, so the follow run is never empty
            return [int(x) for x in seq[s + n:s + n + k]]
    return []


def _gather_block_state(layers, blocks):
    """A COPY of `blocks` (S,) across all layers, int8 payload and scales,
    taken before a speculative verify step's forward writes the pools in
    place (and before its fresh-block reset and draft folds), so the
    post-verification rewrite can restore them (_restore_and_replay)."""
    return {name: layers[name][:, blocks].clone()
            for name in ("k", "v", "k_scale", "v_scale")}


def _restore_and_replay(layers, snap, blocks, fresh_mask, staged_k,
                        staged_v, replay_pos):
    """Post-verification int8 rewrite, run after EVERY speculative verify
    step, in place: restore the snapshot of every block the drafting slots'
    rows touched (the in-step folds were scratch: draft lanes clamped the
    scale, and a committed lane's growth cannot be undone in place),
    re-zero the scales of snapshot blocks allocated this step that stay
    live (the replay must see the zeroed scale a real step sees; freed
    draft blocks keep their restored stale state, as a never-drafted run
    leaves a never-allocated block), then re-fold ONLY the committed rows
    from the staged raw KV with the fold kernel, one call for every layer
    and both pools (JAX's vmap over layers), rejected lanes steered into the
    trash block. Block bytes are a pure function of (rows, order), so the
    pool ends bit-identical to a step that never drafted.

    layers: the per-layer pool dict; snap: _gather_block_state's copy;
    blocks: (S,) int64, padded with TRASH_BLOCK duplicates; fresh_mask: (S,)
    bool; staged_k/staged_v: (L, 1, Hkv, W, hd) f32; replay_pos: (1, W)
    int32."""
    for name in ("k", "v"):
        # the padding duplicates are all the trash block, gathered from one
        # state with fresh_mask False, so their values are identical and the
        # order of a duplicate-index write does not matter
        layers[name][:, blocks] = snap[name]
        layers[name + "_scale"][:, blocks] = torch.where(
            fresh_mask[None, :, None], 0.0, snap[name + "_scale"])
    paged_quant_scatter_kv(layers["k"], layers["k_scale"], staged_k,
                           layers["v"], layers["v_scale"], staged_v,
                           replay_pos)
    return layers


def pack_slot_ids(t_valid, width: int):
    """Flatten per-slot counts into the packed lane layout: slot segments
    are contiguous, in slot order, pad lanes (-1) at the tail. Returns
    (slot_ids (width,) int32, per-slot lane offsets (B,) int32)."""
    t_valid = np.asarray(t_valid)
    sid = np.full(width, -1, np.int32)
    off = np.zeros(t_valid.shape[0], np.int32)
    c = 0
    for slot in np.flatnonzero(t_valid > 0):
        tv = int(t_valid[slot])
        off[slot] = c
        sid[c:c + tv] = slot
        c += tv
    return sid, off


# padding_stats' keys of the port alone (the JAX engine has no tiled kernel)
TILE_STATS = ("tile_rows_valid", "tile_rows_total", "tile_fill")


def tile_rows(t_valid, width: int, tokens: int,
              group: int) -> tuple[int, int]:
    """(valid, total) (token, query head) rows of the tiles the packed
    attention kernel cuts a step of `width` lanes into
    (`kernels/csrc/hccs_tiled.cuh`): each slot's segment of t_valid tokens
    in tiles of `tokens`, `group` rows a token; none at a width that runs
    the split sweep (`uses_tiles`). Read from the host's schedule, never
    from the device."""
    if not uses_tiles(width):
        return 0, 0
    tv = np.asarray(t_valid, np.int64)
    tv = tv[tv > 0]
    return (int(tv.sum()) * group,
            int((-(-tv // tokens)).sum()) * tokens * group)


def _slot_write_targets(table_row, start: int, tv: int, bs: int):
    """Flat pool positions for one slot's next tv tokens: token i lands at
    table_row[(start+i)//bs] * bs + (start+i) % bs."""
    gpos = start + np.arange(tv)
    return np.asarray(table_row)[gpos // bs].astype(np.int64) * bs + gpos % bs


def packed_write_positions(t_valid, off, tables, lengths, block_size: int,
                           width: int):
    """Flat pool scatter targets (width,): lane off[b] + i of slot b lands at
    tables[b, (len+i)//bs] * bs + (len+i) % bs. Pad lanes are steered into
    the trash block (row lane % bs — colliding writes are fine, it is
    trash)."""
    bs = block_size
    wp = TRASH_BLOCK * bs + np.arange(width, dtype=np.int64) % bs
    tables = np.asarray(tables)
    for slot in np.flatnonzero(np.asarray(t_valid) > 0):
        tv = int(t_valid[slot])
        o = int(off[slot])
        wp[o:o + tv] = _slot_write_targets(tables[slot], int(lengths[slot]),
                                           tv, bs)
    return wp.astype(np.int32)


def _copy_block_kv(layers, src: int, dst: int):
    """Copy-on-write: duplicate pool block `src` into `dst` across all
    layers, IN PLACE, for k and v and, on int8 pools, the per-block scales
    (a COW copy reproduces the block bit for bit: same payload, same
    dequant scale)."""
    for name in ("k", "v", "k_scale", "v_scale"):
        leaf = layers.get(name)
        if leaf is not None:
            leaf[:, dst] = leaf[:, src]


def init_paged_cache(cfg, num_blocks: int, block_size: int, max_batch: int,
                     cache_dtype=None, device=None):
    """Model cache in the paged layout: per-layer (N, Hkv, bs, hd) pools,
    stacked over layers, with the TRUE head_dim (the JAX package pads it to
    the TPU's 128-lane tile; the CUDA kernels need no padding). The per-slot
    frontiers live on the host (PagedEngine._lengths); every packed step
    passes explicit positions. cache_dtype=None resolves to
    cfg.cache_dtype.

    An interleaved model (a per-layer pattern of Mamba-2 and attention
    mixers) holds pools for its attention layers only and, beside them,
    each Mamba-2 layer's per-slot state, which the packed step reads and
    writes in place (models/ssm.py apply_mamba):

        ssm:             (Lm, max_batch, nh, N, P)   f32 SSD state
        conv:            (Lm, max_batch, K-1, C)     the conv's last raw
                                                     inputs, in cfg.dtype

    With cfg.kv_quant="int8" the pools are int8 whatever cache_dtype, and
    the layers carry `k_scale`/`v_scale` (L, N, Hkv) float32, one dequant
    scale per (block, kv head), 0 meaning "never written":

        k/v:             (L, N, Hkv, bs, hd)  int8 payload
        k_scale/v_scale: (L, N, Hkv)          f32, value = q * scale"""
    device = resolve_device(device)
    quant = cfg.kv_quant == "int8"
    dt = torch.int8 if quant else M.DTYPES[cache_dtype or cfg.cache_dtype]
    L, hkv = cfg.num_layers, cfg.num_kv_heads
    interleaved = cfg.family == "interleaved"
    if interleaved:
        L = cfg.layers_of("attention")
    shape = (L, num_blocks, hkv, block_size, cfg.head_dim)
    layers = {"k": torch.zeros(shape, dtype=dt, device=device),
              "v": torch.zeros(shape, dtype=dt, device=device)}
    if quant:
        for name in ("k_scale", "v_scale"):
            layers[name] = torch.zeros((L, num_blocks, hkv),
                                       dtype=torch.float32, device=device)
    if interleaved:
        lm = cfg.layers_of("mamba")
        layers["ssm"] = torch.zeros(
            (lm, max_batch, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim),
            dtype=torch.float32, device=device)
        layers["conv"] = torch.zeros(
            (lm, max_batch, cfg.ssm_conv - 1,
             cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state),
            dtype=M.DTYPES[cfg.dtype], device=device)
    return {"layers": layers}


class PagedEngine:
    """The paged engine, packed or lockstep steps, with sharing, sessions,
    int8 pools, speculative decoding, the robustness layer, the async loop
    and telemetry; the JAX engine's constructor arguments. `decode_steps`
    counts the lockstep layout's (B, 1) decode steps."""

    def __init__(self, params, cfg, *, max_batch: int = 8,
                 max_len: int = 512, eos_id: int | None = None,
                 cache_dtype=None, block_size: int | None = None,
                 num_blocks: int | None = None,
                 prefix_sharing: bool | None = None,
                 decode_sharing: bool | None = None,
                 packed: bool | None = None,
                 token_budget: int | None = None,
                 speculative: bool | None = None,
                 draft_len: int | None = None,
                 async_loop: bool | None = None,
                 telemetry=None, admission=None, device=None):
        self.device = resolve_device(device)
        if cfg.hot_buffer != 0:
            raise ValueError(
                "paged batching uses the block pool, not hot buffers "
                f"(cfg.hot_buffer={cfg.hot_buffer})")
        if cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                f"paged KV needs attention-only blocks; {cfg.family} carries "
                "per-slot SSM state that a block pool cannot page")
        self.packed = True if packed is None else bool(packed)
        check_params_device(params, self.device)
        warn_decode_kernel_fallback(cfg)
        self.w = params["weights"]
        self.hccs = params["hccs"]
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        # kv_quant="int8": int8 pools with per-block scales; the engine's one
        # extra duty is the fresh-block list (_take_fresh)
        self.quantized = cfg.kv_quant == "int8"
        bs = int(block_size if block_size is not None else cfg.block_size)
        # a power of two >= 8, the contract ModelConfig.block_size enforces
        # (constructor args bypass the config dataclass)
        if bs < 8 or (bs & (bs - 1)):
            raise ValueError(
                f"block_size must be a power of two >= 8, got {bs}")
        if max_len < bs:
            raise ValueError(f"block_size {bs} exceeds max_len {max_len}")
        self.block_size = bs
        self._nblk_per_seq = -(-max_len // bs)       # block-table width
        if num_blocks is None:
            num_blocks = cfg.num_blocks
        if not num_blocks:
            # auto-size: half the equivalent dense slot arena, floored at
            # one full-length request + trash + one spare
            num_blocks = max(max_batch * self._nblk_per_seq // 2,
                             self._nblk_per_seq + 2)
        self.num_blocks = int(num_blocks)
        self.alloc = BlockAllocator(self.num_blocks)
        # the opt-in robustness layer (serve/admission.py): admission=None
        # with an all-default cfg keeps the unbounded FIFO list and the
        # fail-fast exhaustion path
        self._adm = as_admission(admission, cfg)
        self._robust = self._adm is not None
        if self._robust:
            self._queue = AdmissionQueue(self._adm)
        else:
            self._queue: list[Request] = []
        self.robust_counters = RobustnessCounters()
        self._admit_counter = 0              # monotone admission order
        self._key = BASE_KEY
        # request-lifecycle tracing and step-phase profiling; disabled by
        # default, every hook a flag check
        self.telemetry = T.as_telemetry(telemetry)
        # one serving clock for deadlines, queue stamps and telemetry (the
        # Telemetry's clock) unless AdmissionConfig pins another for
        # deadlines
        self._clock = (self._adm.clock
                       if self._robust and self._adm.clock is not None
                       else self.telemetry.clock)
        self.occupancy_sum = 0.0
        self.occupancy_steps = 0
        # the default budget is one lockstep chunk step's lane count
        budget = (int(token_budget) if token_budget
                  else max_batch * bs)
        if budget < max_batch:
            raise ValueError(
                f"token_budget {budget} cannot schedule every live slot "
                f"(max_batch {max_batch})")
        self.token_budget = budget
        # blocks allocated since the last step (int8 pools): their stale
        # scales reset to 0 inside the next step, before the fold. COW
        # destinations are not fresh (payload and scales were copied). A step
        # writing <= budget tokens over <= max_batch slots crosses at most
        # budget / bs + 2 * max_batch new blocks.
        self._fresh: list[int] = []
        self._fresh_cap = budget // bs + 2 * max_batch
        # chunk-width ladder (the JAX engine's, exactly): a packed step runs
        # at the smallest width that covers its work
        self._widths = sorted({max_batch, max(budget // 4, max_batch),
                               max(budget // 2, max_batch), budget})
        # per-slot chunks are capped at 4 blocks (the JAX engine's cap)
        self._chunk_cap = min(4 * bs, budget)
        # speculative decoding: decode slots draft up to draft_len tokens a
        # step, verified in one packed step
        self.speculative = bool(cfg.speculative if speculative is None
                                else speculative)
        self.draft_len = int(cfg.draft_len if draft_len is None
                             else draft_len)
        if self.draft_len < 1:
            raise ValueError(
                f"draft_len must be >= 1, got {self.draft_len}")
        if self.speculative and not self.packed:
            raise ValueError(
                "speculative decoding verifies all drafts in one packed "
                "step; it requires packed=True (the lockstep layout has no "
                "multi-token decode lanes)")
        if self.speculative:
            # verify lanes ride on a pure-decode step's max_batch lanes: a
            # 2 * max_batch rung keeps a lightly drafting step from jumping
            # to budget // 4 lanes
            self._widths = sorted(set(self._widths)
                                  | {min(2 * max_batch, budget)})
        # acceptance counters (prefix_stats): drafted = accepted + rejected
        self.spec_steps = 0
        self.spec_rollbacks = 0
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rejected_tokens = 0
        # int8 rollback snapshot cap: each drafting slot's verify rows span
        # at most ceil((1 + draft_len) / bs) + 1 boundary-straddling blocks
        self._snap_cap = max_batch * ((self.draft_len + 1) // bs + 2)
        # attention-grid width ladder of the packed step without the kernel:
        # 1 for pure decode, block_size multiples up to the chunk cap, and
        # with speculative decoding a 1 + draft_len rung for verify rows
        self._grid_widths = [1] + [k * bs for k in
                                   range(1, self._chunk_cap // bs + 1)]
        if self._grid_widths[-1] < self._chunk_cap:
            self._grid_widths.append(self._chunk_cap)
        if self.speculative:
            self._grid_widths = sorted(set(self._grid_widths)
                                       | {min(1 + self.draft_len,
                                              self._chunk_cap)})
        # the grid steering rides the step only when the kernel is off
        self._use_grid = not kernel_on(cfg, params["hccs"] or None)
        # the pipelined async loop (module docstring): packed steps only
        self.async_loop = bool(cfg.async_loop if async_loop is None
                               else async_loop)
        if self.async_loop and not self.packed:
            raise ValueError(
                "async_loop pipelines the packed token step; it requires "
                "packed=True (the lockstep layout is the synchronous "
                "parity baseline)")
        # the in-flight packed step awaiting its commit (one deep): None or
        # the record _dispatch_packed_async builds
        self._pending: dict | None = None
        # steps dispatched ahead of the previous step's commit, and steps
        # that committed first (hot sampling, speculative drafting)
        self.async_overlapped_steps = 0
        self.async_sync_fallbacks = 0
        # token-lane telemetry (padding_stats)
        self.lanes_valid = 0
        self.lanes_total = 0
        self.pad_lanes_skipped = 0
        # rows of the packed kernel's tiles (tile_rows), packed steps only
        self._group = max(cfg.num_heads // max(cfg.num_kv_heads, 1), 1)
        self._tile_tokens = tile_tokens(self._group)
        self.tile_rows_valid = 0
        self.tile_rows_total = 0
        self.decode_steps = 0

        # prefix sharing: the trie holds its own reference on every indexed
        # block, so cached prefixes outlive the registering request.
        # decode_sharing also registers GENERATED blocks as they fill, on
        # the same trie, so it implies prefix sharing.
        self.decode_sharing = bool(cfg.decode_sharing if decode_sharing is None
                                   else decode_sharing)
        self.prefix_sharing = (bool(cfg.prefix_sharing if prefix_sharing
                                    is None else prefix_sharing)
                               or self.decode_sharing)
        self.trie = PrefixTrie(self.alloc, bs)
        self.prefix_lookups = 0
        self.prefix_hits = 0
        self.prompt_hits = 0            # admissions matching >=1 prompt block
        self.decode_hits = 0            # admissions matching >=1 decode block
        self.prefill_tokens_total = 0
        self.prefill_tokens_skipped = 0
        self.prompt_tokens_skipped = 0  # skip split by matched-block origin
        self.decode_tokens_skipped = 0
        self.cow_copies = 0
        self.prefix_evictions = 0

        # multi-turn sessions: submit(req, session=sid) prepends the stored
        # history (prompt + generated tokens of every prior turn); _finish
        # extends it with this turn
        self._sessions: dict = {}            # session id -> token history
        self._session_busy: set = set()      # sessions with an in-flight turn
        self._req_session: dict[int, object] = {}   # id(req) -> session id
        self._followups: set[int] = set()    # id(req) of follow-up turns
        self.followup_prefill_tokens = 0
        self.followup_tokens_skipped = 0

        # per-slot registration watermark: trie levels already indexed for
        # the slot's request and the INDEXED parent at that depth (which may
        # differ from the slot's own table under first-writer-wins)
        self._reg_level = np.zeros(max_batch, np.int32)
        self._reg_parent = np.full(max_batch, -1, np.int64)

        self._tables = np.full((max_batch, self._nblk_per_seq), -1, np.int32)
        # dirty-tracked device mirrors of _tables and _lengths: set to None
        # at every host-side change (_admit, _grow_tables, _cow_shared,
        # _unwind_allocs, _release_slot, the frontier advances, rollback)
        # and uploaded again on the next use
        self._tables_dev = None
        self._lengths_dev = None
        self._resv = np.zeros(max_batch, np.int64)   # admission reservations
        self._slots: list[Request | None] = [None] * max_batch
        # the FEED is what prefill must cover: req.prompt on a first
        # admission, prompt + out_tokens for a request resuming after
        # preemption; every per-step check runs against the feed
        self._feeds: list[np.ndarray | None] = [None] * max_batch
        self._live = np.zeros(max_batch, bool)
        self._lengths = np.zeros(max_batch, np.int32)
        self._prompt_pos = np.zeros(max_batch, np.int32)  # feed tokens fed
        self._last = np.zeros(max_batch, np.int32)        # next token to feed
        self._temps = np.zeros(max_batch)
        # robustness per-slot metadata: victim policy keys + deadline clocks
        self._prio = np.zeros(max_batch, np.int64)
        self._admit_seq = np.zeros(max_batch, np.int64)
        self._qseq = np.zeros(max_batch, np.int64)   # queue seq (for requeue)
        self._submitted_ts = np.zeros(max_batch, float)
        # per-slot Mamba-2 state (the interleaved family) is written by
        # every step it runs: nothing can restore it to an earlier position
        self.recurrent = cfg.family == "interleaved"
        if self.recurrent:
            self._refuse_for_recurrent_state()
        self._cache = init_paged_cache(cfg, self.num_blocks, bs, max_batch,
                                       cache_dtype, self.device)
        # the device half of each step, one seam per step kind: each takes
        # the step's device inputs, writes the pools in place and returns
        # (logits, cache). The chaos harness wraps these attributes.
        self._step_fn = self._lockstep_forward
        self._packed_fn = self._packed_forward
        self._packed_spec_fn = self._packed_spec_forward
        self._packed_async_fn = self._packed_async_forward
        self._device_entered = False     # set by a seam as it starts

    def _refuse_for_recurrent_state(self):
        """Raise, naming the option, for what per-slot recurrent state
        cannot follow yet: each needs the state of an earlier position (a
        shared prefix's, a rejected draft's, a preempted request's) or the
        lockstep layout's per-slot steps."""
        why = ("carries per-slot Mamba-2 state that the block pool cannot "
               "share, snapshot or roll back")
        name = self.cfg.name
        for option, on in (("packed=False", not self.packed),
                           ("decode_sharing", self.decode_sharing),
                           ("prefix_sharing", self.prefix_sharing),
                           ("speculative", self.speculative),
                           ("preemption",
                            self._robust and self._adm.preemption)):
            if on:
                raise ValueError(f"{option}: {name} {why}; serve it with "
                                 "packed steps and the option off")

    # ----------------------------------------------------- device mirrors --

    def _device_tables(self) -> torch.Tensor:
        """Device mirror of the host block tables, uploaded again only
        after a host-side change."""
        if self._tables_dev is None:
            self._tables_dev = self._dev(self._tables)
        return self._tables_dev

    def _device_lengths(self) -> torch.Tensor:
        if self._lengths_dev is None:
            self._lengths_dev = self._dev(self._lengths)
        return self._lengths_dev

    # ------------------------------------------------------------- queue --

    def _blocks_for(self, plen: int, max_new: int) -> int:
        return -(-min(plen + max_new, self.max_len) // self.block_size)

    def submit(self, req: Request, session=None):
        """Queue a request (greedy only). With `session`, the request is one
        TURN of a multi-turn conversation: the session's stored history
        (prompt + generated tokens of every prior turn) is prepended to
        req.prompt, so admission prefix-matches the whole prior
        conversation; with sharing off that degenerates to re-feeding the
        history (same outputs, full cost). A session admits one turn at a
        time.

        With the robustness layer, submission runs the bounded queue's
        backpressure policy: "reject" raises QueueFull before ANY engine or
        session state is touched; "shed-lowest-priority" drops the
        lowest-class newest queued request, possibly this one, which then
        returns marked failed/"shed" instead of queued."""
        prompt = req.prompt
        followup = False
        if session is not None and self.recurrent:
            raise ValueError(f"submit(..., session=): {self.cfg.name} "
                             "carries per-slot Mamba-2 state; a session's "
                             "next turn would need the state its last one "
                             "left")
        if session is not None:
            if session in self._session_busy:
                raise ValueError(
                    f"session {session!r} already has an in-flight turn")
            hist = self._sessions.get(session)
            if hist is not None and len(hist):
                prompt = np.concatenate(
                    [hist, np.asarray(prompt, np.int32)])
                followup = True
        validate_prompt(prompt, self.max_len)
        need = self._blocks_for(len(prompt), req.max_new_tokens)
        if need > self.num_blocks - 1:
            raise ValueError(
                f"request needs up to {need} KV blocks but the pool has "
                f"{self.num_blocks - 1} usable")
        # every check passed: commit the concatenation and the bookkeeping
        req.prompt = prompt
        if self._robust:
            rc = self.robust_counters
            rc.klass(req.priority)["submitted"] += 1
            try:
                # drive_open_loop's stamped arrival anchors the deadline
                # clock, so a mid-step arrival's wait counts as queueing
                now = (req.arrival_ts if req.arrival_ts is not None
                       else self._clock())
                shed = self._queue.push(req, now=now)
            except QueueFull:
                rc.rejected += 1
                rc.klass(req.priority)["rejected"] += 1
                raise
            for victim in shed:
                rc.shed += 1
                rc.klass(victim.priority)["shed"] += 1
                self._drop_request(victim, "shed")
            if req.failed:
                return                   # shed on arrival: nothing enqueued
        if self.telemetry.enabled:
            self.telemetry.metrics.on_submit(req.uid, len(prompt),
                                             ts=req.arrival_ts)
        if session is not None:
            self._session_busy.add(session)
            self._req_session[id(req)] = session
            if followup:
                self._followups.add(id(req))
        if not self._robust:
            self._queue.append(req)

    def session_history(self, session):
        """Full token history (prompt + generated, every finished turn) of a
        session, or None for an unknown session."""
        hist = self._sessions.get(session)
        return None if hist is None else np.asarray(hist).copy()

    def end_session(self, session):
        """Forget a session's history. An in-flight turn of the session is
        cancelled first (blocks freed refcount-aware, no history written).
        Cached KV stays in the trie until evicted or clear_prefix_cache()."""
        if session in self._session_busy:
            for req_id, sid in list(self._req_session.items()):
                if sid == session:
                    req = next(
                        (r for r in list(self._queue) + list(self._slots)
                         if r is not None and id(r) == req_id), None)
                    if req is not None:
                        self.cancel(req.uid)
            self._session_busy.discard(session)
        self._sessions.pop(session, None)

    def cancel(self, uid) -> bool:
        """Cancel a queued or running request by uid, with or without the
        robustness layer: it is marked failed with reason "cancelled", its
        blocks are freed refcount-aware, and its session turn, if any, is
        aborted with no history written. Returns False when no queued or
        running request has this uid."""
        if self._robust:
            req = self._queue.remove(uid)
        else:
            req = next((r for r in self._queue if r.uid == uid), None)
            if req is not None:
                self._queue.remove(req)
        if req is None:
            for slot in np.flatnonzero(self._live):
                if self._slots[slot].uid == uid:
                    req = self._slots[slot]
                    self._release_slot(int(slot))
                    break
        if req is None:
            return False
        self._drop_request(req, "cancelled")
        self.robust_counters.cancelled += 1
        if self._robust:
            self.robust_counters.klass(req.priority)["cancelled"] += 1
        return True

    def _admit(self):
        """FIFO admission into free slots, gated on UNRESERVED free blocks
        covering the request's worst case (deadlock-free: admitted requests
        can always grow to their budget).

        With prefix sharing, the longest run of full-block chunks of the
        feed already in the trie is forked into the new slot's table and
        prefill starts at the first unmatched token; the reservation shrinks
        by the matched blocks and grows by one when the WHOLE feed matched
        (the re-fed last token writes inside a shared block, whose COW copy
        needs a block). Index-only cached blocks are evicted on demand when
        the gate would otherwise stall.

        With the robustness layer the queue head is the highest class, and
        a stalled gate can PREEMPT: a live victim of a strictly lower class
        (the lowest class, most recently admitted) is released and
        re-queued with its generated tokens as resume state, then the gate
        re-evaluates with the reclaimed blocks."""
        while self._queue and not self._live.all():
            entry = None
            if self._robust:
                entry = self._queue.head_entry()
                req = entry.req
            else:
                req = self._queue[0]
            # a preempted request resumes by re-feeding every token it
            # generated (the trie skips what stayed cached); need is the
            # same: len(prompt) + max_new = len(feed) + the remaining budget
            feed = (np.concatenate([np.asarray(req.prompt, np.int32),
                                    np.asarray(req.out_tokens, np.int32)])
                    if req.out_tokens else np.asarray(req.prompt, np.int32))
            matched = (self._match_prefix(feed)
                       if self.prefix_sharing else [])
            start = min(len(matched) * self.block_size, len(feed) - 1)
            need = (self._blocks_for(len(req.prompt), req.max_new_tokens)
                    - len(matched))
            if len(matched) * self.block_size > start:
                need += 1                    # full-feed hit: COW copy block
            resv_other = int(self._resv.sum())
            protect = {blk for _, blk in matched}
            while (self.alloc.num_free - resv_other < need
                   and self._evict_one(protect)):
                pass
            if self.alloc.num_free - resv_other < need:
                if self._robust and self._adm.preemption:
                    victim = choose_victim(
                        np.flatnonzero(self._live), self._prio,
                        self._admit_seq, below=int(req.priority))
                    if victim is not None:
                        self._preempt_slot(int(victim))
                        continue             # gate re-evaluates, pool grew
                break                        # wait for EOS to free blocks
            if self._robust:
                self._queue.pop_head()
            else:
                self._queue.pop(0)
            slot = int(np.argmin(self._live))
            if req.admit_step is None:
                req.admit_step = self.occupancy_steps
            if self.telemetry.enabled:
                self.telemetry.metrics.on_admit(req.uid)
            origins = [self.trie.origin(key) for key, _ in matched]
            for j, (key, blk) in enumerate(matched):
                self._tables[slot, j] = self.alloc.fork(blk)
                self.trie.touch(key)
            if self.prefix_sharing:
                # counted at admission, so hit_rate is per request
                self.prefix_lookups += 1
                self.prefix_hits += bool(matched)
                self.prompt_hits += any(o == "prompt" for o in origins)
                self.decode_hits += any(o == "decode" for o in origins)
            self.prefill_tokens_total += len(feed)
            self.prefill_tokens_skipped += start
            # the skip split by matched-block origin (the last matched block
            # gives < block_size when the whole feed matched)
            bs = self.block_size
            for j, o in enumerate(origins):
                skipped = max(min(bs, start - j * bs), 0)
                if o == "decode":
                    self.decode_tokens_skipped += skipped
                else:
                    self.prompt_tokens_skipped += skipped
            if id(req) in self._followups:
                self.followup_prefill_tokens += len(feed)
                self.followup_tokens_skipped += start
            if self._robust:
                rc = self.robust_counters
                rc.klass(req.priority)["admitted"] += 1
                if req.out_tokens:           # resumed after preemption
                    rc.reprefill_tokens += len(feed)
                    rc.reprefill_skipped += start
                self._prio[slot] = int(req.priority)
                self._qseq[slot] = entry.seq
                self._submitted_ts[slot] = entry.submit_ts
                self._admit_seq[slot] = self._admit_counter
                self._admit_counter += 1
            self._slots[slot] = req
            self._feeds[slot] = feed
            self._live[slot] = True
            self._lengths[slot] = start
            self._tables_dev = None          # forked blocks joined the table
            self._lengths_dev = None
            self._prompt_pos[slot] = start
            self._resv[slot] = need
            self._temps[slot] = req.temperature
            # matched blocks are indexed already: registration resumes past
            # them, threading the indexed chain's tail as the parent
            self._reg_level[slot] = len(matched)
            self._reg_parent[slot] = matched[-1][1] if matched else -1

    # ------------------------------------------------------------ prefix --

    def _match_prefix(self, prompt) -> list[tuple[tuple, int]]:
        """Longest run of full-block chunks of `prompt` cached in the trie,
        prompt and decode blocks alike (PrefixTrie.match)."""
        return self.trie.match(prompt)

    def _register_blocks(self, slot: int, req: Request,
                         covered: int | None = None):
        """Index every block of this slot now FULLY covered by tokens whose
        values are known: the prompt-covered prefix, or with decode sharing
        the whole written sequence prompt + out_tokens (positions [0,
        length) hold exactly those). Boundary blocks mixing prompt and
        generated tokens count as "decode". The watermark makes this O(1)
        amortized; on equal content the first writer wins, and the walk
        threads the INDEXED block into the next level's key.

        `covered` overrides the written-token count: the async loop commits
        one step behind dispatch, when _lengths/_prompt_pos already hold
        the in-flight step's advance, so the commit passes its own record's
        coverage. The in-flight step writes only at or past it, so no block
        it writes is registered (shared) while it runs."""
        bs = self.block_size
        plen = len(req.prompt)
        if covered is None:
            covered = (int(self._lengths[slot]) if self.decode_sharing
                       else min(int(self._prompt_pos[slot]), plen))
        n_levels = covered // bs
        parent = int(self._reg_parent[slot])
        for j in range(int(self._reg_level[slot]), n_levels):
            origin = "prompt" if (j + 1) * bs <= plen else "decode"
            parent = self.trie.insert(
                parent, sequence_chunk(req.prompt, req.out_tokens, j, bs),
                int(self._tables[slot, j]), origin)
        if n_levels > self._reg_level[slot]:
            self._reg_level[slot] = n_levels
            self._reg_parent[slot] = parent

    def _evict_one(self, protect=frozenset()) -> bool:
        """Reclaim one LRU index-only leaf block; False when nothing is
        evictable. Live slots' watermark PARENTS are protected: under
        first-writer-wins a slot's cached parent may be another chain's
        block it holds no reference to, and recycling that id would thread
        new children under a stranger's history."""
        protect = set(protect) | {int(p) for p in
                                  self._reg_parent[self._live] if p >= 0}
        if self.trie.evict_one(protect) is None:
            return False
        self.prefix_evictions += 1
        return True

    def _alloc_block(self) -> int:
        """Pool alloc with eviction fallback: cached prefixes are a best-
        effort use of free space, reclaimed before exhaustion."""
        if self.alloc.num_free == 0:
            self._evict_one()
        return self.alloc.alloc()

    def _cow_shared(self, t_valid: np.ndarray, journal: list | None = None):
        """Copy-on-write: a slot only writes into blocks of refcount 1. A
        shared block in this step's write range [length, length + t_valid)
        is copied to a new block first (across all layers, scales too), the
        table entry is swapped and the writer's reference on the original
        dropped. With `journal`, each copy records ("cow", slot, j, old,
        new, resv_dec) after the swap, so _unwind_allocs can re-fork the
        source and return the copy on a mid-phase BlockPoolExhausted."""
        bs = self.block_size
        for slot in np.flatnonzero(t_valid > 0):
            lo = int(self._lengths[slot])
            hi = lo + int(t_valid[slot])
            for j in range(lo // bs, -(-hi // bs)):
                blk = int(self._tables[slot, j])
                if self.alloc.ref(blk) <= 1:
                    continue
                new = self._alloc_block()
                resv_dec = self._resv[slot] > 0
                self._resv[slot] = max(self._resv[slot] - 1, 0)
                _copy_block_kv(self._cache["layers"], blk, new)
                self.alloc.free([blk])       # drop this slot's reference
                self._tables[slot, j] = new
                self._tables_dev = None
                self.cow_copies += 1
                if journal is not None:
                    journal.append(("cow", slot, j, blk, new,
                                    bool(resv_dec)))

    def clear_prefix_cache(self):
        """Drop every index reference; blocks with no live holder return to
        the free list. Session histories survive (a later turn re-prefills).
        Live slots' watermarks reset to the root, so registration re-walks
        from the slot's own table."""
        self.trie.clear()
        self._reg_level[:] = 0
        self._reg_parent[:] = -1

    def prefix_stats(self) -> dict:
        """Cumulative prefix-sharing and speculative telemetry, the JAX
        engine's keys. prefill_tokens counts every admitted prompt token
        (the skip-rate denominator); the hit and skip counters are split by
        matched-block origin (prompt / decode); followup_* restrict the
        token counters to session follow-up turns. The spec_* and *_tokens
        draft counters cover speculative decoding (drafted = accepted +
        rejected; acceptance_rate is None until something was drafted)."""
        cached = self.trie.origin_counts()
        return dict(
            spec_steps=self.spec_steps,
            spec_rollbacks=self.spec_rollbacks,
            tokens_drafted=self.drafted_tokens,
            tokens_accepted=self.accepted_tokens,
            tokens_rejected=self.rejected_tokens,
            acceptance_rate=(self.accepted_tokens / self.drafted_tokens
                             if self.drafted_tokens else None),
            lookups=self.prefix_lookups, hits=self.prefix_hits,
            hit_rate=self.prefix_hits / max(self.prefix_lookups, 1),
            prompt_hits=self.prompt_hits, decode_hits=self.decode_hits,
            prefill_tokens=self.prefill_tokens_total,
            prefill_tokens_skipped=self.prefill_tokens_skipped,
            prompt_tokens_skipped=self.prompt_tokens_skipped,
            decode_tokens_skipped=self.decode_tokens_skipped,
            skip_rate=(self.prefill_tokens_skipped
                       / max(self.prefill_tokens_total, 1)),
            followup_prefill_tokens=self.followup_prefill_tokens,
            followup_tokens_skipped=self.followup_tokens_skipped,
            followup_skip_rate=(self.followup_tokens_skipped
                                / max(self.followup_prefill_tokens, 1)),
            cow_copies=self.cow_copies, evictions=self.prefix_evictions,
            cached_blocks=len(self.trie),
            cached_prompt_blocks=cached["prompt"],
            cached_decode_blocks=cached["decode"],
            pad_lanes_skipped=self.pad_lanes_skipped)

    def padding_stats(self) -> dict:
        """Token-lane telemetry: efficiency = valid lanes / padded lanes over
        every step so far, plus the estimated lanes the lockstep layout would
        have burned extra; and (TILE_STATS, packed steps) tile_fill = the
        valid rows of the packed attention kernel's tiles over their rows."""
        return dict(lanes_valid=self.lanes_valid,
                    lanes_total=self.lanes_total,
                    efficiency=self.lanes_valid / max(self.lanes_total, 1),
                    pad_lanes_skipped=self.pad_lanes_skipped,
                    tile_rows_valid=self.tile_rows_valid,
                    tile_rows_total=self.tile_rows_total,
                    tile_fill=(self.tile_rows_valid
                               / max(self.tile_rows_total, 1)))

    def _count_tiles(self, t_valid, width: int):
        valid, total = tile_rows(t_valid, width, self._tile_tokens,
                                 self._group)
        self.tile_rows_valid += valid
        self.tile_rows_total += total

    # ------------------------------------------------------------- slots --

    def _release_slot(self, slot: int):
        """Free a slot's block references and reset its host state, the
        common core of finish, preemption, cancellation and failure. Blocks
        also referenced by the trie or other slots stay cached."""
        row = self._tables[slot]
        self.alloc.free(row[row >= 0])
        row[:] = -1
        self._tables_dev = None
        self._lengths_dev = None
        self._resv[slot] = 0
        self._slots[slot] = None
        self._feeds[slot] = None
        self._live[slot] = False
        self._lengths[slot] = 0
        self._prompt_pos[slot] = 0
        self._temps[slot] = 0.0
        self._reg_level[slot] = 0
        self._reg_parent[slot] = -1
        # async loop: the in-flight step may hold an uncommitted sample of
        # this slot (and have written a row into the blocks just freed,
        # inert: see the module docstring). Dead-mark it so the commit
        # discards the token, as if the slot had never been scheduled.
        if self._pending is not None:
            self._pending["dead"][slot] = True

    def _finish(self, slot: int) -> Request:
        req = self._slots[slot]
        req.done = True
        if self.telemetry.enabled:
            self.telemetry.metrics.on_finish(req.uid, len(req.out_tokens))
        session = self._req_session.pop(id(req), None)
        if session is not None:
            # the session's next turn prepends this full history
            self._sessions[session] = np.concatenate(
                [np.asarray(req.prompt, np.int32),
                 np.asarray(req.out_tokens, np.int32)])
            self._session_busy.discard(session)
        self._followups.discard(id(req))
        if self._robust:
            self.robust_counters.klass(req.priority)["finished"] += 1
        self._release_slot(slot)
        return req

    def _preempt_slot(self, slot: int) -> Request:
        """Preemption by block reclaim: free the slot's block references and
        re-queue the request with its generated tokens as resume state,
        keeping its ORIGINAL queue seq and deadline clock. Re-admission
        re-prefills prompt + out_tokens (mostly skipped through the trie
        when sharing is on), so the output equals a never-preempted run's."""
        req = self._slots[slot]
        seq = int(self._qseq[slot])
        ts = float(self._submitted_ts[slot])
        self._release_slot(slot)
        req.preemptions += 1
        rc = self.robust_counters
        rc.preemptions += 1
        rc.klass(req.priority)["preempted"] += 1
        self._queue.requeue(req, seq=seq, submit_ts=ts)
        return req

    def _drop_request(self, req: Request, reason: str) -> Request:
        """A request ends without completing (shed, deadline, cancel, device
        error, NaN logits): its session turn is aborted with no history
        written, and the session is reusable at once."""
        req.failed = True
        req.fail_reason = reason
        session = self._req_session.pop(id(req), None)
        if session is not None:
            self._session_busy.discard(session)
        self._followups.discard(id(req))
        if self.telemetry.enabled:
            self.telemetry.metrics.on_drop(req.uid)
        return req

    def _fail_slot(self, slot: int, reason: str) -> Request:
        req = self._slots[slot]
        self._release_slot(slot)
        return self._drop_request(req, reason)

    def _count_deadline(self, req: Request, reason: str):
        rc = self.robust_counters
        if reason == "deadline_ttft":
            rc.deadline_miss_ttft += 1
        else:
            rc.deadline_miss_e2e += 1
        rc.klass(req.priority)["deadline_misses"] += 1

    def _expire_deadlines(self, now: float) -> list[Request]:
        """Deadlines at the step boundary: queued requests past TTFT/E2E
        expire in place (AdmissionQueue.expire); running ones are failed and
        their blocks freed. Misses count per class."""
        failed = []
        for req, reason in self._queue.expire(now):
            self._count_deadline(req, reason)
            failed.append(self._drop_request(req, reason))
        for slot in np.flatnonzero(self._live):
            req = self._slots[slot]
            age = now - float(self._submitted_ts[slot])
            if (req.deadline_ttft is not None and not req.out_tokens
                    and age > req.deadline_ttft):
                self._count_deadline(req, "deadline_ttft")
                failed.append(self._fail_slot(int(slot), "deadline_ttft"))
            elif req.deadline_e2e is not None and age > req.deadline_e2e:
                self._count_deadline(req, "deadline_e2e")
                failed.append(self._fail_slot(int(slot), "deadline_e2e"))
        return failed

    def _grow_tables(self, t_valid: np.ndarray, journal: list | None = None):
        """Alloc-on-frontier-crossing: extend each slot's table to cover
        lengths + t_valid before the step writes there. On int8 pools each
        new block is listed FRESH (_take_fresh).

        Returns the allocations [(slot, table index, block, reservation
        decremented), ...] in allocation order: a speculative step grows in
        two phases (committed coverage, then draft lanes) and frees the
        second phase's list in REVERSE on rejection, which restores the free
        list and the reservations exactly. With `journal`, each allocation
        is also appended there as ("alloc", slot, j, block, resv_dec), so a
        mid-phase BlockPoolExhausted unwinds exactly (_unwind_allocs): the
        allocator raises before mutating."""
        allocs = []
        for slot in np.flatnonzero(t_valid > 0):
            needed = -(-int(self._lengths[slot] + t_valid[slot])
                       // self.block_size)
            row = self._tables[slot]
            held = int((row >= 0).sum())
            for j in range(held, needed):
                row[j] = self._alloc_block()
                self._tables_dev = None
                if self.quantized:
                    self._fresh.append(int(row[j]))
                resv_dec = self._resv[slot] > 0
                self._resv[slot] = max(self._resv[slot] - 1, 0)
                allocs.append((slot, j, int(row[j]), bool(resv_dec)))
                if journal is not None:
                    journal.append(("alloc", slot, j, int(row[j]),
                                    bool(resv_dec)))
        return allocs

    def _unwind_allocs(self, journal: list):
        """Roll a failed alloc/COW phase back in REVERSE journal order:
        allocator, tables, reservations and the fresh-block list return to
        their pre-phase state (the free list byte-identically: frees append
        in the reverse of the pops). A COW whose source block was evicted
        later in the same phase cannot re-fork it; the slot keeps its
        private copy, valid though no longer shared."""
        if journal:
            self._tables_dev = None
        for op in reversed(journal):
            if op[0] == "alloc":
                _, slot, j, blk, resv_dec = op
                if self.quantized and self._fresh and self._fresh[-1] == blk:
                    self._fresh.pop()
                self.alloc.free([blk])
                self._tables[slot, j] = -1
                if resv_dec:
                    self._resv[slot] += 1
            else:                            # ("cow", slot, j, old, new, dec)
                _, slot, j, old, new, resv_dec = op
                if self.alloc.ref(old):
                    self.alloc.fork(old)
                    self.alloc.free([new])
                    self._tables[slot, j] = old
                    self.cow_copies -= 1
                if resv_dec:
                    self._resv[slot] += 1

    def _take_fresh(self) -> np.ndarray:
        """Drain the fresh-block list into the step's array, padded to its
        cap with the trash block (whose scale is safely re-zeroed)."""
        if len(self._fresh) > self._fresh_cap:
            raise AssertionError(
                f"fresh-block list {len(self._fresh)} exceeds its cap "
                f"{self._fresh_cap}: the per-step allocation bound is wrong")
        out = np.full(self._fresh_cap, TRASH_BLOCK, np.int32)
        out[:len(self._fresh)] = self._fresh
        self._fresh.clear()
        return out

    def _propose_drafts(self, live, remaining) -> dict[int, list[int]]:
        """Draft tokens for every DECODING slot (remaining == 0): continue
        the slot's sequence (prompt + output) along the prefix trie
        (extend_path), topping up from the n-gram prompt lookup over its own
        tokens when the trie path runs dry. At most draft_len tokens, never
        past the request budget's LAST token (its KV is never written),
        never past cache-full, within the chunk cap; drafts after a draft
        EOS are dropped (the EOS itself stays). Returns {slot: drafts} with
        only non-empty entries."""
        drafts: dict[int, list[int]] = {}
        for slot in np.flatnonzero(np.asarray(live)
                                   & (np.asarray(remaining) == 0)):
            req = self._slots[slot]
            k = min(self.draft_len,
                    req.max_new_tokens - len(req.out_tokens) - 1,
                    self.max_len - 2 - int(self._lengths[slot]),
                    self._chunk_cap - 1)
            if k <= 0:
                continue
            seq = np.concatenate([np.asarray(req.prompt, np.int32),
                                  np.asarray(req.out_tokens, np.int32)])
            d = list(self.trie.extend_path(seq, k)
                     if self.prefix_sharing else [])
            while len(d) < k:
                # the n-gram top-up iterates on the extended sequence: one
                # call stops at the output's loop period
                more = ngram_propose(
                    np.concatenate([seq, np.asarray(d, np.int32)]),
                    k - len(d))
                if not more:
                    break
                d += more
            d = [int(x) for x in d[:k]]
            if self.eos_id is not None and self.eos_id in d:
                d = d[:d.index(self.eos_id) + 1]
            if d:
                drafts[slot] = d
        return drafts

    def _alloc_and_cow(self, t_valid: np.ndarray, remaining=None) -> list:
        """Grow the tables and copy shared blocks for one step, journaled:
        a BlockPoolExhausted mid-phase is unwound before it propagates.

        A verify step (`remaining` given) grows in two phases: the blocks a
        never-drafted step allocates are popped first (with COW on that
        committed coverage: the one held block a decode slot writes into is
        the one holding position `length`), the draft-only blocks after, so
        rejection's reverse-order frees restore the free list exactly.
        Returns the draft phase's allocations."""
        journal: list[tuple] = []
        try:
            t_commit = t_valid if remaining is None else np.where(
                remaining > 0, t_valid, np.minimum(t_valid, 1)).astype(
                np.int32)
            self._grow_tables(t_commit, journal)
            if self.prefix_sharing:
                self._cow_shared(t_commit, journal)
            if remaining is None:
                return []
            return self._grow_tables(t_valid, journal)
        except BlockPoolExhausted:
            self._unwind_allocs(journal)
            raise

    def _write_positions(self, t_valid: np.ndarray, width: int) -> np.ndarray:
        """Flat pool scatter targets (B, width): token i of slot b lands at
        table[b, (len+i)//bs]*bs + (len+i)%bs while i < t_valid[b]; invalid
        lanes are steered into the trash block (position i of block 0).
        _cow_shared ran before this, so no target block is shared."""
        bs = self.block_size
        wp = np.tile(np.arange(width, dtype=np.int64)[None, :],
                     (self.max_batch, 1)) + TRASH_BLOCK * bs
        for slot in np.flatnonzero(t_valid > 0):
            tv = int(t_valid[slot])
            wp[slot, :tv] = _slot_write_targets(
                self._tables[slot], int(self._lengths[slot]), tv, bs)
        return wp.astype(np.int32)

    def _dev(self, a) -> torch.Tensor:
        """Upload a host array for a step. On the card a pinned,
        non-blocking copy: it reads its own pinned buffer, so the host
        array may change at once, and unlike a blocking copy it does not
        wait for the card's queue to drain."""
        a = np.asarray(a)
        if self.device.type != "cuda":
            return torch.tensor(a, device=self.device)
        if not a.flags.c_contiguous:
            a = a.copy()
        return torch.from_numpy(a).pin_memory().to(self.device,
                                                   non_blocking=True)

    def _step_cache(self, **extras):
        """The model cache of one step: the pools and the step's extras, and
        on int8 pools the fresh blocks. Returns (cache, the fresh-block
        array or None)."""
        fresh = None
        if self.quantized:
            fresh = self._take_fresh()
            extras["fresh_blocks"] = self._dev(fresh)
        return dict(self._cache, **extras), fresh

    def _fence(self):
        """The profiler's device-phase fence, only while a fencing profiler
        is on (StepProfiler.fence)."""
        prof = self.telemetry.profiler
        if prof.enabled and prof.fence:
            T.device_fence(self.device)

    # ------------------------------------------------------ device seams --

    def _lockstep_forward(self, tokens, cache, last_lane):
        """Device half of a lockstep step: (B, width) tokens, each slot's
        logits at its last valid lane. Returns ((B, V) logits, cache)."""
        self._device_entered = True
        with torch.inference_mode():
            x, cache, _ = M.forward(self.w, self.hccs, {"tokens": tokens},
                                    self.cfg, cache)
            h_last = x[torch.arange(x.shape[0], device=x.device),
                       last_lane][:, None]                     # (B, 1, D)
            with T.span("repro.lm_head"):
                logits = M.logits_from_hidden(self.w, h_last,
                                              self.cfg)[:, 0]
        return logits, cache

    def _packed_forward(self, tokens, positions, cache, lane_idx):
        """Device half of a packed step: a (1, width) ragged token batch,
        each slot's logits at its last packed lane. Returns ((B, V) logits,
        cache)."""
        self._device_entered = True
        with torch.inference_mode():
            x, cache, _ = M.forward(self.w, self.hccs,
                                    {"tokens": tokens,
                                     "positions": positions},
                                    self.cfg, cache)
            h_last = x[0, lane_idx][:, None]                   # (B, 1, D)
            with T.span("repro.lm_head"):
                logits = M.logits_from_hidden(self.w, h_last,
                                              self.cfg)[:, 0]
        return logits, cache

    def _packed_spec_forward(self, tokens, positions, cache, lane_grid):
        """Device half of a speculative verify step: the packed forward, each
        slot reading a ROW of verify lanes (lane_grid (B, 1 + draft_len)).
        Returns ((B, 1 + draft_len, V) logits, cache); on int8 pools the
        cache's layers carry the staged raw rows."""
        self._device_entered = True
        with torch.inference_mode():
            x, cache, _ = M.forward(self.w, self.hccs,
                                    {"tokens": tokens,
                                     "positions": positions},
                                    self.cfg, cache)
            with T.span("repro.lm_head"):
                logits = M.logits_from_hidden(self.w, x[0][lane_grid],
                                              self.cfg)
        return logits, cache

    def _packed_async_forward(self, tokens, tok_src, prev_sampled, positions,
                              cache, lane_idx):
        """Device half of an async-loop packed step: the packed forward,
        with (a) the token indirection — a lane with tok_src >= 0 feeds the
        previous step's still-unlanded device sample of slot tok_src, so
        the host never waits for it to re-upload it — and (b) the greedy
        sample taken on the card (argmax, first maximal index, as
        sample_tokens' greedy path), which feeds the next step's
        indirection. Returns ((B, V) logits, (B,) int32 sampled, cache)."""
        self._device_entered = True
        with torch.inference_mode():
            src = torch.clamp(tok_src, 0, prev_sampled.shape[0] - 1)
            fed = torch.where(tok_src >= 0, prev_sampled[src], tokens[0])
            x, cache, _ = M.forward(self.w, self.hccs,
                                    {"tokens": fed[None],
                                     "positions": positions},
                                    self.cfg, cache)
            h_last = x[0, lane_idx][:, None]                   # (B, 1, D)
            with T.span("repro.lm_head"):
                logits = M.logits_from_hidden(self.w, h_last,
                                              self.cfg)[:, 0]
            sampled = torch.argmax(logits, dim=-1).to(torch.int32)
        return logits, sampled, cache

    def _call_device(self, fn, *args):
        """Run one step's device half. In robust mode a failure raised
        before the seam began (the seam sets _device_entered first) is
        retried up to max_device_retries times: the in-place pools are
        untouched, so the call repeats exactly; past the budget it raises
        DeviceStepFailed, on which step() fails every live slot with reason
        "device_error". A failure raised inside the seam may have written
        the pools part way, so it is neither retried nor absorbed: it
        propagates out of step(). The call is the `repro.forward` span."""
        if not self._robust:
            with T.span("repro.forward"):
                return fn(*args)
        retries = self._adm.max_device_retries
        for attempt in range(retries + 1):
            self._device_entered = False
            try:
                with T.span("repro.forward"):
                    return fn(*args)
            except Exception as exc:
                if self._device_entered:
                    raise
                self.robust_counters.device_retries += 1
                if attempt == retries:
                    raise DeviceStepFailed(
                        f"device step failed {retries + 1} times") from exc

    # ------------------------------------------------------------- steps --

    def _step(self, width: int) -> list[Request]:
        """One lockstep batched step: chunk (width == block_size, some slot
        is mid-prompt) or pure decode (width == 1). Returns newly finished."""
        prof = self.telemetry.profiler
        live = self._live.copy()
        self.occupancy_sum += float(live.mean())
        self.occupancy_steps += 1
        with prof.phase("schedule"):
            t_valid = np.zeros(self.max_batch, np.int32)
            toks = np.zeros((self.max_batch, width), np.int32)
            for slot in np.flatnonzero(live):
                feed = self._feeds[slot]
                pos = int(self._prompt_pos[slot])
                if pos < len(feed):          # chunked prefill
                    tv = min(width, len(feed) - pos)
                    toks[slot, :tv] = feed[pos:pos + tv]
                    t_valid[slot] = tv
                else:                        # decode rides along, t_valid 1
                    toks[slot, 0] = self._last[slot]
                    t_valid[slot] = 1
            self.lanes_valid += int(t_valid.sum())
            self.lanes_total += self.max_batch * width
        with prof.phase("alloc_cow"):
            self._alloc_and_cow(t_valid)
        with prof.phase("schedule"):
            dev = self._dev
            # the mirrors: the tables change only when a frontier crosses a
            # block (every block_size tokens of a decode slot)
            cache, _ = self._step_cache(
                length=self._device_lengths(),
                block_table=self._device_tables(),
                write_pos=dev(self._write_positions(t_valid, width)),
                kv_len=dev(self._lengths + t_valid))
            # each slot samples from its LAST VALID lane (t_valid - 1):
            # riding decode slots have t_valid == 1, mid-prompt slots
            # discard theirs
            tokens = dev(toks)
            last_lane = dev(np.maximum(t_valid - 1, 0).astype(np.int64))
        with prof.phase("device"):
            logits, _ = self._call_device(self._step_fn, tokens, cache,
                                          last_lane)
            self._fence()
        if width == 1:
            self.decode_steps += 1
        return self._sample_and_finish(live, t_valid, logits)

    def _grid_extras(self, t_valid, sid, off, width: int) -> dict:
        """The per-slot STE grid's steering (the packed step without the
        kernel): cell (slot, i) of the (B, Wb) grid is the slot's i-th token
        this step, Wb the smallest grid rung covering the largest per-slot
        chunk; grid_pos maps packed lanes to flat cells, pad lanes to the
        spill row B * Wb."""
        dev = self._dev
        max_tv = max(int(t_valid.max()), 1)
        wb = next(w for w in self._grid_widths if w >= max_tv)
        q_pos_grid = (self._lengths[:, None]
                      + np.arange(wb, dtype=np.int32)[None, :])
        grid_pos = np.full(width, self.max_batch * wb, np.int32)
        valid_lane = sid >= 0
        grid_pos[valid_lane] = (sid[valid_lane] * wb
                                + (np.flatnonzero(valid_lane)
                                   - off[sid[valid_lane]]))
        return dict(q_pos_grid=dev(q_pos_grid.astype(np.int32)),
                    grid_pos=dev(grid_pos),
                    kv_len_slot=dev((self._lengths + t_valid)
                                    .astype(np.int32)))

    def _count_pad_lanes(self, live, remaining, t_valid, width: int):
        """Lanes the lockstep layout would burn for the same scheduled work
        (see the JAX engine's _step_packed_sync for the accounting)."""
        if (remaining > 0).any():
            n_lockstep = -(-int(t_valid.max()) // self.block_size)
            riders = int((live & (remaining == 0)).sum())
            lockstep = n_lockstep * self.max_batch * self.block_size
            self.pad_lanes_skipped += max(
                lockstep - width - (n_lockstep - 1) * riders, 0)

    def _step_packed(self) -> list[Request]:
        """One PACKED engine step: the synchronous one, or with async_loop
        the pipelined one (module docstring)."""
        if self.async_loop:
            return self._step_packed_async()
        return self._step_packed_sync()

    def _step_packed_sync(self) -> list[Request]:
        """One PACKED token step: the step's work flattened into a ragged
        (1, width) token batch with per-token slot ids, positions and causal
        frontiers; width is the smallest ladder rung covering the pending
        work. With speculative decoding, decode slots add their draft lanes
        and the step verifies them (_verify_and_finish). Returns newly
        finished requests."""
        prof = self.telemetry.profiler
        live = self._live.copy()
        self.occupancy_sum += float(live.mean())
        self.occupancy_steps += 1
        with prof.phase("schedule"):
            remaining = np.zeros(self.max_batch, np.int64)
            for slot in np.flatnonzero(live):
                remaining[slot] = (len(self._feeds[slot])
                                   - int(self._prompt_pos[slot]))
            drafts = (self._propose_drafts(live, remaining)
                      if self.speculative else {})
            n_drafts = np.zeros(self.max_batch, np.int64)
            for slot, d in drafts.items():
                n_drafts[slot] = len(d)
            needed = int(np.where(
                live, np.minimum(np.maximum(remaining, 1) + n_drafts,
                                 self._chunk_cap), 0).sum())
            needed = min(needed, self.token_budget)
            width = next(w for w in self._widths if w >= needed)
            if drafts:
                # draft-worthwhileness gate: verify lanes only earn a WIDER
                # rung when they fill at least half the extra lanes it pads
                # in; drafts inside the plain rung are free. Dropping a
                # step's drafts is just not drafting: outputs are unchanged.
                plain = min(int(np.where(
                    live, np.minimum(np.maximum(remaining, 1),
                                     self._chunk_cap), 0).sum()),
                    self.token_budget)
                w_plain = next(w for w in self._widths if w >= plain)
                if 2 * int(n_drafts.sum()) < width - w_plain:
                    drafts = {}
                    n_drafts[:] = 0
                    width = w_plain
            t_valid = schedule_step_tokens(live, remaining, width,
                                           self._chunk_cap,
                                           drafts=n_drafts if drafts
                                           else None)
            if drafts:
                # the scheduler may truncate drafts to fit the budget
                for slot in list(drafts):
                    d = drafts[slot][:max(int(t_valid[slot]) - 1, 0)]
                    n_drafts[slot] = len(d)
                    if d:
                        drafts[slot] = d
                    else:
                        del drafts[slot]
            sid, off = pack_slot_ids(t_valid, width)
            toks = np.zeros(width, np.int32)
            positions = np.zeros(width, np.int32)
            for slot in np.flatnonzero(t_valid > 0):
                tv = int(t_valid[slot])
                o = int(off[slot])
                if remaining[slot] > 0:      # prefill chunk (budget-sized)
                    pos = int(self._prompt_pos[slot])
                    toks[o:o + tv] = self._feeds[slot][pos:pos + tv]
                else:                        # decode: one lane (+ drafts)
                    toks[o] = self._last[slot]
                    if tv > 1:
                        toks[o + 1:o + tv] = drafts[slot]
                positions[o:o + tv] = (int(self._lengths[slot])
                                       + np.arange(tv))
            self.lanes_valid += int(t_valid.sum())
            self.lanes_total += width
            self._count_tiles(t_valid, width)
            self._count_pad_lanes(live, remaining, t_valid, width)
        with prof.phase("alloc_cow"):
            draft_allocs = self._alloc_and_cow(
                t_valid, remaining if drafts else None)
        with prof.phase("schedule"):
            wp = packed_write_positions(t_valid, off, self._tables,
                                        self._lengths, self.block_size,
                                        width)
            kv_len = np.where(sid >= 0, positions + 1, 0).astype(np.int32)
            lane_idx = np.maximum(off + t_valid - 1, 0)
            dev = self._dev
            extras = dict(block_table=self._device_tables(),
                          write_pos=dev(wp[None]), kv_len=dev(kv_len),
                          slot_ids=dev(sid))
            snap_blocks = None
            if drafts and self.quantized:
                # the blocks the drafting slots' verify rows can touch:
                # draft lanes fold with a clamped scale (draft_rows), and
                # after verification the snapshot is restored and exactly
                # the committed rows re-folded from the rows stage_rows
                # hands back
                bs = self.block_size
                blks = []
                for slot in sorted(drafts):
                    lo = int(self._lengths[slot])
                    hi = lo + int(t_valid[slot])
                    blks.extend(int(self._tables[slot, j])
                                for j in range(lo // bs, -(-hi // bs)))
                snap_blocks = np.full(self._snap_cap, TRASH_BLOCK, np.int64)
                snap_blocks[:len(blks)] = blks
                draft_rows = np.zeros(width, bool)
                for slot in drafts:
                    draft_rows[off[slot] + 1:
                               off[slot] + int(t_valid[slot])] = True
                extras.update(stage_rows=dev(np.zeros((), np.int32)),
                              draft_rows=dev(draft_rows[None]))
            if self._use_grid:
                extras.update(self._grid_extras(t_valid, sid, off, width))
            cache, fresh_np = self._step_cache(**extras)
            tokens, pos_dev = dev(toks[None]), dev(positions[None])
            if drafts:
                # verify lanes: row i of a drafting slot is its i-th packed
                # lane (clamped to its last); other slots repeat their
                # sampling lane
                lane_grid = np.tile(lane_idx[:, None],
                                    (1, self.draft_len + 1))
                for slot in drafts:
                    lane_grid[slot] = off[slot] + np.minimum(
                        np.arange(self.draft_len + 1), int(t_valid[slot]) - 1)
                lanes = dev(lane_grid.astype(np.int64))
            else:
                lanes = dev(lane_idx.astype(np.int64))
        snap = staged = None
        with prof.phase("device"):
            if not drafts:
                logits, _ = self._call_device(self._packed_fn, tokens,
                                              pos_dev, cache, lanes)
            else:
                if snap_blocks is not None:
                    # a copy, before the forward writes the pools in place
                    # (its fresh-block reset and folds included)
                    with torch.inference_mode():
                        snap = _gather_block_state(self._cache["layers"],
                                                   dev(snap_blocks))
                logits, out = self._call_device(self._packed_spec_fn, tokens,
                                                pos_dev, cache, lanes)
                if snap is not None:
                    staged = (out["layers"]["staged_k"],
                              out["layers"]["staged_v"])
            self._fence()
        if not drafts:
            return self._sample_and_finish(live, t_valid, logits)
        return self._verify_and_finish(live, t_valid, drafts, off, wp,
                                       logits, draft_allocs, snap_blocks,
                                       snap, staged, fresh_np)

    # ------------------------------------------- pipelined async loop --

    def _step_packed_async(self) -> list[Request]:
        """One step of the pipelined loop: dispatch step N+1's packed batch,
        THEN commit step N's, so step N's host bookkeeping overlaps step
        N+1 on the card.

        Overlap needs step N+1's schedule not to depend on step N's token
        values: true exactly when every live slot samples greedily and
        nothing drafts. Otherwise the step commits and then runs the sync
        step. Step N's commit can still end a slot: at its token budget or
        the decode cache-full bound, both predictable without the token,
        so those slots stay out of the dispatch; an EOS slot gets one extra
        in-flight step whose writes die with the slot's release."""
        live = self._live
        hot = bool((live & (self._temps > 0.0)).any())
        if self.speculative or hot:
            finished = self._commit_pending()
            if self._live.any():
                self.async_sync_fallbacks += 1
                finished.extend(self._step_packed_sync())
            return finished
        p = self._pending
        sched_live = live.copy()
        if p is not None:
            # slots whose pending sample finishes them at commit: scheduling
            # them would grow frontiers past their end
            for slot in np.flatnonzero(p["samples"] & ~p["dead"] & live):
                req = self._slots[slot]
                if req is None:
                    continue
                if (len(req.out_tokens) + 1 >= req.max_new_tokens
                        or (not p["was_prefill"][slot]
                            and p["lengths_after"][slot]
                            >= self.max_len - 1)):
                    sched_live[slot] = False
        if not sched_live.any():
            return self._commit_pending()
        new_pending = self._dispatch_packed_async(sched_live)
        old, self._pending = self._pending, new_pending
        if old is None:
            return []
        self.async_overlapped_steps += 1
        # commits that finish or fail a slot dead-mark new_pending through
        # _release_slot: the in-flight step's writes for it become inert
        return self._commit_pending_record(old)

    def _dispatch_packed_async(self, live) -> dict:
        """Schedule, allocate and enqueue one packed step WITHOUT waiting
        for its results (the greedy front half of _step_packed_sync, no
        drafts). Advances _lengths/_prompt_pos at dispatch, so the next
        dispatch schedules against the post-step state, and returns the
        pending record _commit_pending lands one step later. Raises
        BlockPoolExhausted with its journal unwound, as the sync path."""
        prof = self.telemetry.profiler
        self.occupancy_sum += float(live.mean())
        self.occupancy_steps += 1
        p = self._pending
        with prof.phase("schedule"):
            remaining = np.zeros(self.max_batch, np.int64)
            for slot in np.flatnonzero(live):
                remaining[slot] = (len(self._feeds[slot])
                                   - int(self._prompt_pos[slot]))
            needed = int(np.where(
                live, np.minimum(np.maximum(remaining, 1), self._chunk_cap),
                0).sum())
            needed = min(needed, self.token_budget)
            width = next(w for w in self._widths if w >= needed)
            t_valid = schedule_step_tokens(live, remaining, width,
                                           self._chunk_cap)
            sid, off = pack_slot_ids(t_valid, width)
            toks = np.zeros(width, np.int32)
            # decode-lane token indirection: tok_src[lane] = the slot whose
            # token is the in-flight step's device sample (not landed on
            # the host); -1 = fed from toks
            tok_src = np.full(width, -1, np.int32)
            positions = np.zeros(width, np.int32)
            for slot in np.flatnonzero(t_valid > 0):
                tv = int(t_valid[slot])
                o = int(off[slot])
                if remaining[slot] > 0:      # prefill chunk (host tokens)
                    pos = int(self._prompt_pos[slot])
                    toks[o:o + tv] = self._feeds[slot][pos:pos + tv]
                elif (p is not None and p["samples"][slot]
                        and not p["dead"][slot]):
                    tok_src[o] = slot        # step N's device sample
                else:
                    toks[o] = self._last[slot]
                positions[o:o + tv] = (int(self._lengths[slot])
                                       + np.arange(tv))
            self.lanes_valid += int(t_valid.sum())
            self.lanes_total += width
            self._count_tiles(t_valid, width)
            self._count_pad_lanes(live, remaining, t_valid, width)
        with prof.phase("alloc_cow"):
            self._alloc_and_cow(t_valid)
        with prof.phase("schedule"):
            wp = packed_write_positions(t_valid, off, self._tables,
                                        self._lengths, self.block_size,
                                        width)
            kv_len = np.where(sid >= 0, positions + 1, 0).astype(np.int32)
            lane_idx = np.maximum(off + t_valid - 1, 0)
            dev = self._dev
            extras = dict(block_table=self._device_tables(),
                          write_pos=dev(wp[None]), kv_len=dev(kv_len),
                          slot_ids=dev(sid))
            if self._use_grid:
                extras.update(self._grid_extras(t_valid, sid, off, width))
            cache, _ = self._step_cache(**extras)
            if p is not None:
                prev = p["sampled"]
            else:
                prev = torch.zeros(self.max_batch, dtype=torch.int32,
                                   device=self.device)
            args = (dev(toks[None]), dev(tok_src), prev,
                    dev(positions[None]), cache,
                    dev(lane_idx.astype(np.int64)))
        with prof.phase("device"):
            # no fence: landing the results is _commit_pending's job, one
            # step later. The sampled tokens go to pinned memory by a
            # non-blocking copy whose event the commit waits on.
            logits, sampled, _ = self._call_device(self._packed_async_fn,
                                                   *args)
            event = None
            if self.device.type == "cuda":
                host = torch.empty(self.max_batch, dtype=torch.int32,
                                   pin_memory=True)
                with torch.inference_mode():
                    host.copy_(sampled, non_blocking=True)
                event = torch.cuda.Event()
                event.record()
            else:
                host = sampled
        with prof.phase("sample"):
            # the frontier advance AT DISPATCH (the commit reads the
            # record's snapshots, never the advanced arrays)
            feed_len = np.asarray([len(f) if f is not None else 1 << 30
                                   for f in self._feeds])
            samples = live & (self._prompt_pos + t_valid >= feed_len)
            was_prefill = live & (self._prompt_pos < feed_len)
            self._lengths_dev = None
            for slot in np.flatnonzero(live):
                tv = int(t_valid[slot])
                self._lengths[slot] += tv
                self._prompt_pos[slot] = min(self._prompt_pos[slot] + tv,
                                             feed_len[slot])
        return {
            "step": self.occupancy_steps - 1,
            "live": live.copy(),
            "samples": samples,
            "was_prefill": was_prefill,
            "lengths_after": self._lengths.copy(),
            "prompt_pos_after": self._prompt_pos.copy(),
            "logits": logits,                # on the card, not landed
            "sampled": sampled,              # the next step's indirection
            "host": host,                    # lands when `event` completes
            "event": event,
            "dead": np.zeros(self.max_batch, bool),
        }

    def _commit_pending(self) -> list[Request]:
        """Land and commit the in-flight step, if any (the drain: sync
        fallbacks, empty schedules, step()'s no-live-work branch). Pops the
        record FIRST, so releases inside the commit do not dead-mark the
        record being committed."""
        p, self._pending = self._pending, None
        if p is None:
            return []
        return self._commit_pending_record(p)

    def _commit_pending_record(self, p) -> list[Request]:
        """The host back half of a pipelined step, one step late: wait for
        the step's sampled tokens, then run _sample_and_finish's commit loop
        against the record's SNAPSHOTS (the live arrays already hold the
        next step's advance). Slots released since dispatch are dead-marked
        and skipped. Registration passes the record's own coverage, so no
        block the in-flight next step writes is registered."""
        prof = self.telemetry.profiler
        with prof.phase("device"):
            # the profiler's fence moves here from the dispatch: device time
            # lands on the step whose results are being landed
            self._fence()
        finished: list[Request] = []
        with prof.phase("sample"):
            live = p["live"] & ~p["dead"]
            samples = p["samples"] & ~p["dead"]
            # the unprofiled async step's one host sync
            if p["event"] is not None:
                with T.span("repro.sample.wait"):
                    p["event"].synchronize()
            sampled = p["host"].numpy()
            if self._robust and self._adm.nan_check:
                bad = (~torch.isfinite(p["logits"]).all(-1)).cpu().numpy()
                for slot in np.flatnonzero(samples & bad):
                    finished.append(self._fail_slot(int(slot),
                                                    "nan_logits"))
                    live[slot] = False
                    samples[slot] = False
        for slot in np.flatnonzero(live):
            req = self._slots[slot]
            if req is None:
                continue
            if self.prefix_sharing and (p["was_prefill"][slot]
                                        or self.decode_sharing):
                covered = (int(p["lengths_after"][slot])
                           if self.decode_sharing
                           else min(int(p["prompt_pos_after"][slot]),
                                    len(req.prompt)))
                with prof.phase("register"):
                    self._register_blocks(slot, req, covered=covered)
            if not samples[slot]:
                continue                     # still mid-prompt at dispatch
            tok = int(sampled[slot])
            req.out_tokens.append(tok)
            if len(req.out_tokens) == 1:
                self._first_token(req, p["step"])
            self._last[slot] = tok
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id) or
                    (not p["was_prefill"][slot] and
                     p["lengths_after"][slot] >= self.max_len - 1)):
                finished.append(self._finish(slot))
        return finished

    def _first_token(self, req: Request, step: int):
        """out_tokens went 0 -> 1 on step `step` (0-based, as
        Request.admit_step)."""
        req.first_token_step = step
        if self.telemetry.enabled:
            self.telemetry.metrics.on_first_token(req.uid)

    def _sample_and_finish(self, live, t_valid, logits) -> list[Request]:
        """Sample each slot that produced a next token, advance frontiers,
        register prefixes, finish slots at budget/EOS/cache-full."""
        prof = self.telemetry.profiler
        with prof.phase("sample"):
            feed_len = np.asarray([len(f) if f is not None else 1 << 30
                                   for f in self._feeds])
            samples = live & (self._prompt_pos + t_valid >= feed_len)
            finished: list[Request] = []
            if self._robust and self._adm.nan_check:
                # only rows about to be sampled matter (the KV write is not
                # affected): a non-finite one fails its request with a
                # reason
                bad = (~torch.isfinite(logits).all(-1)).cpu().numpy()
                for slot in np.flatnonzero(samples & bad):
                    finished.append(self._fail_slot(int(slot), "nan_logits"))
                    live[slot] = False
                    samples[slot] = False
            # non-sampling slots go greedy (temp 0): their uid/index rows
            # are placeholders that never reach the categorical path
            nxt = sample_tokens(
                self._key, logits, np.where(samples, self._temps, 0.0),
                [r.uid if r else 0 for r in self._slots],
                [len(r.out_tokens) if r else 0 for r in self._slots])
        self._lengths_dev = None             # frontiers advance below
        for slot in np.flatnonzero(live):
            req = self._slots[slot]
            tv = int(t_valid[slot])
            was_prefill = self._prompt_pos[slot] < feed_len[slot]
            self._lengths[slot] += tv
            self._prompt_pos[slot] = min(self._prompt_pos[slot] + tv,
                                         feed_len[slot])
            if self.prefix_sharing and (was_prefill or self.decode_sharing):
                # before any _finish below, so a block completed on a
                # terminating step is still cached
                with prof.phase("register"):
                    self._register_blocks(slot, req)
            if not samples[slot]:
                continue                     # still mid-prompt
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            if len(req.out_tokens) == 1:
                self._first_token(req, self.occupancy_steps - 1)
            self._last[slot] = tok
            # the cache-full guard only applies to decode-written KV
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id) or
                    (not was_prefill and
                     self._lengths[slot] >= self.max_len - 1)):
                finished.append(self._finish(slot))
        return finished

    def _verify_and_finish(self, live, t_valid, drafts, off, wp, logits,
                           draft_allocs, snap_blocks, snap, staged,
                           fresh_np) -> list[Request]:
        """Speculative step tail: sample EVERY verify lane with the owning
        request's per-(uid, position) key (lane i of a drafting slot is
        generation index len(out_tokens) + i: the token a never-drafted
        engine samples there), accept the longest draft prefix that
        matches, emit the accepted run plus the model's own token at the
        first mismatch, then roll the rejected lanes back so the step
        leaves no trace of them:
          * host: draft-only allocations freed in REVERSE allocation order
            (restores the free list exactly), table entries back to -1,
            decremented reservations returned;
          * fp pools: nothing (rejected rows lie past the new frontier,
            masked by kv_len and overwritten before any read);
          * int8 pools: snapshot restore and committed-row replay
            (_restore_and_replay) after EVERY verify step, accepted or not.
        Finishes are deferred until after the rollback, so their frees
        append to a free list the rollback already restored."""
        prof = self.telemetry.profiler
        bs = self.block_size
        width = wp.shape[0]
        kk1 = logits.shape[1]
        with prof.phase("sample"):
            feed_len = np.asarray([len(f) if f is not None else 1 << 30
                                   for f in self._feeds])
            samples = live & (self._prompt_pos + t_valid >= feed_len)
            # one flat sampling batch over (slot, verify lane); rows past a
            # slot's verify lanes, and every row of a slot not sampling,
            # go greedy (temp 0) and are discarded
            n_ver = np.ones(self.max_batch, np.int64)
            for slot, d in drafts.items():
                n_ver[slot] = 1 + len(d)
            col = np.arange(kk1)[None, :]
            do = samples[:, None] & (col < n_ver[:, None])
            uids = np.asarray([r.uid if r else 0 for r in self._slots])
            gen0 = np.asarray([len(r.out_tokens) if r else 0
                               for r in self._slots])
            toks = sample_tokens(
                self._key, logits.reshape(-1, logits.shape[-1]),
                np.where(do, self._temps[:, None], 0.0).reshape(-1),
                np.repeat(uids, kk1), (gen0[:, None] + col).reshape(-1),
            ).reshape(self.max_batch, kk1)
        finished_slots: list[int] = []
        replay = np.zeros(width, bool)       # committed verify lanes
        keep_blocks: dict[int, int] = {}     # slot -> committed block count
        any_reject = False
        self._lengths_dev = None             # frontiers advance below
        for slot in np.flatnonzero(live):
            req = self._slots[slot]
            tv = int(t_valid[slot])
            was_prefill = self._prompt_pos[slot] < feed_len[slot]
            if slot not in drafts:
                # the never-drafted tail (_sample_and_finish), finishes
                # deferred
                self._lengths[slot] += tv
                self._prompt_pos[slot] = min(self._prompt_pos[slot] + tv,
                                             feed_len[slot])
                if self.prefix_sharing and (was_prefill
                                            or self.decode_sharing):
                    with prof.phase("register"):
                        self._register_blocks(slot, req)
                if not samples[slot]:
                    continue                 # still mid-prompt
                tok = int(toks[slot, 0])
                req.out_tokens.append(tok)
                if len(req.out_tokens) == 1:
                    self._first_token(req, self.occupancy_steps - 1)
                self._last[slot] = tok
                if (len(req.out_tokens) >= req.max_new_tokens or
                        (self.eos_id is not None and tok == self.eos_id) or
                        (not was_prefill and
                         self._lengths[slot] >= self.max_len - 1)):
                    finished_slots.append(slot)
                continue
            # drafting decode slot: the longest matching prefix wins
            d = drafts[slot]
            k = len(d)
            t_row = [int(toks[slot, i]) for i in range(1 + k)]
            j = 0
            while j < k and d[j] == t_row[j]:
                j += 1
            # emit t_row[0..j] under never-drafted finish semantics: stop at
            # the first token that would have ended the request
            L0 = int(self._lengths[slot])
            emitted: list[int] = []
            fin = False
            for i in range(j + 1):
                tok = t_row[i]
                emitted.append(tok)
                if (len(req.out_tokens) + len(emitted)
                        >= req.max_new_tokens or
                        (self.eos_id is not None and
                         tok == self.eos_id) or
                        L0 + 1 + i >= self.max_len - 1):
                    fin = True
                    break
            m = len(emitted)
            self.spec_steps += 1
            self.drafted_tokens += k
            self.accepted_tokens += m - 1
            self.rejected_tokens += k - (m - 1)
            if m < tv:
                any_reject = True
            # exactly the rows a never-drafted engine writes: lanes 0..m-1
            # (the last emitted token's KV lands on its next step, or never)
            replay[off[slot]:off[slot] + m] = True
            keep_blocks[slot] = -(-(L0 + m) // bs)
            self._lengths[slot] += m
            req.out_tokens.extend(emitted)
            if self.decode_sharing:
                with prof.phase("register"):
                    self._register_blocks(slot, req)
            self._last[slot] = emitted[-1]
            if fin:
                finished_slots.append(slot)
        with prof.phase("rollback"):
            for slot, jdx, blk, resv_dec in reversed(draft_allocs):
                if jdx < keep_blocks[slot]:
                    continue                 # covered by committed rows
                self.alloc.free([blk])
                self._tables[slot, jdx] = -1
                self._tables_dev = None
                if resv_dec:
                    self._resv[slot] += 1
            if any_reject:
                self.spec_rollbacks += 1
            if snap is not None:
                # snapshot blocks allocated this step AND still held get
                # zeroed scales; freed draft blocks keep their restored
                # stale state
                held = set()
                for slot in drafts:
                    row = self._tables[slot]
                    held.update(int(b) for b in row[row >= 0])
                fresh_live = ((set(int(b) for b in fresh_np) & held)
                              - {TRASH_BLOCK})
                fresh_mask = np.asarray(
                    [int(b) in fresh_live for b in snap_blocks], bool)
                replay_pos = np.where(
                    replay, wp.astype(np.int64),
                    TRASH_BLOCK * bs + np.arange(width, dtype=np.int64) % bs)
                with torch.inference_mode():
                    _restore_and_replay(
                        self._cache["layers"], snap, self._dev(snap_blocks),
                        self._dev(fresh_mask), staged[0], staged[1],
                        self._dev(replay_pos.astype(np.int32)[None]))
        return [self._finish(slot) for slot in finished_slots]

    # --------------------------------------------------------------- run --

    @property
    def busy(self) -> bool:
        """True while the engine has queued or in-flight requests; an
        uncommitted pipelined step counts (its tokens have not landed in
        Request.out_tokens yet)."""
        return (bool(self._queue) or bool(self._live.any())
                or self._pending is not None)

    def step(self) -> list[Request]:
        """Admit from the queue and run ONE step (packed, or a lockstep
        chunk step while any slot is prefilling, else a lockstep decode
        step); returns newly finished requests, in robust mode also those
        ending in failure (deadline, NaN logits, device error: check
        Request.failed / fail_reason). A no-op when idle.

        With graceful_exhaustion, BlockPoolExhausted never escapes: the
        failing phase unwound its allocations, so state is exactly pre-step;
        a victim is preempted (the lowest class, most recently admitted,
        possibly the slot that needed to grow) and the next step retries."""
        prof = self.telemetry.profiler
        with prof.step():
            finished: list[Request] = []
            with prof.phase("admit"):
                if self._robust:
                    finished.extend(self._expire_deadlines(self._clock()))
                self._admit()
            if self.telemetry.enabled:
                self.telemetry.metrics.sample_queue_depth()
            if not self._live.any():
                if self._pending is not None:
                    # the pipeline's drain: every live slot ended at the
                    # last commit (or was released), one dispatched step is
                    # still in flight; land it
                    finished.extend(self._commit_pending())
                    return finished
                # a robust queue may stall head-of-line (no preemptible
                # lower class); without the layer a stalled queue beside a
                # free pool is a scheduling bug
                assert self._robust or not self._queue, \
                    "admission stalled with free pool"
                return finished
            try:
                if self.packed:
                    finished.extend(self._step_packed())
                else:
                    prefilling = any(
                        self._prompt_pos[s] < len(self._feeds[s])
                        for s in np.flatnonzero(self._live))
                    finished.extend(
                        self._step(self.block_size if prefilling else 1))
            except BlockPoolExhausted:
                if not (self._robust and self._adm.graceful_exhaustion):
                    raise
                self.robust_counters.exhaustion_events += 1
                victim = choose_victim(np.flatnonzero(self._live),
                                       self._prio, self._admit_seq)
                if victim is not None:
                    self._preempt_slot(int(victim))
            except DeviceStepFailed:
                # a device failure past max_device_retries (robust mode
                # only): fail every live slot with a reason instead of
                # wedging the engine
                for slot in np.flatnonzero(self._live):
                    finished.append(self._fail_slot(int(slot),
                                                    "device_error"))
            return finished

    def run(self) -> list[Request]:
        """Serve the whole queue; returns finished requests (uid order
        follows completion, not submission)."""
        finished: list[Request] = []
        while self.busy:
            finished.extend(self.step())
        return finished

    def snapshot(self) -> dict:
        """The schema-versioned telemetry snapshot (T.make_snapshot):
        lifecycle latencies and step phases when telemetry is on, with the
        prefix, padding, KV-byte, occupancy and robustness counters. The
        padding counters are the JAX engine's (the schema is shared):
        padding_stats less TILE_STATS."""
        return T.make_snapshot(
            "paged", self.telemetry,
            kv_cache=kv_cache_byte_stats(self._cache, self.cfg, None),
            occupancy=(self.occupancy_sum / self.occupancy_steps
                       if self.occupancy_steps else None),
            prefix=self.prefix_stats(),
            padding={k: v for k, v in self.padding_stats().items()
                     if k not in TILE_STATS},
            robustness=(self.robust_counters.snapshot()
                        if self._robust else None))
