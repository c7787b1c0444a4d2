"""Paged KV-cache serving — the port of `repro/serve/paged.py` as far as
greedy serving in either step layout reaches.

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

The host half (allocator, scheduler, lane packing, write targets) is the
JAX package's numpy code, copied; the device half replaces the jitted step
with donated pools by in-place writes into the preallocated pool tensors.

Not ported yet, and refused when switched on (NotImplementedError naming
the ROADMAP.md item): prefix and decode sharing with sessions (A6), int8 KV
(A4), speculative decoding (A6), the async loop (A6), telemetry and robust
admission/preemption (A5, A6), temperature sampling (A5), and the packed
step without the fused kernel (the per-slot STE grid, A4).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import kernel_path_blockers
from repro_torch.serve.engine import (Request, check_greedy,
                                      check_params_device, refuse,
                                      sample_tokens, validate_prompt,
                                      warn_decode_kernel_fallback)

TRASH_BLOCK = 0


class BlockPoolExhausted(RuntimeError):
    """Raised by BlockAllocator.alloc when the free list is empty — before
    any table entry or pool block is touched, so engine state stays valid."""


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
    DECODE slot; leftover budget is dealt to decode slots' draft lanes FIRST,
    in slot order, still at most chunk_cap lanes per slot."""
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


def init_paged_cache(cfg, num_blocks: int, block_size: int, max_batch: int,
                     cache_dtype=None, device=None):
    """Model cache in the paged layout: per-layer (N, Hkv, bs, hd) pools,
    stacked over layers, with the TRUE head_dim (the JAX package pads it to
    the TPU's 128-lane tile; the CUDA kernel needs no padding). The per-slot
    frontiers live on the host (PagedEngine._lengths); every packed step
    passes explicit positions. cache_dtype=None resolves to
    cfg.cache_dtype. `max_batch` is kept for the JAX signature."""
    if cfg.kv_quant != "none":
        raise NotImplementedError(
            f"kv_quant={cfg.kv_quant!r} is not ported yet: ROADMAP.md item "
            f"A4")
    device = resolve_device(device)
    dt = M.DTYPES[cache_dtype or cfg.cache_dtype]
    shape = (cfg.num_layers, num_blocks, cfg.num_kv_heads, block_size,
             cfg.head_dim)
    return {"layers": {"k": torch.zeros(shape, dtype=dt, device=device),
                       "v": torch.zeros(shape, dtype=dt, device=device)}}


class PagedEngine:
    """Greedy, synchronous paged engine, packed or lockstep steps. The
    constructor takes the JAX engine's arguments; those selecting paths not
    ported yet raise NotImplementedError (see the module docstring).
    `decode_steps` counts the lockstep layout's (B, 1) decode steps."""

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
        if (prefix_sharing if prefix_sharing is not None
                else cfg.prefix_sharing) or (
                decode_sharing if decode_sharing is not None
                else cfg.decode_sharing):
            refuse("prefix/decode sharing and sessions", "A6")
        if speculative if speculative is not None else cfg.speculative:
            refuse("speculative decoding", "A6")
        if async_loop if async_loop is not None else cfg.async_loop:
            refuse("the pipelined async loop", "A6")
        if telemetry is not None:
            refuse("serving telemetry", "A5")
        if (admission is not None or cfg.queue_limit or cfg.preemption
                or cfg.backpressure != "reject"):
            refuse("robust admission and preemption", "A5/A6")
        if cfg.kv_quant != "none":
            refuse(f"kv_quant={cfg.kv_quant!r}", "A4")
        self.packed = True if packed is None else bool(packed)
        blockers = kernel_path_blockers(cfg)
        if self.packed and (blockers or not params["hccs"]):
            refuse("the packed step without the fused kernel ("
                   + (", ".join(blockers) or "no hccs params")
                   + "; the JAX engine runs the per-slot STE grid)", "A4")
        check_params_device(params, self.device)
        warn_decode_kernel_fallback(cfg)
        self.w = params["weights"]
        self.hccs = params["hccs"]
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
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
        self._queue: list[Request] = []
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
        # chunk-width ladder (the JAX engine's, exactly): a packed step runs
        # at the smallest width that covers its work
        self._widths = sorted({max_batch, max(budget // 4, max_batch),
                               max(budget // 2, max_batch), budget})
        # per-slot chunks are capped at 4 blocks (the JAX engine's cap)
        self._chunk_cap = min(4 * bs, budget)
        # token-lane telemetry (padding_stats)
        self.lanes_valid = 0
        self.lanes_total = 0
        self.pad_lanes_skipped = 0
        self.decode_steps = 0
        self._tables = np.full((max_batch, self._nblk_per_seq), -1, np.int32)
        self._resv = np.zeros(max_batch, np.int64)   # admission reservations
        self._slots: list[Request | None] = [None] * max_batch
        self._feeds: list[np.ndarray | None] = [None] * max_batch
        self._live = np.zeros(max_batch, bool)
        self._lengths = np.zeros(max_batch, np.int32)
        self._prompt_pos = np.zeros(max_batch, np.int32)  # feed tokens fed
        self._last = np.zeros(max_batch, np.int32)        # next token to feed
        self._cache = init_paged_cache(cfg, self.num_blocks, bs, max_batch,
                                       cache_dtype, self.device)

    # ------------------------------------------------------------- queue --

    def _blocks_for(self, plen: int, max_new: int) -> int:
        return -(-min(plen + max_new, self.max_len) // self.block_size)

    def submit(self, req: Request):
        """Queue a request (greedy only)."""
        check_greedy(req)
        validate_prompt(req.prompt, self.max_len)
        need = self._blocks_for(len(req.prompt), req.max_new_tokens)
        if need > self.num_blocks - 1:
            raise ValueError(
                f"request needs up to {need} KV blocks but the pool has "
                f"{self.num_blocks - 1} usable")
        self._queue.append(req)

    def _admit(self):
        """FIFO admission into free slots, gated on UNRESERVED free blocks
        covering the request's worst case (deadlock-free: admitted requests
        can always grow to their budget)."""
        while self._queue and not self._live.all():
            req = self._queue[0]
            need = self._blocks_for(len(req.prompt), req.max_new_tokens)
            if self.alloc.num_free - int(self._resv.sum()) < need:
                break                        # wait for EOS to free blocks
            self._queue.pop(0)
            slot = int(np.argmin(self._live))
            self._slots[slot] = req
            self._feeds[slot] = np.asarray(req.prompt, np.int32)
            self._live[slot] = True
            self._lengths[slot] = 0
            self._prompt_pos[slot] = 0
            self._resv[slot] = need

    def padding_stats(self) -> dict:
        """Token-lane telemetry: efficiency = valid lanes / padded lanes over
        every step so far, plus the estimated lanes the lockstep layout would
        have burned extra."""
        return dict(lanes_valid=self.lanes_valid,
                    lanes_total=self.lanes_total,
                    efficiency=self.lanes_valid / max(self.lanes_total, 1),
                    pad_lanes_skipped=self.pad_lanes_skipped)

    # ------------------------------------------------------------- slots --

    def _release_slot(self, slot: int):
        """Free a slot's block references and reset its host state."""
        row = self._tables[slot]
        self.alloc.free(row[row >= 0])
        row[:] = -1
        self._resv[slot] = 0
        self._slots[slot] = None
        self._feeds[slot] = None
        self._live[slot] = False
        self._lengths[slot] = 0
        self._prompt_pos[slot] = 0

    def _finish(self, slot: int) -> Request:
        req = self._slots[slot]
        req.done = True
        self._release_slot(slot)
        return req

    def _grow_tables(self, t_valid: np.ndarray):
        """Alloc-on-frontier-crossing: extend each slot's table to cover
        lengths + t_valid before the step writes there."""
        for slot in np.flatnonzero(t_valid > 0):
            needed = -(-int(self._lengths[slot] + t_valid[slot])
                       // self.block_size)
            row = self._tables[slot]
            held = int((row >= 0).sum())
            for j in range(held, needed):
                row[j] = self.alloc.alloc()
                self._resv[slot] = max(self._resv[slot] - 1, 0)

    def _write_positions(self, t_valid: np.ndarray, width: int) -> np.ndarray:
        """Flat pool scatter targets (B, width): token i of slot b lands at
        table[b, (len+i)//bs]*bs + (len+i)%bs while i < t_valid[b]; invalid
        lanes are steered into the trash block (position i of block 0)."""
        bs = self.block_size
        wp = np.tile(np.arange(width, dtype=np.int64)[None, :],
                     (self.max_batch, 1)) + TRASH_BLOCK * bs
        for slot in np.flatnonzero(t_valid > 0):
            tv = int(t_valid[slot])
            wp[slot, :tv] = _slot_write_targets(
                self._tables[slot], int(self._lengths[slot]), tv, bs)
        return wp.astype(np.int32)

    def _step(self, width: int) -> list[Request]:
        """One lockstep batched step: chunk (width == block_size, some slot
        is mid-prompt) or pure decode (width == 1). Returns newly finished."""
        live = self._live.copy()
        self.occupancy_sum += float(live.mean())
        self.occupancy_steps += 1
        t_valid = np.zeros(self.max_batch, np.int32)
        toks = np.zeros((self.max_batch, width), np.int32)
        for slot in np.flatnonzero(live):
            feed = self._feeds[slot]
            pos = int(self._prompt_pos[slot])
            if pos < len(feed):              # chunked prefill
                tv = min(width, len(feed) - pos)
                toks[slot, :tv] = feed[pos:pos + tv]
                t_valid[slot] = tv
            else:                            # decode rides along, t_valid 1
                toks[slot, 0] = self._last[slot]
                t_valid[slot] = 1
        self.lanes_valid += int(t_valid.sum())
        self.lanes_total += self.max_batch * width
        self._grow_tables(t_valid)
        dev = (lambda a: torch.tensor(a, device=self.device))
        cache = dict(self._cache,
                     length=dev(self._lengths),
                     block_table=dev(self._tables),
                     write_pos=dev(self._write_positions(t_valid, width)),
                     kv_len=dev(self._lengths + t_valid))
        with torch.inference_mode():
            x, _, _ = M.forward(self.w, self.hccs, {"tokens": dev(toks)},
                                self.cfg, cache)
            # each slot samples from its LAST VALID lane (t_valid - 1):
            # riding decode slots have t_valid == 1, mid-prompt slots
            # discard their logits
            idx = dev(np.maximum(t_valid - 1, 0).astype(np.int64))
            h_last = x[torch.arange(self.max_batch, device=self.device),
                       idx][:, None]                           # (B, 1, D)
            logits = M.logits_from_hidden(self.w, h_last, self.cfg)[:, 0]
        if width == 1:
            self.decode_steps += 1
        return self._sample_and_finish(live, t_valid, logits)

    def _step_packed_sync(self) -> list[Request]:
        """One PACKED token step: the step's work flattened into a ragged
        (1, width) token batch with per-token slot ids, positions and causal
        frontiers; width is the smallest ladder rung covering the pending
        work. Returns newly finished requests."""
        live = self._live.copy()
        self.occupancy_sum += float(live.mean())
        self.occupancy_steps += 1
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
        positions = np.zeros(width, np.int32)
        for slot in np.flatnonzero(t_valid > 0):
            tv = int(t_valid[slot])
            o = int(off[slot])
            if remaining[slot] > 0:          # prefill chunk (budget-sized)
                pos = int(self._prompt_pos[slot])
                toks[o:o + tv] = self._feeds[slot][pos:pos + tv]
            else:                            # decode: one lane
                toks[o] = self._last[slot]
            positions[o:o + tv] = int(self._lengths[slot]) + np.arange(tv)
        self.lanes_valid += int(t_valid.sum())
        self.lanes_total += width
        # lanes the lockstep layout would burn for the same scheduled work
        # (see the JAX engine's _step_packed_sync for the accounting)
        if (remaining > 0).any():
            n_lockstep = -(-int(t_valid.max()) // self.block_size)
            riders = int((live & (remaining == 0)).sum())
            lockstep = n_lockstep * self.max_batch * self.block_size
            self.pad_lanes_skipped += max(
                lockstep - width - (n_lockstep - 1) * riders, 0)
        self._grow_tables(t_valid)
        wp = packed_write_positions(t_valid, off, self._tables,
                                    self._lengths, self.block_size, width)
        kv_len = np.where(sid >= 0, positions + 1, 0).astype(np.int32)
        lane_idx = np.maximum(off + t_valid - 1, 0)
        dev = (lambda a: torch.tensor(a, device=self.device))
        cache = dict(self._cache,
                     block_table=dev(self._tables),
                     write_pos=dev(wp[None]),
                     kv_len=dev(kv_len),
                     slot_ids=dev(sid))
        with torch.inference_mode():
            x, _, _ = M.forward(self.w, self.hccs,
                                {"tokens": dev(toks[None]),
                                 "positions": dev(positions[None])},
                                self.cfg, cache)
            h_last = x[0, dev(lane_idx.astype(np.int64))][:, None]  # (B,1,D)
            logits = M.logits_from_hidden(self.w, h_last, self.cfg)[:, 0]
        return self._sample_and_finish(live, t_valid, logits)

    def _sample_and_finish(self, live, t_valid, logits) -> list[Request]:
        """Sample each slot that produced a next token, advance frontiers,
        finish slots at budget/EOS/cache-full."""
        feed_len = np.asarray([len(f) if f is not None else 1 << 30
                               for f in self._feeds])
        samples = live & (self._prompt_pos + t_valid >= feed_len)
        nxt = sample_tokens(logits)
        finished: list[Request] = []
        for slot in np.flatnonzero(live):
            req = self._slots[slot]
            tv = int(t_valid[slot])
            was_prefill = self._prompt_pos[slot] < feed_len[slot]
            self._lengths[slot] += tv
            self._prompt_pos[slot] = min(self._prompt_pos[slot] + tv,
                                         feed_len[slot])
            if not samples[slot]:
                continue                     # still mid-prompt
            tok = int(nxt[slot])
            req.out_tokens.append(tok)
            self._last[slot] = tok
            # the cache-full guard only applies to decode-written KV
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id) or
                    (not was_prefill and
                     self._lengths[slot] >= self.max_len - 1)):
                finished.append(self._finish(slot))
        return finished

    # --------------------------------------------------------------- run --

    @property
    def busy(self) -> bool:
        """True while the engine has queued or in-flight requests."""
        return bool(self._queue) or bool(self._live.any())

    def step(self) -> list[Request]:
        """Admit from the queue and run ONE step (packed, or a lockstep
        chunk step while any slot is prefilling, else a lockstep decode
        step); returns newly finished requests (a no-op when idle)."""
        self._admit()
        if not self._live.any():
            assert not self._queue, "admission stalled with free pool"
            return []
        if self.packed:
            return self._step_packed_sync()
        prefilling = any(self._prompt_pos[s] < len(self._feeds[s])
                         for s in np.flatnonzero(self._live))
        return self._step(self.block_size if prefilling else 1)

    def run(self) -> list[Request]:
        """Serve the whole queue; returns finished requests (uid order
        follows completion, not submission)."""
        finished: list[Request] = []
        while self.busy:
            finished.extend(self.step())
        return finished
