"""Slot-based continuous batching — the port of `repro/serve/continuous.py`.

Layout: a fixed (max_batch, max_len) KV-cache *slot arena* on the device
plus per-slot host bookkeeping; `length` is a (max_batch,) vector of
per-slot frontiers. A finished slot is freed at once and a queued request is
admitted into it between decode steps (FIFO). Admission prefills the new
request alone, its prompt padded to a power-of-two bucket, into a cache
sized to the bucket (so its attention is the whole-bucket STE path), and
copies that cache into the slot at offset 0; the pad tokens' K/V land past
the slot's length and are masked for good.

Dead and free slots ride along in the batched decode step; their outputs
are discarded on the host and their frontier is frozen, so their writes
land on the same masked cell. With cfg.decode_kernel on, the decode step's
attention runs the fused `hccs_decode` kernel over the arena.

The device half writes the arena in place (the JAX engine donates it to
XLA). Not ported yet, and refused: robust admission (deadlines, priority
queue, backpressure; ROADMAP.md item A5) and serving telemetry (A5).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.serve.engine import (Request, check_greedy,
                                      check_params_device, refuse,
                                      sample_tokens, validate_prompt,
                                      warn_decode_kernel_fallback)


class ContinuousEngine:
    """Greedy continuous batching over a slot arena. `occupancy_steps`
    counts the batched decode steps run so far."""

    def __init__(self, params, cfg, *, max_batch: int = 8,
                 max_len: int = 512, eos_id: int | None = None,
                 cache_dtype=None, min_bucket: int = 16, telemetry=None,
                 admission=None, device=None):
        self.device = resolve_device(device)
        if cfg.hot_buffer != 0:
            raise ValueError(
                "continuous batching uses the slot arena, not hot buffers "
                f"(cfg.hot_buffer={cfg.hot_buffer}); use the wave engine or "
                "set hot_buffer=0")
        if cfg.kv_quant != "none":
            raise ValueError(
                f"kv_quant={cfg.kv_quant!r} quantizes the paged block pool; "
                "the slot arena is fp-only (use cache_layout='paged')")
        if telemetry is not None:
            refuse("serving telemetry", "A5")
        if admission is not None:
            refuse("robust admission (deadlines, priority queue, "
                   "backpressure)", "A5")
        check_params_device(params, self.device)
        self.w = params["weights"]
        self.hccs = params["hccs"]
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.min_bucket = min_bucket
        self._queue: list[Request] = []
        self.occupancy_sum = 0.0
        self.occupancy_steps = 0
        warn_decode_kernel_fallback(cfg)
        self._cache = M.init_cache(cfg, max_batch, max_len, cache_dtype,
                                   per_slot_lengths=True, device=self.device)
        self._slots: list[Request | None] = [None] * max_batch
        self._live = np.zeros(max_batch, bool)
        self._lengths = np.zeros(max_batch, np.int32)
        self._last = np.zeros(max_batch, np.int32)    # next token to feed

    # ------------------------------------------------------------- queue --

    def submit(self, req: Request):
        check_greedy(req)
        validate_prompt(req.prompt, self.max_len)
        self._queue.append(req)

    def _bucket(self, plen: int) -> int:
        b = self.min_bucket
        while b < plen:
            b *= 2
        return min(b, self.max_len)

    # ------------------------------------------------------------- slots --

    def _finish(self, slot: int) -> Request:
        req = self._slots[slot]
        req.done = True
        self._slots[slot] = None
        self._live[slot] = False
        return req

    def _prefill(self, toks: torch.Tensor, true_len: int):
        """Bucket-padded single-request prefill into a cache sized to the
        bucket. Returns (logits (1, V) at the last prompt token, layers)."""
        cache = M.init_cache(self.cfg, 1, toks.shape[1], self.cache_dtype,
                             device=self.device)
        with torch.inference_mode():
            x, cache, _ = M.forward(self.w, self.hccs, {"tokens": toks},
                                    self.cfg, cache)
            logits = M.logits_from_hidden(
                self.w, x[:, true_len - 1:true_len], self.cfg)
        return logits[:, 0], cache["layers"]

    def _insert(self, new_layers, slot: int):
        """Copy the (L, 1, Hkv, len_b, hd) prefilled cache into the arena at
        batch index `slot`, rows [0, len_b) (the slot owns them)."""
        for name, arena in self._cache["layers"].items():
            new = new_layers[name]
            arena[:, slot, :, :new.shape[3]] = new[:, 0].to(arena.dtype)

    def _admit(self) -> list[Request]:
        """Fill free slots from the queue; returns requests that finished at
        prefill (max_new_tokens == 1 or immediate EOS)."""
        finished = []
        while self._queue and not self._live.all():
            slot = int(np.argmin(self._live))          # first free slot
            req = self._queue.pop(0)
            plen = len(req.prompt)
            toks = np.zeros((1, self._bucket(plen)), np.int32)
            toks[0, :plen] = req.prompt
            logits, layers = self._prefill(
                torch.tensor(toks, device=self.device), plen)
            self._insert(layers, slot)
            self._slots[slot] = req
            self._live[slot] = True
            self._lengths[slot] = plen
            tok = int(sample_tokens(logits)[0])
            req.out_tokens.append(tok)
            self._last[slot] = tok
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id)):
                finished.append(self._finish(slot))
        return finished

    def _step(self) -> list[Request]:
        """One batched decode step over the arena; returns newly finished."""
        live = self._live.copy()
        self.occupancy_sum += float(live.mean())
        self.occupancy_steps += 1
        self._cache = dict(self._cache, length=torch.tensor(
            self._lengths, device=self.device))
        tokens = torch.tensor(self._last[:, None], device=self.device)
        with torch.inference_mode():
            logits, self._cache = M.decode_step(self.w, self.hccs, tokens,
                                                self._cache, self.cfg)
        # the step advances every slot's frontier; dead slots' writes are
        # garbage parked one past their final token — freeze them here so
        # they overwrite the same masked cell instead of marching on
        self._lengths = np.where(live, self._lengths + 1, self._lengths)
        nxt = sample_tokens(logits)
        finished = []
        for i in np.flatnonzero(live):
            req = self._slots[i]
            tok = int(nxt[i])
            req.out_tokens.append(tok)
            self._last[i] = tok
            if (len(req.out_tokens) >= req.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id) or
                    self._lengths[i] >= self.max_len - 1):
                finished.append(self._finish(i))
        return finished

    # --------------------------------------------------------------- run --

    @property
    def busy(self) -> bool:
        """True while the engine has queued or in-flight requests."""
        return bool(self._queue) or bool(self._live.any())

    def step(self) -> list[Request]:
        """Admit from the queue and run ONE batched decode step; returns
        newly finished requests (a no-op when the engine is idle)."""
        finished = self._admit()
        if self._live.any():
            finished.extend(self._step())
        return finished

    def run(self) -> list[Request]:
        """Serve the whole queue; returns finished requests (uid order
        follows completion, not submission)."""
        finished: list[Request] = []
        while self.busy:
            finished.extend(self.step())
        return finished
