"""Batched serving engine: wave-scheduled prefill + decode — the port of
`repro/serve/engine.py`, plus the request type, admission bound and greedy
sampling every engine of the port shares.

Requests are grouped into waves by prompt length (no padding). Each wave
batch-prefills together, then decodes lockstep one token per step until
every member finishes; finished rows stop sampling (their tokens are
discarded) so shapes never change mid-wave. Attention in the prefill is the
STE path (dense or blockwise); with cfg.decode_kernel on, every decode step
runs the fused `hccs_decode` kernel over the slot arena.

Not ported yet: temperature sampling (the JAX engines fold (uid, generation
index) into threefry keys, a stream torch cannot reproduce; ROADMAP.md item
A5) — a request with temperature > 0 is refused at submit — and serving
telemetry (A5).
"""
from __future__ import annotations

import dataclasses
import warnings
from collections import defaultdict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.models.attention import decode_kernel_blockers


@dataclasses.dataclass
class Request:
    """One serving request: `done` is set when it completes; `failed` is
    the other terminal state (a cancelled turn, reason in `fail_reason`)."""
    uid: int
    prompt: np.ndarray            # (t,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    failed: bool = False
    fail_reason: str | None = None


def kv_cache_bytes(cache) -> int:
    """Allocated KV bytes of an engine cache (the slot arena or the paged
    block pool): k/v payload plus the int8 pools' per-block scales."""
    return sum(leaf.numel() * leaf.element_size()
               for name, leaf in cache["layers"].items()
               if name in ("k", "v", "k_scale", "v_scale"))


def kv_cache_byte_stats(cache, cfg, max_len: int | None = None) -> dict:
    """Padded (as allocated) and LOGICAL KV bytes of an engine cache, the
    JAX package's accounting. The port stores the true head_dim (no lane
    padding), so the two differ only where a slot arena's rows were rounded
    up (kv_store_geometry) and `max_len` is given: `logical` counts the
    first max_len rows. Paged pools pass None. int8 pools count one byte a
    value, and their (L, N, Hkv) f32 scales in full on both sides."""
    padded = kv_cache_bytes(cache)
    logical = padded
    if max_len is not None:
        for name in ("k", "v"):
            leaf = cache["layers"][name]
            rows_c = leaf.shape[-2]
            logical -= (leaf.numel() // rows_c * max(rows_c - max_len, 0)
                        * leaf.element_size())
    return dict(cache_bytes_logical=logical, cache_bytes_padded=padded)


def validate_prompt(prompt, max_len: int):
    """Shared admission bound: the prompt must fit the cache with room for at
    least one generated token."""
    if len(prompt) < 1 or len(prompt) > max_len - 1:
        raise ValueError(
            f"prompt length {len(prompt)} not in [1, {max_len - 1}]")


def check_greedy(req: Request):
    if req.temperature > 0:
        raise NotImplementedError(
            "temperature sampling is not ported yet (per-request threefry "
            "streams): ROADMAP.md item A5")


def sample_tokens(logits: torch.Tensor) -> np.ndarray:
    """Greedy per-row sampling: (B, V) logits -> (B,) np.int64 tokens. The
    argmax takes the FIRST maximal index on ties, as jnp.argmax does; only
    the B indices leave the device."""
    return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)


def refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet: ROADMAP.md item "
                              f"{item}")


def check_params_device(params, device):
    devices = {t.device for t in M.flatten_tree(params).values()}
    if devices != {device}:
        raise ValueError(f"params lie on {sorted(map(str, devices))}, the "
                         f"engine runs on {device}")


def warn_decode_kernel_fallback(cfg):
    """Warn at engine construction when cfg.decode_kernel cannot take effect,
    with the blocking reason (i8 mode, windowed attention, ...)."""
    if cfg.decode_kernel == "none":
        return
    blockers = decode_kernel_blockers(cfg)
    if blockers:
        with warnings.catch_warnings():
            # every engine construction with a blocked config must warn
            warnings.simplefilter("always", RuntimeWarning)
            warnings.warn(
                f"decode_kernel={cfg.decode_kernel!r} has no effect "
                f"({', '.join(blockers)}); decode runs the STE path",
                RuntimeWarning, stacklevel=3)


class ServeEngine:
    """The wave engine, greedy. `decode_steps` counts the batched decode
    steps run so far (each runs every layer's attention once)."""

    def __init__(self, params, cfg, *, max_batch: int = 8,
                 max_len: int = 512, eos_id: int | None = None,
                 cache_dtype=None, telemetry=None, device=None):
        self.device = resolve_device(device)
        if cfg.kv_quant != "none":
            raise ValueError(
                f"kv_quant={cfg.kv_quant!r} quantizes the paged block pool; "
                "the wave engine's slot arena is fp-only (use PagedEngine)")
        if telemetry is not None:
            refuse("serving telemetry", "A5")
        check_params_device(params, self.device)
        self.w = params["weights"]
        self.hccs = params["hccs"]
        self.cfg = cfg
        self.max_batch = max_batch
        self.max_len = max_len
        self.eos_id = eos_id
        self.cache_dtype = cache_dtype
        self.decode_steps = 0
        self._queue: list[Request] = []
        warn_decode_kernel_fallback(cfg)

    def submit(self, req: Request):
        check_greedy(req)
        validate_prompt(req.prompt, self.max_len)
        self._queue.append(req)

    def _next_wave(self) -> list[Request]:
        if not self._queue:
            return []
        by_len: dict[int, list[Request]] = defaultdict(list)
        for r in self._queue:
            by_len[len(r.prompt)].append(r)
        # largest group first; cap at max_batch
        length = max(by_len, key=lambda k: len(by_len[k]))
        wave = by_len[length][: self.max_batch]
        for r in wave:
            self._queue.remove(r)
        return wave

    def _run_wave(self, wave: list[Request]):
        b = len(wave)
        toks = torch.tensor(np.stack([r.prompt for r in wave]),
                            dtype=torch.int32, device=self.device)
        with torch.inference_mode():
            logits, cache = M.prefill(self.w, self.hccs, {"tokens": toks},
                                      self.cfg, max_len=self.max_len,
                                      cache_dtype=self.cache_dtype)
        nxt = sample_tokens(logits)
        live = np.ones(b, bool)
        # the prefill-sampled token counts against the budget and may be EOS,
        # exactly as in the continuous engine's admission
        for i, r in enumerate(wave):
            tok = int(nxt[i])
            r.out_tokens.append(tok)
            if (len(r.out_tokens) >= r.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id)):
                r.done = True
                live[i] = False
        # the host's copy of the cache frontier (the JAX engine reads the
        # device scalar back instead)
        length = len(wave[0].prompt)
        max_steps = max(r.max_new_tokens for r in wave) - 1
        for _ in range(max(max_steps, 0)):
            if not live.any():
                break
            last = torch.tensor(nxt[:, None], dtype=torch.int32,
                                device=self.device)
            with torch.inference_mode():
                logits, cache = M.decode_step(self.w, self.hccs, last, cache,
                                              self.cfg)
            self.decode_steps += 1
            length += 1
            # finished rows sample greedily too; their tokens are discarded
            nxt = sample_tokens(logits)
            for i, r in enumerate(wave):
                if not live[i]:
                    continue
                tok = int(nxt[i])
                r.out_tokens.append(tok)
                if (len(r.out_tokens) >= r.max_new_tokens or
                        (self.eos_id is not None and tok == self.eos_id)):
                    r.done = True
                    live[i] = False
            if not live.any() or length >= self.max_len - 1:
                break
        for r in wave:
            r.done = True

    def run(self) -> list[Request]:
        """Serve the whole queue; returns finished requests."""
        finished: list[Request] = []
        while self._queue:
            wave = self._next_wave()
            if not wave:
                break
            self._run_wave(wave)
            finished.extend(wave)
        return finished
