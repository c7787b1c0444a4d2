"""Batched serving engine: wave-scheduled prefill + decode — the port of
`repro/serve/engine.py`, plus the request type, admission bound and
sampling every engine of the port shares.

Requests are grouped into waves by prompt length (no padding). Each wave
batch-prefills together, then decodes lockstep one token per step until
every member finishes; finished rows stop sampling (their tokens are
discarded) so shapes never change mid-wave. Attention in the prefill is the
STE path (dense or blockwise); with cfg.decode_kernel on, every decode step
runs the fused `hccs_decode` kernel over the slot arena.

Sampling (`sample_tokens`) is greedy where a request's temperature is 0 and
categorical otherwise, each sampled token drawn with the key the JAX
package folds from the request uid and the token's generation index
(serve/prng.py rebuilds its threefry streams), so a sampled request draws
the JAX engines' tokens whatever the batch around it.
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
from repro_torch.serve import prng
from repro_torch.serve import telemetry as T


@dataclasses.dataclass
class Request:
    """One serving request. `done` means completed; `failed` is the other
    terminal state (shed, deadline miss, cancel, device error or NaN
    logits; reason in `fail_reason`). The robustness fields
    (serve/admission.py) only act under an engine's `admission=`: a
    priority class (higher admits, and evicts, first), deadlines in seconds
    from submit, and the count of times the request was preempted (it then
    re-queues with `out_tokens` as resume state). `arrival_ts` is the
    intended arrival (absolute seconds on the serving clock) that
    drive_open_loop stamps before submit; the engines anchor the telemetry
    submit time and the deadline clock there (None: arrived at submit).
    The paged engine stamps `admit_step`, the 0-based index of the first
    step after the request's first admission, and `first_token_step`, that
    of the step that produced its first token, both from its count of
    steps run (`occupancy_steps`): first_token_step - admit_step + 1 steps
    from admission to the first token."""
    uid: int
    prompt: np.ndarray            # (t,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    priority: int = 0
    deadline_ttft: float | None = None   # seconds, submit -> first token
    deadline_e2e: float | None = None    # seconds, submit -> finish
    failed: bool = False
    fail_reason: str | None = None
    preemptions: int = 0
    arrival_ts: float | None = None
    admit_step: int | None = None
    first_token_step: int | None = None


def refuse_interleaved(cfg, engine: str):
    """The slot-arena engines hold one kind of layer cache for every layer;
    an interleaved model (Mamba-2 and attention layers) is served by the
    packed PagedEngine alone."""
    if cfg.family == "interleaved":
        raise ValueError(f"{engine}: {cfg.name} interleaves Mamba-2 and "
                         "attention layers, whose per-slot state only the "
                         "packed PagedEngine holds")


def kv_cache_bytes(cache) -> int:
    """Allocated KV bytes of an engine cache (the slot arena or the paged
    block pool): k/v payload, the hot buffers, and the int8 pools'
    per-block scales."""
    return sum(leaf.numel() * leaf.element_size()
               for name, leaf in cache["layers"].items()
               if name in ("k", "v", "hot_k", "hot_v", "k_scale", "v_scale"))


def kv_cache_byte_stats(cache, cfg, max_len: int | None = None) -> dict:
    """Padded (as allocated) and LOGICAL KV bytes of an engine cache, the
    JAX package's accounting. The port stores the true head_dim (no lane
    padding), so the two differ only where a slot arena's rows were rounded
    up (kv_store_geometry) and `max_len` is given: `logical` counts the
    first max_len rows. Paged pools pass None. int8 pools count one byte a
    value, and their (L, N, Hkv) f32 scales in full on both sides; hot
    buffers count in full on both sides."""
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


# the engines' base key, jax.random.PRNGKey(0) in the JAX engines
BASE_KEY = prng.prng_key(0)


def sample_tokens(key, logits: torch.Tensor, temps, uids,
                  gen_idx) -> np.ndarray:
    """Per-row sampling of (B, V) logits: greedy where temps == 0,
    categorical otherwise. Returns (B,) np.int64.

    Greedy rows are a device argmax (the FIRST maximal index on ties, as
    jnp.argmax). A hot row draws from jax.random.categorical's stream
    under fold_in(fold_in(key, uid), gen_idx), on the logits divided by its
    temperature in the logits' dtype: a request's samples are a pure
    function of (request, position), whatever the batch, scheduler or step
    layout. Negative uids wrap through uint32. Greedy rows never enter the
    categorical path; only the B indices leave the device."""
    greedy = torch.argmax(logits, dim=-1)
    temps = np.asarray(temps, np.float64)
    hot = np.flatnonzero(temps > 0)
    if hot.size == 0:
        with T.span("repro.sample.wait"):
            return greedy.cpu().numpy().astype(np.int64)
    uids = np.asarray(uids)
    gen_idx = np.asarray(gen_idx)
    keys = torch.tensor([prng.fold_in(prng.fold_in(key, int(uids[i])),
                                      int(gen_idx[i])) for i in hot],
                        dtype=torch.int64, device=logits.device)
    rows = torch.as_tensor(hot, device=logits.device)
    scaled = logits[rows] / torch.tensor(temps[hot, None],
                                         dtype=logits.dtype,
                                         device=logits.device)
    out = greedy.index_put((rows,), prng.categorical(keys, scaled))
    with T.span("repro.sample.wait"):
        return out.cpu().numpy().astype(np.int64)


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
    """The wave engine. `decode_steps` counts the batched decode steps run
    so far (each runs every layer's attention once)."""

    def __init__(self, params, cfg, *, max_batch: int = 8,
                 max_len: int = 512, eos_id: int | None = None,
                 cache_dtype=None, telemetry=None, device=None):
        self.device = resolve_device(device)
        refuse_interleaved(cfg, "the wave engine")
        if cfg.kv_quant != "none":
            raise ValueError(
                f"kv_quant={cfg.kv_quant!r} quantizes the paged block pool; "
                "the wave engine's slot arena is fp-only (use PagedEngine)")
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
        self._key = BASE_KEY
        # request-lifecycle tracing and step-phase profiling (telemetry.py);
        # disabled by default, every hook a flag check
        self.telemetry = T.as_telemetry(telemetry)
        warn_decode_kernel_fallback(cfg)

    def submit(self, req: Request):
        validate_prompt(req.prompt, self.max_len)
        if self.telemetry.enabled:
            self.telemetry.metrics.on_submit(req.uid, len(req.prompt),
                                             ts=req.arrival_ts)
        self._queue.append(req)

    def _sample(self, logits, temps: np.ndarray, wave):
        return sample_tokens(self._key, logits, temps,
                             [r.uid for r in wave],
                             [len(r.out_tokens) for r in wave])

    def _fence(self):
        prof = self.telemetry.profiler
        if prof.enabled and prof.fence:
            T.device_fence(self.device)

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
        tel = self.telemetry
        prof = tel.profiler
        b = len(wave)
        temps = np.asarray([r.temperature for r in wave])
        with prof.step("prefill"):
            if tel.enabled:
                # wave admission is wave start: members leave the queue here
                for r in wave:
                    tel.metrics.on_admit(r.uid)
                tel.metrics.sample_queue_depth()
            with prof.phase("device"):
                toks = torch.tensor(np.stack([r.prompt for r in wave]),
                                    dtype=torch.int32, device=self.device)
                with torch.inference_mode():
                    logits, cache = M.prefill(
                        self.w, self.hccs, {"tokens": toks}, self.cfg,
                        max_len=self.max_len, cache_dtype=self.cache_dtype)
                self._fence()
            with prof.phase("sample"):
                nxt = self._sample(logits, temps, wave)
        live = np.ones(b, bool)
        # the prefill-sampled token counts against the budget and may be EOS,
        # exactly as in the continuous engine's admission
        for i, r in enumerate(wave):
            tok = int(nxt[i])
            r.out_tokens.append(tok)
            if tel.enabled:
                tel.metrics.on_first_token(r.uid)
            if (len(r.out_tokens) >= r.max_new_tokens or
                    (self.eos_id is not None and tok == self.eos_id)):
                r.done = True
                live[i] = False
                if tel.enabled:
                    tel.metrics.on_finish(r.uid, len(r.out_tokens))
        # the host's copy of the cache frontier (the JAX engine reads the
        # device scalar back instead)
        length = len(wave[0].prompt)
        max_steps = max(r.max_new_tokens for r in wave) - 1
        for _ in range(max(max_steps, 0)):
            if not live.any():
                break
            with prof.step("decode"):
                with prof.phase("device"):
                    last = torch.tensor(nxt[:, None], dtype=torch.int32,
                                        device=self.device)
                    with torch.inference_mode():
                        logits, cache = M.decode_step(
                            self.w, self.hccs, last, cache, self.cfg)
                    self._fence()
                with prof.phase("sample"):
                    # finished rows sample greedily (free); their tokens are
                    # discarded
                    nxt = self._sample(logits, np.where(live, temps, 0.0),
                                       wave)
            self.decode_steps += 1
            length += 1
            for i, r in enumerate(wave):
                if not live[i]:
                    continue
                tok = int(nxt[i])
                r.out_tokens.append(tok)
                if (len(r.out_tokens) >= r.max_new_tokens or
                        (self.eos_id is not None and tok == self.eos_id)):
                    r.done = True
                    live[i] = False
                    if tel.enabled:
                        tel.metrics.on_finish(r.uid, len(r.out_tokens))
            if not live.any() or length >= self.max_len - 1:
                break
        for r in wave:
            r.done = True
            if tel.enabled:
                # budget/cache-full exits that never hit an in-loop finish
                tel.metrics.on_finish(r.uid, len(r.out_tokens))

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

    def snapshot(self) -> dict:
        """The schema-versioned telemetry snapshot (T.make_snapshot). The
        wave engine allocates a slot cache per wave, so kv_cache reports
        that per-wave reservation; it has no prefix or padding counters."""
        cache = M.init_cache(self.cfg, self.max_batch, self.max_len,
                             self.cache_dtype, device="meta")
        return T.make_snapshot(
            "wave", self.telemetry,
            kv_cache=kv_cache_byte_stats(cache, self.cfg, self.max_len))
