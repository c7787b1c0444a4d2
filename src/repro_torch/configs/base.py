"""Model/config dataclasses shared by every architecture config.

A copy of `repro/configs/base.py`: the same fields, defaults, checks and
properties (tests/test_torch_hygiene.py holds the two equal), kept here so
the port imports nothing of the JAX package."""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm | encoder
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # default d_model // num_heads
    activation: str = "swiglu"       # swiglu | gelu | geglu | squared_relu
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    rope: str = "rope"               # rope | mrope | none | learned
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, ...] = (16, 24, 24)
    causal: bool = True
    # --- HCCS (the paper's technique) ---
    attention_prob: str = "hccs"     # softmax | hccs  (per-arch default: hccs on)
    hccs_mode: str = "wide"          # wide | i16_div | i8_div | i16_clb | i8_clb
    # ("wide" = 32-bit-lane normalization, the TPU adaptation for rows > 128;
    #  bit-faithful integer modes are used at paper-scale row lengths)
    hccs_router: bool = False        # beyond-paper: HCCS for the MoE router
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    moe_groups: int = 0              # dispatch groups (0 = auto by token count)
    # --- SSM (mamba2 / hybrid) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 128
    # --- hybrid (hymba) ---
    hybrid: bool = False             # parallel attn + SSM heads per block
    window: int = 0                  # sliding-window attention (0 = full)
    # --- frontends / misc ---
    input_mode: str = "tokens"       # tokens | embeddings (audio/vlm stubs)
    num_classes: int = 0             # >0: classification head (BERT-style)
    tie_embeddings: bool = True
    dtype: str = "float32"           # param/compute dtype ("bfloat16" at scale)
    attention_impl: str = "auto"     # dense | blockwise | auto
    blockwise_threshold: int = 2048  # seq len above which blockwise is used
    block_k: int = 512               # kv block for blockwise attention
    remat: str = "dots"              # none | dots | full
    scan_unroll: int = 1             # layer-scan unroll (dry-run measurement)
    max_position: int = 1 << 20
    # vocab padded to a TP-friendly multiple (Megatron-style); pad logits are
    # masked to -inf in lm_logits so semantics are unchanged
    vocab_pad_multiple: int = 2048
    # decode hot buffer (tokens): >0 appends decoded KV to a small REPLICATED
    # buffer instead of dynamic-updating the seq-sharded main cache (which
    # forces SPMD to gather the whole cache every token — see §Perf D).
    # Prefill fills the main cache at static offsets; decode attention merges
    # the two segments with a shared max. 0 = classic single-cache decode.
    hot_buffer: int = 0
    # decode-step attention kernel: "fused" dispatches single-token decode to
    # the Pallas hccs_decode kernel (kernels/decode.py) reading K/V straight
    # from the cache with per-slot lengths; "static_max" uses the one-pass
    # ConSmax-style variant (requires ceiling-calibrated logit scales);
    # "none" keeps the XLA STE path. Only active for HCCS attention without
    # hot buffers or sliding windows.
    decode_kernel: str = "none"      # none | fused | static_max
    # KV-cache layout for the serving engines: "slot" reserves a full
    # (max_batch, max_len) arena per engine (wave/continuous schedulers);
    # "paged" draws fixed-size blocks from a global pool via per-request
    # block tables (serve/paged.py), so memory scales with live tokens,
    # not with max_len * max_batch.
    cache_layout: str = "slot"       # slot | paged
    # paged-KV geometry: block_size tokens per KV block (power of two, >= 8,
    # so any kernel block_k <= 128 tiles it evenly); num_blocks sizes the
    # global pool (0 = engine auto-sizes to half the equivalent slot arena)
    block_size: int = 32
    num_blocks: int = 0
    # paged prefix sharing: reuse full-block prompt-prefix KV across requests
    # (system prompts, few-shot headers) via an engine-side prefix index and
    # refcounted copy-on-write blocks (serve/paged.py). Only meaningful with
    # cache_layout == "paged"; the slot-arena engines ignore it.
    prefix_sharing: bool = False
    # paged decode-block sharing: additionally insert GENERATED-token blocks
    # into the prefix trie as they fill (vLLM-style full-sequence hashing),
    # so multi-turn sessions (PagedEngine.submit(..., session=)) reuse the
    # KV of prior turns' replies instead of re-prefilling them. Implies the
    # prefix-sharing machinery (the engine enables it automatically).
    decode_sharing: bool = False
    # KV-cache element dtype for every engine and bare init_cache/prefill
    # caller — single-sourced here so the slot arenas, the paged pool, and
    # direct model.prefill callers can never silently disagree on KV bytes.
    cache_dtype: str = "float32"     # float32 | bfloat16 | float16
    # paged-pool KV quantization (BAPS-style): "int8" stores the K/V pools as
    # int8 with per-block, per-kv-head symmetric scales; rows are folded in
    # position order with a grow-only running amax + device-side requant, so
    # a block's bytes are a pure function of (tokens, positions) — scheduling
    # layout, prefix sharing, and session re-feeds stay bit-identical. Only
    # meaningful with cache_layout == "paged"; slot-arena engines reject it.
    kv_quant: str = "none"           # none | int8
    # trie-driven speculative decoding (paged packed step only): each decode
    # step proposes up to draft_len tokens per slot by extending the slot's
    # matched path through the prefix trie (n-gram prompt-lookup fallback
    # over the slot's own prompt+output), verifies them all in ONE packed
    # step, and rolls back from the first rejection — accepted tokens
    # amortize the per-step cost, rejected ones leave no trace (allocator,
    # trie, and int8 block bytes restored bit-identically).
    speculative: bool = False
    draft_len: int = 4
    # pipelined async engine loop (paged packed step only): dispatch step
    # N+1's packed batch while step N's sampled tokens are still in flight —
    # decode lanes read step N's on-device sampled-token array (token
    # indirection inside the jitted step), and host-side commit (EOS
    # detection, trie registration, telemetry) runs one step behind on the
    # already-landed results. Greedy outputs are token-identical with the
    # loop on or off; hot-temperature and speculative steps fall back to
    # commit-then-dispatch ordering (host sampling / drafting need the
    # landed tokens).
    async_loop: bool = False
    # overload robustness (serve/admission.py; strictly opt-in — all three
    # at their defaults leave the serving engines on the exact legacy
    # fail-fast FIFO path): queue_limit bounds QUEUED requests (0 =
    # unbounded), backpressure picks the overflow policy, preemption lets
    # the paged engine reclaim a lower-class request's blocks (re-queued
    # with resume state) when a higher class would otherwise starve.
    queue_limit: int = 0
    backpressure: str = "reject"     # reject | shed-lowest-priority
    preemption: bool = False

    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.decode_kernel not in ("none", "fused", "static_max"):
            raise ValueError(
                f"decode_kernel must be 'none' | 'fused' | 'static_max', "
                f"got {self.decode_kernel!r}")
        if self.cache_layout not in ("slot", "paged"):
            raise ValueError(f"cache_layout must be 'slot' | 'paged', "
                             f"got {self.cache_layout!r}")
        bs = self.block_size
        if bs < 8 or (bs & (bs - 1)):
            raise ValueError(
                f"block_size must be a power of two >= 8, got {bs}")
        if self.cache_dtype not in ("float32", "bfloat16", "float16"):
            raise ValueError(
                f"cache_dtype must be 'float32' | 'bfloat16' | 'float16', "
                f"got {self.cache_dtype!r}")
        if self.kv_quant not in ("none", "int8"):
            raise ValueError(
                f"kv_quant must be 'none' | 'int8', got {self.kv_quant!r}")
        if self.draft_len < 1:
            raise ValueError(f"draft_len must be >= 1, got {self.draft_len}")
        if self.speculative and self.cache_layout != "paged":
            raise ValueError("speculative decoding drafts against the prefix "
                             "trie and verifies via the packed token step; "
                             "it requires cache_layout == 'paged'")
        if self.backpressure not in ("reject", "shed-lowest-priority"):
            raise ValueError(
                f"backpressure must be 'reject' | 'shed-lowest-priority', "
                f"got {self.backpressure!r}")
        if self.queue_limit < 0:
            raise ValueError(
                f"queue_limit must be >= 0, got {self.queue_limit}")
        if self.preemption and self.cache_layout != "paged":
            raise ValueError("preemption reclaims KV blocks from the paged "
                             "pool; it requires cache_layout == 'paged'")
        if self.async_loop and self.cache_layout != "paged":
            raise ValueError("async_loop pipelines the paged engine's "
                             "packed token step; it requires "
                             "cache_layout == 'paged'")

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return -(-self.vocab_size // m) * m

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell: training or serving geometry."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    moe_aux_weight: float = 0.01
    grad_compression: str = "none"   # none | int8
    seed: int = 0
