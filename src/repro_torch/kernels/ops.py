"""The public kernel API of the port, under the JAX package's names and
signatures (`repro/kernels/ops.py`).

Each wrapper dispatches on its tensors' device, as the kernel module
behind it does: CUDA tensors launch the hand-written kernel (built from
`kernels/csrc/` on first launch, never at import) and count one launch on
that kernel's wrapper; CPU tensors run its plain PyTorch version. The
`block_*` arguments are accepted for parity: the CUDA kernels choose their
own tiles.
"""
from __future__ import annotations

from repro_torch.kernels import decode as _decode
from repro_torch.kernels.attention import hccs_mha_fused as _hccs_mha_fused
from repro_torch.kernels.hccs import hccs_rows as _hccs_rows
from repro_torch.kernels.softmax_bf16 import softmax_bf16 as _softmax_bf16


def hccs_softmax(x_int8, theta, mode: str = "i16_div",
                 block_rows: int = 256):
    """Standalone HCCS row softmax: (N, C) int8 logits -> (N, C) int32
    probs (kernels/hccs.py)."""
    return _hccs_rows(x_int8, theta, mode=mode, block_rows=block_rows)


def softmax_reference(x, block_rows: int = 256):
    """Exp-based BF16 softmax baseline, the paper's comparison target
    (kernels/softmax_bf16.py)."""
    return _softmax_bf16(x, block_rows=block_rows)


def hccs_attention(q, k, v, scale, theta, causal: bool = True,
                   block_q: int = 128, block_k: int = 128):
    """Fused two-pass HCCS attention (kernels/attention.py)."""
    return _hccs_mha_fused(q, k, v, scale, theta, causal=causal,
                           block_q=block_q, block_k=block_k)


def hccs_decode(q, k, v, lengths, scale, theta, mode: str = "wide",
                static_max: bool = False, block_k: int = 128):
    """Fused single-query HCCS decode attention over a slot arena
    (kernels/decode.py)."""
    return _decode.hccs_decode(q, k, v, lengths, scale, theta, mode=mode,
                               static_max=static_max)


def hccs_paged_decode(q, k_pool, v_pool, block_table, lengths, scale, theta,
                      mode: str = "wide", static_max: bool = False,
                      block_k: int = 128, k_scales=None, v_scales=None):
    """Block-table-gather single-query HCCS decode (kernels/decode.py).
    k_scales/v_scales (N, Hkv) f32 dequantize int8 pools in-tile."""
    return _decode.hccs_paged_decode(
        q, k_pool, v_pool, block_table, lengths, scale, theta, mode=mode,
        static_max=static_max, k_scales=k_scales, v_scales=v_scales)


def hccs_packed_prefill(q, k_pool, v_pool, block_table, slot_ids, lengths,
                        scale, theta, mode: str = "wide",
                        static_max: bool = False, block_k: int = 128,
                        k_scales=None, v_scales=None):
    """Token-centric packed-step HCCS attention (kernels/decode.py).
    k_scales/v_scales (N, Hkv) f32 dequantize int8 pools in-tile."""
    return _decode.hccs_packed_prefill(
        q, k_pool, v_pool, block_table, slot_ids, lengths, scale, theta,
        mode=mode, static_max=static_max, k_scales=k_scales,
        v_scales=v_scales)
