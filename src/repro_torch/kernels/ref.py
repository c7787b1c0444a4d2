"""The plain PyTorch version of every kernel of the port, under the names
of the JAX package's oracles (`repro/kernels/ref.py`), so a reader finds
each counterpart. The kernel wrappers run these on CPU tensors, and
`chip_smoke.py` holds each CUDA kernel against its plain version on the
card.

Where a plain version follows the Pallas kernel rather than the JAX oracle:

  hccs_attention_ref    the fused kernel's arithmetic: q and k cast to f32
                        before the product, the product MULTIPLIED by
                        f32(1/sqrt(d)), masked keys at exact zero score.
                        The JAX oracle takes the product in the inputs'
                        dtype and DIVIDES by sqrt(d), so the two may land a
                        logit in neighbouring int8 bins.
  hccs_decode_ref,      the mode-aware post-hoc reciprocal of the decode
  hccs_paged_decode_ref, kernels, and the kernels' skip of sentinel (-1)
  hccs_packed_prefill_ref table entries inside a frontier (the JAX oracles
                        gather pool block 0 there and rely on the mask).
  hccs_rows_ref,        the same as the oracles.
  softmax_bf16_ref
"""
from repro_torch.kernels.attention import \
    hccs_mha_fused_ref as hccs_attention_ref
from repro_torch.kernels.decode import (hccs_decode_ref,
                                        hccs_packed_prefill_ref,
                                        hccs_paged_decode_ref)
from repro_torch.kernels.hccs import hccs_rows_ref
from repro_torch.kernels.softmax_bf16 import softmax_bf16_ref

__all__ = ["hccs_rows_ref", "softmax_bf16_ref", "hccs_attention_ref",
           "hccs_decode_ref", "hccs_paged_decode_ref",
           "hccs_packed_prefill_ref"]
