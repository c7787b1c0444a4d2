# Hand-written Hopper kernels of the port (sources under csrc/, built by
# build.py on first launch), each beside its plain PyTorch version:
#   hccs.py         — standalone HCCS row softmax (csrc/hccs_rows.cu)
#   softmax_bf16.py — exp-based softmax baseline (csrc/softmax_bf16.cu)
#   attention.py    — fused two-pass HCCS attention (csrc/hccs_fused.cu)
#   decode.py       — single-query HCCS attention: packed steps, paged and
#                     slot-arena decode (csrc/hccs_{packed,paged,arena}.cu)
# ops.py holds the public wrappers; ref.py names the plain versions.
from repro_torch.kernels.ops import (hccs_attention, hccs_decode,
                                     hccs_packed_prefill, hccs_paged_decode,
                                     hccs_softmax, softmax_reference)
