# HCCS — the paper's primary contribution, as a composable PyTorch module.
from repro_torch.core.hccs import (
    HCCSParams, MODES, hccs_int, hccs_probs, hccs_qat, hccs_scores,
    hccs_attention_prob_fn, hccs_static_max_qat, leading_bit, normalize,
    softmax_fp,
)
from repro_torch.core import calibrate, constraints, qat
