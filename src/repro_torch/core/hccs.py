"""HCCS constants and the Stage-5 reciprocal the attention kernel applies.

The part of `repro/core/hccs.py` that the served model needs. Modes (paper
§III-B): i16_div uses rho = floor(T/Z); i16_clb uses T / 2^floor(log2 Z);
"wide" normalizes with the exact reciprocal 1/Z.
"""
from __future__ import annotations

import torch

INV_SHIFT = 15          # R in the paper's eq. (8)
OUT_SHIFT = 0           # extra down-shift on the int8 output path
T_I16 = 32767           # target integer scale, int16 output
T_I8 = 255              # target integer scale, int8 output


def hccs_mode_inv(z: torch.Tensor, mode: str) -> torch.Tensor:
    """Float form of the Stage-5 reciprocal for linear post-hoc scaling:
    out = (sum_i s_i v_i) * hccs_mode_inv(Z, mode), with z float32 >= 1.

    HCCS is linear in the active window, so the i16 integer reciprocal
    truncations can be applied to the accumulated float numerator after the
    fact. The i8 modes floor per element after the rho multiply, which is
    not post-hoc linear; they (and "wide") get the exact reciprocal. The
    CUDA kernel evaluates the same float formula (kernels/csrc)."""
    if mode == "i16_div":
        return torch.floor(T_I16 / z) / T_I16
    if mode == "i16_clb":
        return torch.floor(T_I16 * torch.exp2(-torch.floor(torch.log2(z)))) \
            / T_I16
    return 1.0 / z
