"""The precision control: the reference computed one step below the
configurations' stated precision. The configurations serve bfloat16
weights and activations; the next step down is 8-bit floating point
(e4m3), which an inference change could be tempted to take. Every matrix
product's operands are rounded to e4m3 with one scale per row of the
activation and one per output column of the weight (amax / 448), the
products accumulated in float32."""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def _round(t, dim):
    s = torch.clamp(t.abs().amax(dim=dim, keepdim=True), min=1e-12) \
        / E4M3_MAX
    return (t / s).to(torch.float8_e4m3fn).float() * s


class Fp8:
    """`cast` for bench/reference/decoder.py: e4m3 operands."""

    @staticmethod
    def act(t):
        return _round(t, -1)

    @staticmethod
    def weight(w):
        return _round(w, -2)
