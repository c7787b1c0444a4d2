"""int8 quantization utilities: the port of `repro/quant/int8.py`.

Symmetric per-tensor / per-channel quantizers with a straight-through
estimator, the substrate shared by weight quantization and the paged int8
KV write path (`kernels/kv_quant.py`).

Rounding mode is an explicit choice. The paper's int8 MAC datapath rounds
half AWAY from zero (`sign(x) * floor(|x| + 0.5)`), while `torch.round`
rounds half to EVEN, as `jnp.round` does. The two disagree exactly on ties
(+-0.5, +-1.5, ...). Every quantizer takes `rounding=` with the hardware
mode ("half_away") as the default; "nearest_even" stays available for
bit-matching accelerator reference paths.
"""
from __future__ import annotations

import numpy as np
import torch

ROUNDING_MODES = ("half_away", "nearest_even")


def round_to_int(x: torch.Tensor, rounding: str = "half_away"):
    """Round float to integer-valued float under an explicit tie rule.

    half_away    — ties away from zero (0.5 -> 1, -0.5 -> -1): the paper's
                   int8 MAC rounder.
    nearest_even — IEEE banker's rounding (torch.round): ties to the even
                   neighbour (0.5 -> 0, 1.5 -> 2).
    """
    if rounding == "half_away":
        return torch.sign(x) * torch.floor(torch.abs(x) + 0.5)
    if rounding == "nearest_even":
        return torch.round(x)
    raise ValueError(
        f"rounding must be one of {ROUNDING_MODES}, got {rounding!r}")


def quantize(x: torch.Tensor, scale, rounding: str = "half_away"):
    """Real int8 quantization (no STE): returns int8 values."""
    return torch.clamp(round_to_int(x / scale, rounding),
                       -128, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale):
    return q.to(torch.float32) * scale


def fake_quant(x: torch.Tensor, scale, rounding: str = "half_away"):
    """STE fake-quant: float in, float out, int8 grid forward; the gradient
    passes straight through (`detach`, JAX's stop_gradient)."""
    q = torch.clamp(round_to_int(x / scale, rounding), -128.0, 127.0)
    y = q * scale
    return x + (y - x).detach()


def per_channel_scale(x: np.ndarray, axis: int) -> np.ndarray:
    reduce_axes = tuple(i for i in range(x.ndim) if i != axis)
    amax = np.abs(x).max(axis=reduce_axes)
    return np.maximum(amax, 1e-6) / 127.0


def quantize_weights_tree(weights, rng_unused=None):
    """Fake-quantize every >= 2-d float leaf of a nested dict (per-tensor
    scale); returns a new tree."""
    def one(leaf):
        if isinstance(leaf, dict):
            return {k: one(v) for k, v in leaf.items()}
        if (not isinstance(leaf, torch.Tensor) or leaf.dim() < 2
                or not leaf.is_floating_point()):
            return leaf
        # the scale in the leaf's own dtype, as the JAX package takes it
        scale = torch.clamp(leaf.abs().max(), min=1e-6) / 127.0
        return fake_quant(leaf.float(), scale.float()).to(leaf.dtype)
    return one(weights)
