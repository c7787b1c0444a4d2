"""Quantization-aware training helpers (paper §V-B) — the port of
`repro/core/qat.py`.

The paper's recipe: freeze the calibrated HCCS parameters theta_h, then
retrain the surrounding model weights so the network adapts to the fixed
surrogate, as quantization bounds are held fixed during QAT (the model's
forward detaches `hccs`; the optimizer only sees `weights`).

This module provides the fake-quant primitives and the logit-scale observer
used to pick the int8 scale per attention head before calibration.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.hccs import _clip, _ste_round, true_div

ste_round = _ste_round


def fake_quant_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 fake-quantization with STE. Returns dequantized
    floats."""
    q = _clip(ste_round(true_div(x, scale)), -128.0, 127.0)
    return q * scale


@dataclasses.dataclass
class AbsMaxObserver:
    """Running abs-max observer for picking per-head int8 logit scales.

    scale = max|x| / 127 with a small EMA so outlier batches don't dominate.
    numpy throughout, as the JAX package's.
    """
    momentum: float = 0.9
    amax: np.ndarray | None = None

    def update(self, x, head_axes: tuple[int, ...]) -> None:
        """x: logits (numpy or a tensor); head_axes: axes to KEEP (e.g.
        (0, 1) for (L, H, ...))."""
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        reduce_axes = tuple(i for i in range(x.ndim) if i not in head_axes)
        amax = np.abs(np.asarray(x)).max(axis=reduce_axes)
        if self.amax is None:
            self.amax = amax
        else:
            self.amax = self.momentum * self.amax + (1 - self.momentum) * amax

    def scales(self) -> np.ndarray:
        assert self.amax is not None, "observer never updated"
        return np.maximum(self.amax, 1e-6) / 127.0


def logit_scale_from_amax(amax) -> torch.Tensor:
    """max(amax, 1e-6) / 127 in f32 (on amax's device for a tensor)."""
    a = torch.as_tensor(amax, dtype=torch.float32)
    return true_div(torch.clamp(a, min=1e-6), 127.0)
