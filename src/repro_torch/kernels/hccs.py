"""Standalone HCCS row softmax: the port of `repro/kernels/hccs.py`.

Algorithm 1 of the paper on rows of int8 logits, in int32 lanes:

  1. m = max x                          (int8 widened to int32)
  2. delta = min(m - x, D)
  3. s = B - S * delta
  4. Z = max(sum s, 1)                  (int32)
  5. the mode's normalization           (exact Q0 divide or leading-bit
                                         shift; int16 or int8 output)

`hccs_rows` dispatches on the tensors' device: CUDA tensors launch the
hand-written kernel `csrc/hccs_rows.cu` (or raise) and bump
`hccs_rows.launches`; CPU tensors run the plain PyTorch version beside it,
`hccs_rows_ref`. There is no fallback from one to the other. The sums are
integer, so the kernel and the plain version agree bit for bit on every
input.
"""
from __future__ import annotations

import torch

from repro_torch.core.hccs import hccs_scores, normalize
from repro_torch.kernels.build import cuda_device, launch

# the JAX kernel's modes, with their codes in csrc/hccs_rows.cu
MODES = ("i16_div", "i16_clb", "i8_div", "i8_clb")


def hccs_rows_ref(x_int: torch.Tensor, theta: torch.Tensor,
                  mode: str = "i16_div") -> torch.Tensor:
    """Plain PyTorch version (the twin of `repro/kernels/ref.py`
    hccs_rows_ref). x_int: (N, C) integer logits (int8 values in any int
    dtype); theta: (N, 3) int32 per-row (B, S, D). Returns (N, C) int32."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    s, z = hccs_scores(x_int.to(torch.int32), theta[:, 0:1], theta[:, 1:2],
                       theta[:, 2:3])
    return normalize(s, z, mode)


def hccs_rows(x_int8: torch.Tensor, theta: torch.Tensor, *,
              mode: str = "i16_div", block_rows: int = 256) -> torch.Tensor:
    """HCCS softmax over rows of x_int8: (N, C) int8 -> (N, C) int32.

    theta: (N, 3) int32 per-row (B, S, D); broadcast per-head params to
    rows before calling. Any C >= 1: the kernel masks by its loop bounds, so
    nothing is padded. x is cast with `.to(torch.int8)` (wrapping, as the
    JAX kernel's astype). `block_rows` is accepted for parity with the JAX
    signature; the CUDA kernel runs one warp per row whatever it is.

    CUDA tensors launch the kernel (and bump `hccs_rows.launches`); CPU
    tensors run `hccs_rows_ref`."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if x_int8.dim() != 2 or x_int8.shape[1] < 1:
        raise ValueError(f"x must be (N, C) with C >= 1, got "
                         f"{tuple(x_int8.shape)}")
    n, c = x_int8.shape
    if tuple(theta.shape) != (n, 3):
        raise ValueError(f"theta must be ({n}, 3), got {tuple(theta.shape)}")
    x = x_int8.to(torch.int8)
    theta = theta.to(torch.int32)
    if x.device.type == "cpu":
        return hccs_rows_ref(x, theta, mode)
    x, theta = x.contiguous(), theta.contiguous()
    dev = cuda_device(x, theta)
    out = torch.empty((n, c), dtype=torch.int32, device=dev)
    if n:
        launch(hccs_rows, "hccs_rows_launch", dev, x, theta, out, n, c,
               MODES.index(mode))
    return out


# launches of the CUDA kernel in this process (CPU calls never count)
hccs_rows.launches = 0
