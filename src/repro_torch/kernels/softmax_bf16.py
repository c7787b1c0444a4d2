"""Exp-based row softmax, the paper's baseline: the port of
`repro/kernels/softmax_bf16.py`.

Per row, in float32 whatever the input type: m = max x, e = exp(x - m),
z = sum e, out = e / z (a true division), cast back to the input's type.
This is the function HCCS is benchmarked against (paper Table III).

`softmax_bf16` dispatches on the tensor's device: CUDA tensors launch the
hand-written kernel `csrc/softmax_bf16.cu` (or raise) and bump
`softmax_bf16.launches`; CPU tensors run the plain PyTorch version beside
it, `softmax_bf16_ref`. There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.build import cuda_device, launch

# input types the kernel takes, with their codes in csrc/softmax_bf16.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def softmax_bf16_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version (the twin of `repro/kernels/ref.py`
    softmax_bf16_ref): (N, C) -> (N, C) in x's dtype, f32 arithmetic."""
    x32 = x.float()
    e = torch.exp(x32 - x32.amax(dim=-1, keepdim=True))
    return (e / e.sum(dim=-1, keepdim=True)).to(x.dtype)


def softmax_bf16(x: torch.Tensor, *, block_rows: int = 256) -> torch.Tensor:
    """Row softmax of x: (N, C) bfloat16 or float32 -> the same dtype, by
    explicit exp in float32. Any C >= 1. `block_rows` is accepted for parity
    with the JAX signature; the CUDA kernel runs one warp per row.

    CUDA tensors launch the kernel (and bump `softmax_bf16.launches`); CPU
    tensors run `softmax_bf16_ref`."""
    if x.dim() != 2 or x.shape[1] < 1:
        raise ValueError(f"x must be (N, C) with C >= 1, got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"x must be one of {list(DTYPES)}, got {x.dtype}")
    if x.device.type == "cpu":
        return softmax_bf16_ref(x)
    x = x.contiguous()
    dev = cuda_device(x)
    out = torch.empty_like(x)
    if x.shape[0]:
        launch(softmax_bf16, "softmax_bf16_launch", dev, x, out, x.shape[0],
               x.shape[1], DTYPES[x.dtype])
    return out


# launches of the CUDA kernel in this process (CPU calls never count)
softmax_bf16.launches = 0
