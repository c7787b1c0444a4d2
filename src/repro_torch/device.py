"""Device selection shared by every entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `cuda` unless the caller names
    another. A CUDA device with no card present raises — the port never
    drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU (the kernels then run their plain PyTorch versions)")
        if dev.index is None:        # tensors report cuda:N, never bare cuda
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
