"""PyTorch/CUDA port of the HCCS system (`repro`, the JAX package, is the
reference). It keeps the JAX package's module paths and function names;
inside, it is plain PyTorch on an explicit device plus hand-written Hopper
kernels under `kernels/csrc/`.

Ported so far: greedy serving of a dense HCCS decoder through the packed
`PagedEngine`, with the `hccs_packed_prefill` CUDA kernel. Everything else
raises NotImplementedError naming the ROADMAP.md item that ports it.

Entry points (`models.model.init_params`, `serve.paged.PagedEngine`,
`launch/serve.py`) run on the card by default and raise when there is none;
the CPU is used only when asked for (`device="cpu"`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
