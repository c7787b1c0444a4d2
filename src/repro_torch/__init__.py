"""PyTorch/CUDA port of the HCCS system (`repro`, the JAX package, is the
reference). It keeps the JAX package's module paths and function names;
inside, it is plain PyTorch on an explicit device plus hand-written Hopper
kernels under `kernels/csrc/`.

Ported so far: every model family of the registry (dense, MoE, Mamba2
SSD, the Hymba hybrid, the BERT encoders, the embedding-input audio and
VLM backbones with M-RoPE); greedy and sampled serving through the three
engines (the packed and lockstep `PagedEngine` with int8 KV,
sharing, sessions, speculative decoding, overload robustness and the async
loop; `ContinuousEngine`; the wave `ServeEngine`), the public kernel API
(`repro_torch.kernels`), and the paper's method around them: offline
per-head calibration (`core/calibrate.py` on the `hccs_rows` kernel),
quantization-aware training with theta frozen (`core/qat.py`, `train/`,
`optim/`, `data/`), checkpoints in the JAX package's layout
(`checkpoint/`, restored sharded onto a mesh too) and the training
launcher (`launch/train.py`). The SSM and hybrid families serve on the
wave and continuous engines, and hot buffers on the wave engine, as in the
JAX package. The multi-device layer maps logical axes onto a
`DeviceMesh` (`parallel/`, `launch/mesh.py`) and dry-runs any cell on meta
DTensors with an H100 roofline (`launch/dryrun.py`, `launch/roofline.py`,
`launch/inspect_hlo.py`). Every module of the JAX package has its
counterpart here.

Entry points (`models.model.init_params`, the engines, `train`'s
`make_train_state`, calibration, `launch/serve.py`, `launch/train.py`) run
on the card by default and raise when there is none; the CPU is used only
when asked for (`device="cpu"`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
