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
(`checkpoint/`) and the training launcher (`launch/train.py`). The SSM
and hybrid families serve on the wave and continuous engines, as in the
JAX package. Everything else (hot buffers, multi-device) raises
NotImplementedError naming the ROADMAP.md item that ports it.

Entry points (`models.model.init_params`, the engines, `train`'s
`make_train_state`, calibration, `launch/serve.py`, `launch/train.py`) run
on the card by default and raise when there is none; the CPU is used only
when asked for (`device="cpu"`).
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
