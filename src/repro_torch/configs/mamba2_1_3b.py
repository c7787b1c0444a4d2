"""mamba2-1.3b [arXiv:2405.21060]: attention-free SSD.

HCCS is INAPPLICABLE here (no softmax anywhere) — the arch is built without
the technique; see DESIGN.md §Arch-applicability.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", family="ssm", num_layers=48, d_model=2048,
    num_heads=0, num_kv_heads=0, d_ff=0, vocab_size=50280,
    norm="rmsnorm", rope="none", ssm_state=128, ssm_expand=2,
    ssm_head_dim=64, ssm_groups=1, ssm_chunk=256,
    attention_prob="softmax",  # unused: no attention
    dtype="bfloat16",
)
