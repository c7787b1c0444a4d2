"""hymba-1.5b [arXiv:2411.13676]: hybrid — parallel attention + mamba heads
per block, mean-fused; sliding-window attention keeps long-context decode
sub-quadratic (window 2048; Hymba uses SWA in most layers)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b", family="hybrid", hybrid=True, num_layers=32,
    d_model=1600, num_heads=25, num_kv_heads=5, head_dim=64, d_ff=5504,
    vocab_size=32001, activation="swiglu", norm="rmsnorm", rope="rope",
    ssm_state=16, ssm_expand=2, ssm_head_dim=64, ssm_groups=1,
    window=2048, attention_prob="hccs", dtype="bfloat16",
)
