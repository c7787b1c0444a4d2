"""starcoder2-3b [arXiv:2402.19173]: dense GQA (kv=2), RoPE, non-gated GELU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense", num_layers=30, d_model=3072,
    num_heads=24, num_kv_heads=2, d_ff=12288, vocab_size=49152,
    activation="gelu", norm="layernorm", rope="rope", rope_theta=999_999.4,
    attention_prob="hccs", dtype="bfloat16",
)
