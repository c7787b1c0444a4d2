"""qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B family]: 128-expert top-8 MoE.

Beyond-paper: the router softmax can also run HCCS (ordering-preserving, so
expert selection is unchanged) — enabled via --hccs-router in the launcher.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe", num_layers=94, d_model=4096,
    num_heads=64, num_kv_heads=4, head_dim=128, d_ff=1536, vocab_size=151936,
    num_experts=128, experts_per_token=8, moe_capacity_factor=1.25,
    activation="swiglu", norm="rmsnorm", rope="rope", rope_theta=1_000_000.0,
    attention_prob="hccs", dtype="bfloat16", tie_embeddings=False,
)
