"""qwen2-vl-2b [arXiv:2409.12191]: VLM backbone with M-RoPE.

Vision frontend is a STUB: input_specs() feeds precomputed patch/text
embeddings plus 3D (t, h, w) position ids for M-RoPE (sections 16/24/24
over head_dim/2 = 64).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm", num_layers=28, d_model=1536,
    num_heads=12, num_kv_heads=2, d_ff=8960, vocab_size=151936,
    activation="swiglu", norm="rmsnorm", rope="mrope",
    mrope_sections=(16, 24, 24), rope_theta=1_000_000.0,
    input_mode="embeddings", attention_prob="hccs", dtype="bfloat16",
)
