"""nemotron-4-15b [arXiv:2402.16819]: dense GQA, squared-ReLU MLP."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b", family="dense", num_layers=32, d_model=6144,
    num_heads=48, num_kv_heads=8, d_ff=24576, vocab_size=256000,
    activation="squared_relu", norm="layernorm", rope="rope",
    rope_theta=10000.0, attention_prob="hccs", dtype="bfloat16",
    tie_embeddings=False,
)
