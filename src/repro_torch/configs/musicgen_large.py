"""musicgen-large [arXiv:2306.05284]: decoder-only over EnCodec tokens.

The EnCodec frontend is a STUB: input_specs() feeds precomputed frame
embeddings (B, T, D); the backbone is a standard MHA decoder (kv = heads)
predicting the 2048-entry codebook.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio", num_layers=48, d_model=2048,
    num_heads=32, num_kv_heads=32, d_ff=8192, vocab_size=2048,
    activation="gelu", norm="layernorm", rope="none",
    input_mode="embeddings", attention_prob="hccs", dtype="bfloat16",
    tie_embeddings=False,
)
