"""granite-3-2b [hf:ibm-granite/granite-3.0-2b-base]: dense GQA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b", family="dense", num_layers=40, d_model=2048,
    num_heads=32, num_kv_heads=8, d_ff=8192, vocab_size=49155,
    activation="swiglu", norm="rmsnorm", rope="rope", rope_theta=10000.0,
    attention_prob="hccs", dtype="bfloat16",
)
