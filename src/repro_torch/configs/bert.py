"""BERT-tiny / BERT-small (arXiv:1908.08962) — the paper's own eval models.

Used by the Table I/II accuracy benchmarks (not part of the 40-cell grid).
hccs_mode=i16_div at n<=128 is the paper's exact integer datapath.
"""
from repro_torch.configs.base import ModelConfig

BERT_TINY = ModelConfig(
    name="bert-tiny", family="encoder", num_layers=2, d_model=128,
    num_heads=2, num_kv_heads=2, d_ff=512, vocab_size=30522,
    activation="gelu", norm="layernorm", rope="learned", causal=False,
    num_classes=2, max_position=512, attention_prob="hccs",
    hccs_mode="i16_div", attention_impl="dense", tie_embeddings=False,
)

BERT_SMALL = ModelConfig(
    name="bert-small", family="encoder", num_layers=4, d_model=512,
    num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=30522,
    activation="gelu", norm="layernorm", rope="learned", causal=False,
    num_classes=2, max_position=512, attention_prob="hccs",
    hccs_mode="i16_div", attention_impl="dense", tie_embeddings=False,
)
