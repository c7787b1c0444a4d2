"""Architecture registry: arch id -> ModelConfig, plus the CPU-smoke
reduction. The JAX registry's dry-run helpers (`input_specs`, `iter_cells`)
build jax.ShapeDtypeStructs and are not part of the port."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_ARCH_MODULES = {
    "granite-3-2b": "granite_3_2b",
    "yi-34b": "yi_34b",
    "starcoder2-3b": "starcoder2_3b",
    "nemotron-4-15b": "nemotron_4_15b",
    "musicgen-large": "musicgen_large",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-1.3b": "mamba2_1_3b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in ("bert-tiny", "bert-small"):
        mod = importlib.import_module("repro_torch.configs.bert")
        return mod.BERT_TINY if arch == "bert-tiny" else mod.BERT_SMALL
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def reduced_config(arch: str) -> ModelConfig:
    """CPU-smoke version of an arch: same family/wiring, tiny dims."""
    cfg = get_config(arch)
    kw = dict(
        name=cfg.name + "-smoke", num_layers=2, d_model=128, vocab_size=512,
        dtype="float32", max_position=4096,
    )
    if cfg.num_heads:
        hd = 32
        nh = max(cfg.num_heads // 8, 2)
        nkv = max(cfg.num_kv_heads // 8, 1)
        nkv = max(1, min(nkv, nh))
        while nh % nkv:
            nkv -= 1
        kw.update(num_heads=nh, num_kv_heads=nkv, head_dim=hd)
        if cfg.rope == "mrope":
            s = hd // 2 // 4
            kw.update(mrope_sections=(s, s, hd // 2 - 2 * s))
    if cfg.d_ff:
        kw.update(d_ff=256)
    if cfg.is_moe:
        kw.update(num_experts=4, experts_per_token=2)
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_head_dim=32, ssm_chunk=16)
    if cfg.window:
        kw.update(window=16)
    return cfg.replace(**kw)
