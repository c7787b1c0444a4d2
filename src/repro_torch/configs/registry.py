"""Architecture registry: arch id -> ModelConfig, the CPU-smoke reduction,
and the dry-run's inputs: `input_specs` gives meta-device tensors (shapes and
dtypes, no storage), the port's counterpart of jax.ShapeDtypeStruct, and
`iter_cells` walks the (arch x shape) grid."""
from __future__ import annotations

import importlib

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.configs.shapes import SHAPES, shape_applicable

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
    if arch == "granite-4.0-h-micro":   # port-only (no JAX twin)
        mod = importlib.import_module(
            "repro_torch.configs.granite_4_0_h_micro")
        return mod.CONFIG
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor inputs for one (arch x shape) cell.

    train shapes -> the whole train-step batch (tokens or embeddings, and
    labels); prefill -> the prompt batch; decode -> a one-token batch (the
    launcher builds the cache from model.init_cache on the meta device)."""
    b = shape.global_batch
    t = shape.seq_len if shape.kind != "decode" else 1

    def tok(shape_):
        return torch.empty(shape_, dtype=torch.int32, device="meta")

    batch: dict = {}
    if cfg.input_mode == "embeddings":
        batch["embeddings"] = torch.empty((b, t, cfg.d_model),
                                          dtype=getattr(torch, cfg.dtype),
                                          device="meta")
    else:
        batch["tokens"] = tok((b, t))
    if shape.kind == "train":
        batch["labels"] = tok((b, t))
    if cfg.rope == "mrope":
        batch["mrope_positions"] = tok((3, b, t))
    return batch


def iter_cells(include_skipped: bool = False):
    """Yield (arch, shape, applicable) for the 40-cell grid."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok = shape_applicable(cfg, shape)
            if ok or include_skipped:
                yield arch, shape, ok
