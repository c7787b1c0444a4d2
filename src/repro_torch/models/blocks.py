"""Transformer blocks — the dense family of `repro/models/blocks.py`.

    apply_block(p, x, cfg, hccs, cache, length, positions) -> (x, new_cache)

cache is one layer's dict ('k', 'v' and, on paged steps, the step's
steering arrays); `length` is carried by the model, not per layer.

MoE, SSM (Mamba2) and hybrid blocks are not ported yet (ROADMAP.md item
A10).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models.layers import DTYPES, apply_mlp, apply_norm


def init_norm(cfg, dtype, device, layers: int | None = None):
    shape = (cfg.d_model,) if layers is None else (layers, cfg.d_model)
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def init_mlp(gen, cfg, dtype, device, layers: int):
    d, f = cfg.d_model, cfg.d_ff
    std = d ** -0.5
    rand = (lambda shape, s: torch.randn(
        shape, generator=gen, dtype=dtype, device=device) * s)
    p = {"w_in": rand((layers, d, f), std),
         "w_out": rand((layers, f, d), f ** -0.5)}
    if cfg.activation in ("swiglu", "geglu"):
        p["w_gate"] = rand((layers, d, f), std)
    return p


def check_family(cfg):
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family={cfg.family!r} is not ported yet (dense only): "
            f"ROADMAP.md item A10")


def init_block(gen, cfg, dtype, device, layers: int):
    """The L stacked dense blocks: (L, ...) leaves, the layout the JAX
    package's vmapped init produces."""
    check_family(cfg)
    p = {"norm1": init_norm(cfg, dtype, device, layers),
         "attn": attn.init_attention(gen, cfg, dtype, device, layers)}
    if cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, dtype, device, layers)
        p["mlp"] = init_mlp(gen, cfg, dtype, device, layers)
    return p


def init_layer_cache(cfg, batch, max_len, cache_dtype=None, device=None):
    """Zero slot-arena K/V for ONE layer, (batch, Hkv, len_c, head_dim) with
    len_c from attention.kv_store_geometry. cache_dtype=None resolves to
    cfg.cache_dtype."""
    check_family(cfg)
    dt = DTYPES[cache_dtype or cfg.cache_dtype]
    hd_c, len_c = attn.kv_store_geometry(cfg, max_len)
    shape = (batch, cfg.num_kv_heads, len_c, hd_c)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def apply_block(p, x, cfg, hccs=None, cache=None, length=None,
                positions=None):
    """One dense block on one layer's params. Returns (x, new_cache)."""
    check_family(cfg)
    ac = None
    if cache is not None:
        ac = dict(cache)
        ac["length"] = length
    y, new_cache = attn.apply_attention(p["attn"], apply_norm(p["norm1"], x,
                                                              cfg),
                                        cfg, hccs, positions, ac)
    x = x + y
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x, new_cache
