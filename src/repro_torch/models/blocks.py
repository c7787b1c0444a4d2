"""Transformer blocks: dense, MoE, Mamba2 (SSD) and Hymba-style hybrid —
the port of `repro/models/blocks.py`.

    apply_block(p, x, cfg, hccs, cache, length, positions, mrope_positions,
                decode) -> (x, new_cache, aux)

cache is one layer's dict ('k', 'v' for attention and, on paged steps, the
step's steering arrays; 'ssm' state for the SSM and hybrid families);
`length` is carried by the model, not per layer. `decode` picks the SSD's
one-token recurrent step over its chunked form. The hybrid block runs
attention and SSD heads in parallel on the same normed input and adds
their mean. `aux` is the MoE block's load-balance loss, a 0-d f32 tensor
(the number 0.0 elsewhere, which costs the card no launch).
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import DTYPES, apply_mlp, apply_norm

ATTN_FAMILIES = ("dense", "moe", "audio", "vlm", "encoder", "hybrid")
# the families whose per-layer cache holds K/V (an encoder has no cache)
KV_FAMILIES = ("dense", "moe", "audio", "vlm", "hybrid")


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


def init_block(gen, cfg, dtype, device, layers: int):
    """The L stacked blocks: (L, ...) leaves, the layout the JAX package's
    vmapped init produces."""
    fam = cfg.family
    p = {"norm1": init_norm(cfg, dtype, device, layers)}
    if fam in ATTN_FAMILIES:
        p["attn"] = attn.init_attention(gen, cfg, dtype, device, layers)
    if fam in ("hybrid", "ssm"):
        p["ssm"] = ssm_mod.init_ssm(gen, cfg, dtype, device, layers)
    if fam == "moe":
        p["norm2"] = init_norm(cfg, dtype, device, layers)
        p["moe"] = moe_mod.init_moe(gen, cfg, dtype, device, layers)
    elif fam != "ssm" and cfg.d_ff > 0:
        p["norm2"] = init_norm(cfg, dtype, device, layers)
        p["mlp"] = init_mlp(gen, cfg, dtype, device, layers)
    return p


def init_layer_cache(cfg, batch, max_len, cache_dtype=None, device=None):
    """Zero cache for ONE layer: slot-arena K/V (batch, Hkv, len_c,
    head_dim), len_c from attention.kv_store_geometry, for the attention
    families; the f32 SSD state (batch, nh, N, P) for ssm and hybrid.
    cache_dtype=None resolves to cfg.cache_dtype."""
    c = {}
    if cfg.family in KV_FAMILIES:
        dt = DTYPES[cache_dtype or cfg.cache_dtype]
        hd_c, len_c = attn.kv_store_geometry(cfg, max_len)
        shape = (batch, cfg.num_kv_heads, len_c, hd_c)
        c["k"] = torch.zeros(shape, dtype=dt, device=device)
        c["v"] = torch.zeros(shape, dtype=dt, device=device)
    if cfg.family in ("ssm", "hybrid"):
        c["ssm"] = torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                                cfg.ssm_head_dim), dtype=torch.float32,
                               device=device)
    return c


def _ssd(p, h, cfg, cache, decode):
    if decode:
        return ssm_mod.apply_ssd_step(p, h, cfg, cache["ssm"])
    return ssm_mod.apply_ssd(p, h, cfg,
                             cache["ssm"] if cache is not None else None)


def _attention(p, h, cfg, hccs, cache, length, positions, mrope_positions):
    ac = None
    if cache is not None:
        ac = {k_: v_ for k_, v_ in cache.items() if k_ != "ssm"}
        ac["length"] = length
    return attn.apply_attention(p, h, cfg, hccs, positions, ac,
                                mrope_positions)


def apply_block(p, x, cfg, hccs=None, cache=None, length=None,
                positions=None, mrope_positions=None, decode: bool = False):
    """One block on one layer's params. Returns (x, new_cache, aux)."""
    aux = 0.0
    new_cache: dict = {}
    fam = cfg.family
    h = apply_norm(p["norm1"], x, cfg)
    if fam == "ssm":
        y, st = _ssd(p["ssm"], h, cfg, cache, decode)
        x = x + y
    elif fam == "hybrid":
        ya, nc = _attention(p["attn"], h, cfg, hccs, cache, length,
                            positions, mrope_positions)
        ys, st = _ssd(p["ssm"], h, cfg, cache, decode)
        if nc is not None:
            new_cache.update(nc)
        x = x + 0.5 * (ya + ys)      # mean-fused parallel heads (Hymba)
    else:
        y, nc = _attention(p["attn"], h, cfg, hccs, cache, length,
                           positions, mrope_positions)
        if nc is not None:
            new_cache.update(nc)
        x = x + y
    if cache is not None and fam in ("ssm", "hybrid"):
        new_cache["ssm"] = st
    if "moe" in p:
        y, aux = moe_mod.apply_moe(p["moe"], apply_norm(p["norm2"], x, cfg),
                                   cfg)
        x = x + y
    elif "mlp" in p:
        x = x + apply_mlp(p["mlp"], apply_norm(p["norm2"], x, cfg), cfg)
    return x, new_cache, aux
