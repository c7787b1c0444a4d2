"""Primitive layers: norms, rotary embeddings, MLP variants, embedding and
the padded-vocab LM head — the port of `repro/models/layers.py`.

Parameters are plain dicts of tensors in the JAX package's layout: weight
matrices are (in, out) and applied as `x @ W`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def apply_norm(p, x, cfg, eps=1e-6):
    """RMSNorm or LayerNorm, computed in float32, returned in x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].float() + p["bias"].float()
    else:  # rmsnorm
        ms = xf.square().mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * p["scale"].float()
    return y.to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int, theta: float):
    """positions: (..., T) int -> cos/sin of shape (..., T, dim//2)."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=positions.device), exps)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, T, d); positions: (B, T)."""
    d = x.shape[-1]
    cos, sin = rope_angles(positions, d, theta)        # (B, T, d/2)
    cos = cos[:, None]
    sin = sin[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Multimodal RoPE (qwen2-vl): positions3 (3, B, T) = (t, h, w) ids.

    The head-dim halves are split into `sections` (summing to d/2); each
    section rotates with its own positional stream."""
    d = x.shape[-1]
    half = d // 2
    assert sum(sections) == half, (sections, half)
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freq = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=x.device), exps)
    # per-frequency-slot section id -> which positional stream drives it
    sec_id = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))               # (half,)
    pos_sel = positions3.float()[sec_id]                       # (half, B, T)
    ang = pos_sel.movedim(0, -1) * freq                        # (B, T, half)
    cos = torch.cos(ang)[:, None]
    sin = torch.sin(ang)[:, None]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def apply_mlp(p, x, cfg):
    """The four MLP activations; GELU is the tanh form, as jax.nn.gelu's
    default."""
    h = x @ p["w_in"]
    if cfg.activation == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif cfg.activation == "geglu":
        h = F.gelu(x @ p["w_gate"], approximate="tanh") * h
    elif cfg.activation == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif cfg.activation == "squared_relu":       # nemotron-4
        h = torch.square(F.relu(h))
    else:
        raise ValueError(cfg.activation)
    return h @ p["w_out"]


def embed_tokens(p, tokens, cfg):
    return p["table"][tokens.long()]


def lm_logits(embed_p, head_p, x, cfg):
    """Logits over the padded vocab; pad lanes masked to -1e30 (Megatron-
    style padded vocab; semantics unchanged)."""
    w = embed_p["table"].t() if cfg.tie_embeddings else head_p["lm_head"]
    logits = x @ w.to(x.dtype)
    if cfg.padded_vocab != cfg.vocab_size:
        lane = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(lane < cfg.vocab_size, logits,
                             torch.full_like(logits, -1e30))
    return logits
