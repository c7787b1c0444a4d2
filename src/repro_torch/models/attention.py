"""GQA attention with HCCS — the port of `repro/models/attention.py`, as far
as the packed paged serving step reaches.

Ported: the parameter init, the kernel-eligibility gate, the paged KV
scatter, the projections + RoPE, and the packed token branch with the fused
kernel (`kernels/decode.py` hccs_packed_prefill). Every other path of the
JAX module raises NotImplementedError naming the ROADMAP.md item that ports
it: self-attention without a cache, the slot arena and hot buffers, the
lockstep paged branch (item B2), the per-slot XLA grid and the STE
dense/blockwise attention (items A3/A4), and int8 KV (item A4).
"""
from __future__ import annotations

import torch

from repro_torch.core.constraints import default_params
from repro_torch.kernels.decode import hccs_packed_prefill
from repro_torch.models.layers import apply_rope


def _normal(gen, shape, dtype, device, std):
    return torch.randn(shape, generator=gen, dtype=dtype, device=device) * std


def init_attention(gen, cfg, dtype, device, layers: int):
    """(L, ...) stacked projections, drawn like the JAX init (normal, std
    d**-0.5; the output projection (h*hd)**-0.5) — the same distributions,
    not the same numbers."""
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    std = d ** -0.5
    return {
        "wq": _normal(gen, (layers, d, h * hd), dtype, device, std),
        "wk": _normal(gen, (layers, d, hkv * hd), dtype, device, std),
        "wv": _normal(gen, (layers, d, hkv * hd), dtype, device, std),
        "wo": _normal(gen, (layers, h * hd, d), dtype, device,
                      (h * hd) ** -0.5),
    }


def init_hccs_head_params(cfg, device, n_ref: int = 128) -> dict:
    """Per-head HCCS (B, S, D) + int8 logit scale for one layer: shapes (H,),
    at the constraint-feasible default (offline calibration replaces them;
    not ported yet, ROADMAP.md item A9)."""
    B, S, D = default_params(n_ref)
    h = max(cfg.num_heads, 1)
    full = (lambda v, dt: torch.full((h,), v, dtype=dt, device=device))
    return {"B": full(B, torch.int32), "S": full(S, torch.int32),
            "D": full(D, torch.int32), "scale": full(0.1, torch.float32)}


def decode_kernel_blockers(cfg) -> list:
    """Static config conditions that keep the fused kernel from
    dispatching, as human-readable strings (empty = eligible)."""
    blockers = []
    if cfg.attention_prob != "hccs":
        blockers.append(f"attention_prob={cfg.attention_prob}")
    if cfg.hccs_mode not in ("wide", "i16_div", "i16_clb"):
        # i8 per-element truncation is not post-hoc linear
        blockers.append(f"hccs_mode={cfg.hccs_mode} (i8 is XLA-only)")
    if cfg.window:
        blockers.append(f"window={cfg.window}")
    if cfg.hot_buffer:
        blockers.append(f"hot_buffer={cfg.hot_buffer}")
    return blockers


def kernel_path_blockers(cfg) -> list:
    """Why the port cannot serve `cfg` yet: the fused-kernel gate plus the
    kernel being switched off. The STE attention that serves those configs
    in the JAX package is ROADMAP.md items A3/A4."""
    blockers = decode_kernel_blockers(cfg)
    if cfg.decode_kernel == "none":
        blockers.append("decode_kernel='none'")
    return blockers


def _paged_scatter(pool, new_kv, write_pos):
    """Write t new KV vectors per row into the global paged block pool, IN
    PLACE (the JAX step donates the pool to XLA for the same effect).

    pool: (N, Hkv, block_size, hd); new_kv: (B, Hkv, t, hd); write_pos:
    (B, t) int32 flat pool positions (block_id * block_size + offset),
    host-computed by the engine — lanes past a slot's valid count point at
    the reserved trash block 0, where colliding writes are harmless."""
    n, hkv, bs, hd = pool.shape
    pos = write_pos.reshape(-1).long()
    upd = new_kv.permute(0, 2, 1, 3).reshape(-1, hkv, new_kv.shape[-1])
    pool[pos // bs, :, pos % bs, :] = upd.to(pool.dtype)
    return pool


def _packed_attention(q, k_pool, v_pool, cache, cfg, hccs):
    """Token-centric attention for the packed paged step, kernel branch.

    q: (1, H, T, hd) — the T lanes are ragged tokens from different slots;
    cache carries `slot_ids` (T,) owning slot (-1 = pad lane), `kv_len` (T,)
    per-token causal frontiers (position + 1) and `block_table` (B, nblk).
    The whole ragged batch runs the fused `hccs_packed_prefill` kernel.
    Returns (1, T, H*hd)."""
    _, h, t, hd = q.shape
    qt = q[0].transpose(0, 1).float().contiguous()          # (T, H, hd)
    theta = torch.stack([hccs["B"], hccs["S"], hccs["D"]], dim=-1)
    o = hccs_packed_prefill(qt, k_pool, v_pool, cache["block_table"],
                            cache["slot_ids"], cache["kv_len"],
                            hccs["scale"], theta, mode=cfg.hccs_mode,
                            static_max=(cfg.decode_kernel == "static_max"))
    return o.to(q.dtype).reshape(1, t, h * hd)


def apply_attention(p, x, cfg, hccs=None, positions=None, cache=None):
    """x: (1, T, D) packed token batch. Returns (out, new_cache).

    cache: one layer's paged cache — k/v global block pools
    (N, Hkv, block_size, hd) plus the step's `block_table` (B, nblk),
    `write_pos` (1, T) flat scatter targets, per-token `kv_len` (T,) and
    `slot_ids` (T,). The new K/V are written into the pools in place before
    attention reads them."""
    if cache is None or "block_table" not in cache:
        raise NotImplementedError(
            "attention without a paged cache (dense/blockwise STE, slot "
            "arena, hot buffers) is not ported yet: ROADMAP.md items A3, A7")
    if "slot_ids" not in cache:
        raise NotImplementedError(
            "the lockstep paged step (hccs_paged_decode) is not ported yet: "
            "ROADMAP.md item B2")
    if "k_scale" in cache:
        raise NotImplementedError(
            "int8 paged KV (paged_quant_scatter) is not ported yet: "
            "ROADMAP.md item A4")
    if hccs is None or kernel_path_blockers(cfg):
        raise NotImplementedError(
            f"the packed step without the fused kernel "
            f"({', '.join(kernel_path_blockers(cfg)) or 'no hccs params'}) "
            f"runs the per-slot STE grid, not ported yet: ROADMAP.md item A4")
    if cfg.rope not in ("rope", "none"):
        raise NotImplementedError(
            f"rope={cfg.rope!r} is not ported yet: ROADMAP.md item A3")
    b, t, d = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, t, h, hd).transpose(1, 2)
    k = (x @ p["wk"]).reshape(b, t, hkv, hd).transpose(1, 2)
    v = (x @ p["wv"]).reshape(b, t, hkv, hd).transpose(1, 2)
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    kc = _paged_scatter(cache["k"], k, cache["write_pos"])
    vc = _paged_scatter(cache["v"], v, cache["write_pos"])
    out = _packed_attention(q, kc, vc, cache, cfg, hccs)
    return out @ p["wo"], {"k": kc, "v": vc}

