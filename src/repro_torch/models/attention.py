"""GQA attention with HCCS — the port of `repro/models/attention.py`.

Ported: the parameter init, the kernel-eligibility gate, the cache storage
geometry, the KV writes (paged scatter, the int8 pool's quantizing fold
`kernels/kv_quant.py` and slot-arena scatter, all in place: the JAX package
donates its buffers to XLA for the same effect), the projections + RoPE,
the dense and blockwise two-pass attention (HCCS in its STE form, and the
softmax baseline), and every cache branch serving runs:

  packed paged step   the fused `hccs_packed_prefill` kernel, or (kernel
                      off, i8 modes, softmax) the per-slot STE grid
  lockstep paged step blockwise/dense STE over the gathered pool;
                      `hccs_paged_decode` at t == 1 with the kernel on
  slot arena          wave (scalar length) and continuous ((B,) length)
                      caches; `hccs_decode` at t == 1 with the kernel on

Paged pools are float, or int8 with per-(block, kv head) scales
(cfg.kv_quant="int8"): every paged branch reads them dequantized.

Without a cache (training, calibration capture) the dense and blockwise
paths write nothing in place, so autograd can differentiate them; inside
`capture_attention_logits()` every dense-attention call appends its f32
logits (B, H, Tq, Tk), as the JAX package's eager capture does.

Positions rotate by RoPE, or by M-RoPE over (3, B, T) position streams
(`mrope_positions`; without them every stream is the token position).

With cfg.hot_buffer > 0 a slot-arena cache also carries `hot_k` / `hot_v`
and the layer's `hot_len`: a step of at most 8 tokens appends there and
attends to the main (prompt) and hot segments, each segment's partial sums
taken against one shared max and merged (`_merge_segments`; HCCS scores
are clipped-linear, so the partial sums add exactly). Hot buffers block the
decode kernel, so this path is always the STE attention.

One departure from the JAX package: the dense path returns the query's
dtype, as its blockwise path and the kernels do. The JAX dense path returns
the cache's dtype, so with bf16 weights and an f32 cache its engines fail
to trace (the layer scan's carry changes dtype); see ROADMAP.md section C.
"""
from __future__ import annotations

import torch

from repro_torch.core.constraints import default_params
from repro_torch.core.hccs import (HCCSParams, hccs_mode_inv, hccs_qat,
                                   true_div)
from repro_torch.kernels.decode import (hccs_decode, hccs_packed_prefill,
                                        hccs_paged_decode)
from repro_torch.kernels.kv_quant import paged_quant_scatter_kv
from repro_torch.models.layers import apply_mrope, apply_rope
from repro_torch.parallel.sharding import (constrain, einsum, is_dtensor,
                                           unflatten)

NEG_INF = -1e30

# eager capture hook for offline calibration: inside
# `capture_attention_logits()` every dense-attention call appends its float
# logits (B, H, Tq, Tk), scaled by 1/sqrt(d) and taken BEFORE masking (a
# causal model's rows hold its masked future keys too, as the JAX
# package's do)
_CAPTURE: list | None = None


class capture_attention_logits:
    def __enter__(self):
        global _CAPTURE
        _CAPTURE = []
        return _CAPTURE

    def __exit__(self, *a):
        global _CAPTURE
        _CAPTURE = None
        return False


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
    at the constraint-feasible default (offline calibration,
    `core/calibrate.py`, replaces them)."""
    B, S, D = default_params(n_ref)
    h = max(cfg.num_heads, 1)
    full = (lambda v, dt: torch.full((h,), v, dtype=dt, device=device))
    return {"B": full(B, torch.int32), "S": full(S, torch.int32),
            "D": full(D, torch.int32), "scale": full(0.1, torch.float32)}


def _ste(v_hard, v_soft):
    return v_soft + (v_hard - v_soft).detach()


def decode_kernel_blockers(cfg) -> list:
    """Static config conditions that keep the fused kernels from
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


def kernel_on(cfg, hccs) -> bool:
    """Whether the fused kernels serve this config's attention: switched
    on, not blocked by the static gate, and HCCS params present."""
    return (cfg.decode_kernel != "none" and not decode_kernel_blockers(cfg)
            and hccs is not None)


def kv_store_geometry(cfg, max_len: int) -> tuple[int, int]:
    """Storage shape (head_dim, seq) of slot-arena K/V buffers.

    With the fused kernel on, the JAX package pads head_dim to the TPU's
    128-lane tile and rounds seq up to a multiple of 128. The port keeps the
    true head_dim (the CUDA kernel needs no lane padding) but rounds seq the
    same way: the arena's length picks dense or blockwise attention and
    sets the blockwise tile split, and the two paths round differently."""
    if cfg.decode_kernel == "none" or decode_kernel_blockers(cfg):
        return cfg.head_dim, max_len
    return cfg.head_dim, -(-max_len // 128) * 128


def _einsum(eq, a, b):
    """einsum under JAX's type promotion (bf16 x f32 runs in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return einsum(eq, a.to(dt), b.to(dt))


def _project_out(out, p, b, t):
    """Merge heads -> output projection. out: (B, H, T, hd) or
    (B, T, H*hd)."""
    if out.dim() == 4:
        out = out.transpose(1, 2).reshape(b, t, -1)
    wo = p["wo"]
    dt = torch.promote_types(out.dtype, wo.dtype)
    return constrain(out.to(dt) @ wo.to(dt), "batch", "seq_act", "embed")


def _slot_scatter(cache_kv, new_kv, lengths):
    """Per-slot KV write, IN PLACE: slot b's (Hkv, t, hd) update lands at
    its own frontier lengths[b] (a scalar length writes every slot at the
    same offset). The start is clamped so the update fits, as JAX's
    dynamic_update_slice clamps it."""
    b, _, tmax, _ = cache_kv.shape
    t = new_kv.shape[2]
    start = torch.clamp(lengths.to(torch.int64).expand(b), 0, tmax - t)
    if is_dtensor(cache_kv):
        # a DTensor cache (the dry-run's, a mesh's): DTensor has no
        # in-place scatter into a sharded sequence dim, so each new row is
        # selected into place over the whole cache, a read and write of
        # every local shard and no collective
        seq = torch.arange(tmax, device=cache_kv.device)[None, None, :, None]
        upd = new_kv.to(cache_kv.dtype)
        for j in range(t):
            hit = seq == (start + j)[:, None, None, None]
            cache_kv.copy_(torch.where(hit, upd[:, :, j:j + 1], cache_kv))
    else:
        pos = start[:, None] + torch.arange(t, device=cache_kv.device)
        rows = torch.arange(b, device=cache_kv.device)[:, None]
        cache_kv[rows, :, pos] = new_kv.transpose(1, 2).to(cache_kv.dtype)
    return cache_kv


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


def _paged_gather(pool, block_table, scales=None):
    """Contiguous (B, Hkv, nblk * block_size, hd) view of each slot's blocks,
    the STE path over a paged cache. Sentinel (-1) entries gather the trash
    block; they only occur at or past the slot's frontier, so the kv_len
    mask hides them. With `scales` (N, Hkv; kv_quant="int8") the int8
    payload is dequantized per (block, kv head) before attention: the same
    values the kernels' tile dequant produces."""
    b, nblk = block_table.shape
    n, hkv, bs, hd = pool.shape
    tbl = block_table.clamp(min=0).long()
    g = pool[tbl]                                  # (B, nblk, Hkv, bs, hd)
    if scales is not None:
        g = g.float() * scales[tbl][..., None, None]
    return g.permute(0, 2, 1, 3, 4).reshape(b, hkv, nblk * bs, hd)


def _block_valid(cfg, q_pos, k_pos, k_len=None):
    """Validity mask (B, 1, Tq, Tk_blk) from positions. q_pos: (B, Tq);
    k_pos: (Tk_blk,) global key positions; k_len: (B,) or None."""
    qp = q_pos[:, None, :, None]
    kp = k_pos[None, None, None, :]
    valid = torch.ones(qp.shape[:3] + (k_pos.shape[0],), dtype=torch.bool,
                       device=q_pos.device)
    if cfg.causal:
        valid = valid & (kp <= qp)
    if cfg.window:
        valid = valid & (kp > qp - cfg.window)
    if k_len is not None:
        valid = valid & (kp < k_len[:, None, None, None])
    return valid


def _sqrt_hd(hd, device):
    return torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                   device=device))


def _dense_attention(q, k, v, valid, cfg, hccs):
    """q: (B,H,Tq,hd), k/v: (B,Hkv,Tk,hd), valid: (B,1,Tq,Tk). Returns
    (B,H,Tq,hd) in q's dtype."""
    b, h, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = h // hkv
    qg = unflatten(q, 1, (hkv, g))
    logits = _einsum("bkgqd,bktd->bkgqt", qg, k).float()
    logits = (logits / _sqrt_hd(hd, q.device)).reshape(b, h, tq, tk)
    if _CAPTURE is not None:
        _CAPTURE.append(logits.detach())
    if cfg.attention_prob == "hccs" and hccs is not None:
        params = HCCSParams(B=hccs["B"][:, None, None],
                            S=hccs["S"][:, None, None],
                            D=hccs["D"][:, None, None])
        p = hccs_qat(logits, hccs["scale"][:, None, None], params,
                     mode=cfg.hccs_mode, hard=True, mask=valid)
    else:
        p = torch.softmax(torch.where(valid, logits, NEG_INF), dim=-1)
    pg = unflatten(p, 1, (hkv, g)).to(v.dtype)
    out = _einsum("bkgqt,bktd->bkgqd", pg, v)
    return out.reshape(b, h, tq, hd).to(q.dtype)


def _blockwise_attention(q, k, v, q_pos, k_len, cfg, hccs):
    """Two-pass KV-block loop; per-block masks computed from positions.

    HCCS: pass 1 = row max of quantized logits (Stage 1 over a KV sweep);
    pass 2 = distance/clamp/affine (Stages 2-3), Z (Stage 4) and s@V, with
    one final normalization (Stage 5). Softmax: classic online rescale.
    The blocks are visited in order, as the JAX package's lax.scan does."""
    b, h, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    g = h // hkv
    bk = min(cfg.block_k, tk)
    nblk = -(-tk // bk)
    pad = nblk * bk - tk
    kp = torch.nn.functional.pad(k, (0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, pad))
    kb = kp.reshape(b, hkv, nblk, bk, hd).movedim(2, 0)
    vb = vp.reshape(b, hkv, nblk, bk, hd).movedim(2, 0)
    if k_len is None:
        k_len = torch.full((b,), tk, dtype=torch.int32, device=q.device)
    qg = unflatten(q, 1, (hkv, g))
    sm = true_div(1.0, _sqrt_hd(hd, q.device))
    kpos = torch.arange(bk, device=q.device)

    def logits_of(kblk):
        lg = _einsum("bkgqd,bktd->bkgqt", qg, kblk).float() * sm
        return lg.reshape(b, h, tq, bk)

    if cfg.attention_prob == "hccs" and hccs is not None:
        scale = hccs["scale"][:, None, None]
        B = hccs["B"][:, None, None].float()
        S = hccs["S"][:, None, None].float()
        D = hccs["D"][:, None, None].float()

        def qint_of(i):
            vmask = _block_valid(cfg, q_pos, i * bk + kpos, k_len)
            lg = logits_of(kb[i]) / scale
            qi = _ste(torch.clamp(torch.round(lg), -128.0, 127.0), lg)
            return torch.where(vmask, qi, -1e9), vmask

        m = torch.full((b, h, tq), -1e9, dtype=torch.float32, device=q.device)
        for i in range(nblk):
            m = torch.maximum(m, qint_of(i)[0].max(-1).values)
        m = m.detach()[..., None]
        acc = torch.zeros((b, h, tq, hd), dtype=v.dtype, device=q.device)
        zsum = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
        for i in range(nblk):
            qi, vmask = qint_of(i)
            delta = torch.minimum(m - qi, D)
            s = torch.where(vmask, B - S * delta, 0.0)
            zsum = zsum + s.sum(-1)
            sg = unflatten(s, 1, (hkv, g)).to(vb.dtype)
            acc = acc + _einsum("bkgqt,bktd->bkgqd", sg, vb[i]).reshape(
                b, h, tq, hd)
        z = torch.clamp(zsum, min=1.0)[..., None]
        # mode-aware final scale: HCCS linearity lets the integer rho
        # truncation be applied to the accumulated numerator post-hoc
        inv = hccs_mode_inv(z, cfg.hccs_mode)
        return (acc.float() * inv).to(q.dtype)

    acc = torch.zeros((b, h, tq, hd), dtype=v.dtype, device=q.device)
    zsum = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    for i in range(nblk):
        vmask = _block_valid(cfg, q_pos, i * bk + kpos, k_len)
        lg = torch.where(vmask, logits_of(kb[i]), NEG_INF)
        m_new = torch.maximum(m, lg.max(-1).values)
        corr = torch.exp(m - m_new)
        e = torch.exp(lg - m_new[..., None])
        zsum = zsum * corr + e.sum(-1)
        eg = unflatten(e, 1, (hkv, g)).to(vb.dtype)
        pv = _einsum("bkgqt,bktd->bkgqd", eg, vb[i]).reshape(b, h, tq, hd)
        acc = acc * corr[..., None].to(acc.dtype) + pv
        m = m_new
    z = torch.clamp(zsum, min=1e-20)[..., None]
    return (acc.float() / z).to(q.dtype)


def _packed_attention(q, k_pool, v_pool, cache, cfg, hccs, k_scales=None,
                      v_scales=None):
    """Token-centric attention for the packed paged step.

    q: (1, H, T, hd) — the T lanes are ragged tokens from different slots;
    cache carries `slot_ids` (T,) owning slot (-1 = pad lane), `kv_len` (T,)
    per-token causal frontiers (position + 1), `block_table` (B, nblk), and
    the grid steering below. Each token attends only within its slot's
    blocks. Returns (1, T, H*hd).

    With the fused kernel on, the whole ragged batch runs
    `hccs_packed_prefill`, which walks block_table[slot_ids[t]] per token.
    Otherwise (kernel off, i8 modes, softmax) the tokens ride a compact
    PER-SLOT GRID for the attention core only: `grid_pos` (T,) scatters each
    token to cell (slot, position - frontier) of a (B, Wb) grid (Wb is
    `q_pos_grid`'s width; pad lanes land in a spill row), the grid runs the
    same dense/blockwise STE attention as the lockstep layout at width Wb
    over each slot's gathered blocks (one gather per slot, not per token),
    and the outputs gather back to packed lanes."""
    _, h, t, hd = q.shape
    sid = cache["slot_ids"]
    qt = q[0].transpose(0, 1)                               # (T, H, hd)
    if kernel_on(cfg, hccs):
        o = hccs_packed_prefill(qt.float().contiguous(), k_pool, v_pool,
                                cache["block_table"], sid, cache["kv_len"],
                                hccs["scale"], _theta(hccs),
                                mode=cfg.hccs_mode,
                                static_max=(cfg.decode_kernel
                                            == "static_max"),
                                k_scales=k_scales, v_scales=v_scales)
        return o.to(q.dtype).reshape(1, t, h * hd)
    q_pos_grid = cache["q_pos_grid"]                        # (B, Wb)
    gp = cache["grid_pos"].long()                           # (T,) spill B*Wb
    k_len = cache["kv_len_slot"]                            # (B,)
    nb, wb = q_pos_grid.shape
    qg = torch.zeros((nb * wb + 1, h, hd), dtype=qt.dtype, device=q.device)
    qg[gp] = qt
    qg = qg[:nb * wb].reshape(nb, wb, h, hd).transpose(1, 2)
    kg = _paged_gather(k_pool, cache["block_table"], k_scales)
    vg = _paged_gather(v_pool, cache["block_table"], v_scales)
    tk = kg.shape[2]
    use_blockwise = (cfg.attention_impl == "blockwise" or
                     (cfg.attention_impl == "auto" and wb > 1 and
                      tk >= cfg.blockwise_threshold))
    if use_blockwise:
        out = _blockwise_attention(qg, kg, vg, q_pos_grid, k_len, cfg, hccs)
    else:
        valid = _block_valid(cfg, q_pos_grid,
                             torch.arange(tk, device=q.device), k_len)
        out = _dense_attention(qg, kg, vg, valid, cfg, hccs)
    out = out.transpose(1, 2).reshape(nb * wb, h * hd)
    return out[torch.where(sid >= 0, gp, 0)][None]          # (1, T, H*hd)


def _merge_segments(parts, cfg, hccs):
    """Combine per-segment partials computed against a SHARED max.

    parts: list of (s_sum (B,H,Tq), acc (B,H,Tq,hd)): for HCCS sums of
    clipped-linear scores (linear, so additive), for softmax exp-sums
    against the shared max. out = sum(acc) / sum(Z), in f32."""
    zsum = sum(p[0] for p in parts)
    acc = sum(p[1] for p in parts)
    floor = 1.0 if (cfg.attention_prob == "hccs" and hccs) else 1e-20
    return acc.float() / torch.clamp(zsum, min=floor)[..., None]


def _segment_logits(q, k):
    """(B, H, Tq, Tk) f32 logits of q (B,H,Tq,hd) against one segment's
    k (B,Hkv,Tk,hd), scaled by 1/sqrt(hd)."""
    b, h, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = unflatten(q, 1, (hkv, h // hkv))
    logits = _einsum("bkgqd,bktd->bkgqt", qg, k).float()
    return (logits / _sqrt_hd(hd, q.device)).reshape(b, h, tq, tk)


def _segment_partials(q, k, v, valid, m, cfg, hccs):
    """One segment's (Z_partial, acc_partial) against the shared max m
    (B,H,Tq,1). HCCS: s = B - S*min(m - qint, D) on valid lanes; softmax:
    e = exp(logits - m)."""
    b, h, tq, hd = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    logits = _segment_logits(q, k)
    if cfg.attention_prob == "hccs" and hccs is not None:
        scale = hccs["scale"][:, None, None]
        B = hccs["B"][:, None, None].float()
        S = hccs["S"][:, None, None].float()
        D = hccs["D"][:, None, None].float()
        qi = _ste(torch.clamp(torch.round(logits / scale), -128.0, 127.0),
                  logits / scale)
        qi = torch.where(valid, qi, -1e9)
        s = torch.where(valid, B - S * torch.minimum(m - qi, D), 0.0)
    else:
        s = torch.where(valid, torch.exp(logits - m), 0.0)
    sg = unflatten(s, 1, (hkv, h // hkv)).to(v.dtype)
    acc = _einsum("bkgqt,bktd->bkgqd", sg, v).reshape(b, h, tq, hd)
    return s.sum(-1), acc


def _segment_max(q, k, valid, cfg, hccs):
    """Per-row max of the (quantized) logits over one segment; (B,H,Tq)."""
    logits = _segment_logits(q, k)
    if cfg.attention_prob == "hccs" and hccs is not None:
        logits = torch.round(torch.clamp(
            logits / hccs["scale"][:, None, None], -128.0, 127.0))
    return torch.where(valid, logits, -1e9).max(-1).values


def _hot_attention(q, k, v, positions, cache, cfg, hccs):
    """The hot-buffer step: append k/v (B,Hkv,t,hd) to the hot buffers at
    `hot_len`, IN PLACE (the start clamped as JAX's dynamic_update_slice
    clamps it), then attend to the main segment (the prompt's
    `length - hot_len` rows) and the hot segment against a shared,
    stop-gradient max. Returns (out (B,H,t,hd) in q's dtype, new_cache)."""
    b = q.shape[0]
    t = k.shape[2]
    hot_len, length = cache["hot_len"], cache["length"]
    hk = _slot_scatter(cache["hot_k"], k, hot_len)
    hv = _slot_scatter(cache["hot_v"], v, hot_len)
    main_len = length - hot_len                        # the prompt's rows
    mk, mv = cache["k"], cache["v"]
    valid_main = _block_valid(cfg, positions,
                              torch.arange(mk.shape[2], device=q.device),
                              main_len.to(torch.int32).expand(b))
    hot_pos = main_len + torch.arange(hk.shape[2], device=q.device)
    valid_hot = _block_valid(cfg, positions, hot_pos,
                             (length + t).to(torch.int32).expand(b))
    m = torch.maximum(_segment_max(q, mk, valid_main, cfg, hccs),
                      _segment_max(q, hk, valid_hot, cfg, hccs))
    m = m.detach()[..., None]
    parts = [_segment_partials(q, mk, mv, valid_main, m, cfg, hccs),
             _segment_partials(q, hk, hv, valid_hot, m, cfg, hccs)]
    out = _merge_segments(parts, cfg, hccs).to(q.dtype)
    return out, {"k": mk, "v": mv, "hot_k": hk, "hot_v": hv}


def _theta(hccs):
    return torch.stack([hccs["B"], hccs["S"], hccs["D"]], dim=-1)


def _quant_write(cache, k, v):
    """kv_quant="int8": fold this step's K and V rows into the int8 pools,
    in place, in one launch, after resetting the scales of the blocks
    allocated since the last step (stale from a prior owner; COW copies are
    not fresh: they arrive with payload and scales). A speculative verify
    step's draft lanes fold with the block's scale clamped (provisional
    rows, rewritten after verification). Returns (k pool, k scales, v pool,
    v scales)."""
    return paged_quant_scatter_kv(
        cache["k"], cache["k_scale"], k, cache["v"], cache["v_scale"], v,
        cache["write_pos"], draft_rows=cache.get("draft_rows"),
        fresh_blocks=cache.get("fresh_blocks"))


def apply_attention(p, x, cfg, hccs=None, positions=None, cache=None,
                    mrope_positions=None):
    """x: (B, T, D). Returns (out, new_cache).

    cache: None (self-attention over x), a slot arena {"k", "v":
    (B, Hkv, Tmax, hd), "length"} with a scalar length (lockstep; new K/V
    written at offset `length`) or a (B,) length (per-slot frontiers), or a
    PAGED cache — k/v global block pools (N, Hkv, block_size, hd) plus
    `block_table` (B, nblk), `write_pos` (B, T) flat scatter targets and
    `kv_len` (B,) per-slot valid counts; PACKED paged steps add `slot_ids`
    (T,), x is then a (1, T) ragged token batch and `kv_len` per token (and,
    without the kernel, the grid steering of _packed_attention). int8 pools
    come with `k_scale`/`v_scale` (N, Hkv) and `fresh_blocks`, the blocks
    whose scales reset to 0 before the fold; a speculative verify step adds
    `draft_rows` (1, T) bool (rows folded with a clamped scale) and
    `stage_rows` (new_cache then carries the raw rows as f32 `staged_k` /
    `staged_v` (B, Hkv, T, hd)). A slot arena with hot buffers (`hot_k`,
    `hot_v`, `hot_len`) takes steps of at most 8 tokens through
    _hot_attention; longer steps (the prompt) fill the main arena and
    leave the hot buffers as they are. New K/V are written into the
    cache IN PLACE before attention reads them; new_cache holds the written
    k/v (and scales). The engine guarantees `write_pos` never targets a
    block with refcount > 1 (copy-on-write runs on the host before the
    step), so shared blocks stay immutable."""
    b, t, d = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    # the flat projections carry the constraint (h*hd divides by the TP
    # degree even where the head count does not, e.g. hymba's 25 heads)
    qf = constrain(x @ p["wq"], "batch", "attn_seq", "model")
    kf = constrain(x @ p["wk"], "batch", "attn_seq", "kv_model")
    vf = constrain(x @ p["wv"], "batch", "attn_seq", "kv_model")
    q = unflatten(qf, -1, (h, hd)).transpose(1, 2)
    k = unflatten(kf, -1, (hkv, hd)).transpose(1, 2)
    v = unflatten(vf, -1, (hkv, hd)).transpose(1, 2)
    if positions is None:
        base = (cache["length"] if cache is not None
                else torch.zeros((), dtype=torch.int32, device=x.device))
        # base is a scalar (lockstep) or a (B,) per-slot length vector
        positions = (torch.atleast_1d(base)[:, None]
                     + torch.arange(t, device=x.device)[None, :]
                     ).expand(b, t)
    if cfg.rope == "rope":
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    elif cfg.rope == "mrope":
        p3 = mrope_positions
        if p3 is None:
            p3 = positions[None].expand((3,) + tuple(positions.shape))
        q = apply_mrope(q, p3, cfg.rope_theta, cfg.mrope_sections)
        k = apply_mrope(k, p3, cfg.rope_theta, cfg.mrope_sections)

    if cache is not None and "hot_k" in cache and t <= 8:
        out, new_cache = _hot_attention(q, k, v, positions, cache, cfg, hccs)
        return _project_out(out, p, b, t), new_cache

    new_cache = None
    k_len = None
    if cache is not None and "block_table" in cache:
        ks = vs = None
        if "k_scale" in cache:
            kc, ks, vc, vs = _quant_write(cache, k, v)
        else:
            kc = _paged_scatter(cache["k"], k, cache["write_pos"])
            vc = _paged_scatter(cache["v"], v, cache["write_pos"])
        new_cache = {"k": kc, "v": vc}
        if ks is not None:
            new_cache.update(k_scale=ks, v_scale=vs)
        if "stage_rows" in cache:
            # speculative verify over an int8 pool: hand back this layer's
            # raw new rows, for the engine's post-verification replay
            new_cache.update(staged_k=k.float(), staged_v=v.float())
        if "slot_ids" in cache:
            out = _packed_attention(q, kc, vc, cache, cfg, hccs, ks, vs)
            return _project_out(out, p, b, t), new_cache
        # per-slot valid-KV counts for this step (length + per-slot t_valid;
        # chunked prefill makes t_valid ragged, so `length + t` is wrong here)
        k_len = cache["kv_len"]
        if t == 1 and kernel_on(cfg, hccs):
            # block-sparse fused decode: the kernel walks the block table
            o = hccs_paged_decode(q[:, :, 0, :].float().contiguous(), kc, vc,
                                  cache["block_table"], k_len,
                                  hccs["scale"], _theta(hccs),
                                  mode=cfg.hccs_mode,
                                  static_max=(cfg.decode_kernel
                                              == "static_max"),
                                  k_scales=ks, v_scales=vs)
            out = o.to(q.dtype).reshape(b, 1, h * hd)
            return _project_out(out, p, b, 1), new_cache
        k = _paged_gather(kc, cache["block_table"], ks)
        v = _paged_gather(vc, cache["block_table"], vs)
    elif cache is not None:
        length = cache["length"]
        if length.dim() == 0 and cache["k"].shape[2:] == k.shape[2:]:
            # the prompt fills the whole cache: a plain overwrite
            cache["k"].copy_(k)
            cache["v"].copy_(v)
        else:
            # every slot writes at its own frontier (or the shared scalar)
            _slot_scatter(cache["k"], k, length)
            _slot_scatter(cache["v"], v, length)
        k, v = cache["k"], cache["v"]
        new_cache = {"k": k, "v": v}
        k_len = (length + t).to(torch.int32).expand(b)
        if t == 1 and kernel_on(cfg, hccs):
            # fused decode: one new token against the slot arena, per-slot
            # length masking
            o = hccs_decode(q[:, :, 0, :].float().contiguous(), k, v,
                            k_len.contiguous(), hccs["scale"], _theta(hccs),
                            mode=cfg.hccs_mode,
                            static_max=(cfg.decode_kernel == "static_max"))
            out = o.to(q.dtype).reshape(b, 1, h * hd)
            return _project_out(out, p, b, 1), new_cache

    tk = k.shape[2]
    use_blockwise = (cfg.attention_impl == "blockwise" or
                     (cfg.attention_impl == "auto" and t > 1 and
                      tk >= cfg.blockwise_threshold))
    if use_blockwise:
        # one gather point: both HCCS passes read the same seq-replicated
        # K/V
        k = constrain(k, "batch", "kv_model", None, None)
        v = constrain(v, "batch", "kv_model", None, None)
        out = _blockwise_attention(q, k, v, positions, k_len, cfg, hccs)
    else:
        valid = _block_valid(cfg, positions,
                             torch.arange(tk, device=x.device), k_len)
        out = _dense_attention(q, k, v, valid, cfg, hccs)
    return _project_out(out, p, b, t), new_cache
