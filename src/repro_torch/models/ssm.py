"""Mamba2 SSD (state-space duality) block — the port of
`repro/models/ssm.py`: the chunked parallel form for training and prefill,
the O(1) recurrent form for decode.

Per head h with state size N and head dim P (arXiv:2405.21060):
    h_t = exp(a_t) * h_{t-1} + dt_t * B_t^T x_t        (a_t = -exp(A_log)*dt_t)
    y_t = C_t h_t + D * x_t
Chunked: an attention-like masked product inside each chunk (the
"duality") and a recurrence over the per-chunk states across chunks (the
JAX package's lax.scan, a loop over chunks here). Softplus is JAX's form,
log(exp(x) + 1) through logaddexp, with no threshold.

The interleaved family's Mamba-2 mixer (`apply_mamba`, port-only) adds a
depthwise causal conv over x, B and C before the SSD, and on a packed
paged step scans each slot's ragged segment from that slot's stored SSD
state and conv window (`kernels/ssd.py`), writing both back in place.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd import ssd_packed_scan
from repro_torch.parallel.sharding import constrain
from repro_torch.spans import span


def init_ssm(gen, cfg, dtype, device, layers: int):
    """(L, ...) stacked SSD params, drawn like the JAX init: in_proj emits
    the z gate (di), x_inner (di), B and C (g*n each) and dt (nh). The
    interleaved family's Mamba-2 mixer adds its depthwise conv over x, B
    and C: `conv_w` (C, ssm_conv) taps, oldest first, and `conv_b` (C,)."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    proj_out = 2 * di + 2 * g * n + nh

    def full(shape, v, dt):
        return torch.full((layers,) + shape, v, dtype=dt, device=device)
    p = {
        "in_proj": torch.randn((layers, d, proj_out), generator=gen,
                               dtype=dtype, device=device) * d ** -0.5,
        "out_proj": torch.randn((layers, di, d), generator=gen, dtype=dtype,
                                device=device) * di ** -0.5,
        "A_log": full((nh,), 0.0, torch.float32),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "D": full((nh,), 1.0, torch.float32),
        "norm": full((di,), 1.0, dtype),
    }
    if cfg.family == "interleaved":
        c, k = di + 2 * g * n, cfg.ssm_conv
        p["conv_w"] = torch.randn((layers, c, k), generator=gen,
                                  dtype=dtype, device=device) * k ** -0.5
        p["conv_b"] = full((c,), 0.0, dtype)
    return p


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(p, x, cfg):
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = constrain(x @ p["in_proj"], "batch", "attn_seq", "model")
    z, xi, Bm, Cm, dt = torch.split(zxbcdt, [di, di, g * n, g * n, nh],
                                    dim=-1)
    return z, xi, Bm, Cm, dt


def _gated_norm(p, y, z, cfg, eps=1e-6):
    yf = (y * F.silu(z.float())).float()
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * p["norm"].float()).to(y.dtype)


def _ssd_chunks(xh, Bh, Ch, dt, a, L, state=None):
    """The chunked SSD in float32: xh (b, t, nh, hp), Bh / Ch (b, t, g, n),
    dt and a (b, t, nh), chunks of L tokens, from `state` (b, nh, n, hp) or
    zeros. Returns (y (b, t, nh, hp) without the D skip, final state)."""
    b, t, nh, hp = xh.shape
    g, n = Bh.shape[2:]
    rep = nh // g
    nc = -(-t // L)
    pad = nc * L - t
    xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
    Bp = F.pad(Bh, (0, 0, 0, 0, 0, pad))
    Cp = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    dtp = F.pad(dt, (0, 0, 0, pad))
    ap = F.pad(a, (0, 0, 0, pad))

    # chunk views (b, nc, L, ...): chunks shard over the TP axis
    xc = constrain(xp.reshape(b, nc, L, nh, hp), "batch", "ssd_chunk", None,
                   None, None)
    Bc = constrain(Bp.reshape(b, nc, L, g, n), "batch", "ssd_chunk", None,
                   None, None)
    Cc = constrain(Cp.reshape(b, nc, L, g, n), "batch", "ssd_chunk", None,
                   None, None)
    dtc = constrain(dtp.reshape(b, nc, L, nh), "batch", "ssd_chunk", None,
                    None)
    ac = constrain(ap.reshape(b, nc, L, nh), "batch", "ssd_chunk", None, None)

    cum = torch.cumsum(ac, dim=2)  # (b,nc,L,nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,Lq,Lk,nh)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=xh.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=xh.device))

    # group-broadcast B/C inside the einsums
    xg = xc.reshape(b, nc, L, g, rep, hp)
    dtg = dtc.reshape(b, nc, L, g, rep)
    # intra-chunk ("attention") term, per group
    cb = torch.einsum("bclgn,bcsgn->bclsg", Cc, Bc)  # (b,nc,L,L,g)
    wg = cb[..., None] * decay.reshape(b, nc, L, L, g, rep)
    wg = wg * dtg[:, :, None]  # (b,nc,Lq,Lk,g,rep)
    y_intra = torch.einsum("bclsgr,bcsgrp->bclgrp", wg, xg).reshape(
        b, nc, L, nh, hp)

    # per-chunk input state contribution
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (b,nc,L,nh)
    wde = (decay_to_end * dtc).reshape(b, nc, L, g, rep)
    Sc = torch.einsum("bclgn,bclgr,bclgrp->bcgrnp", Bc, wde, xg).reshape(
        b, nc, nh, n, hp)
    a_tot = cum[:, :, -1, :]  # (b,nc,nh)

    # inter-chunk recurrence h_c = exp(a_tot_c) h_{c-1} + S_c, keeping the
    # state ENTERING each chunk
    h = (torch.zeros((b, nh, n, hp), device=xh.device) if state is None
         else state.float())
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(a_tot[:, c])[..., None, None] * h + Sc[:, c]
    h_in = torch.stack(h_in, dim=1)  # (b,nc,nh,n,hp)

    decay_from_start = torch.exp(cum).reshape(b, nc, L, g, rep)
    hg = h_in.reshape(b, nc, g, rep, n, hp)
    y_inter = torch.einsum("bclgn,bclgr,bcgrnp->bclgrp", Cc,
                           decay_from_start, hg).reshape(b, nc, L, nh, hp)

    y_sum = constrain(y_intra + y_inter, "batch", "ssd_chunk", None, None,
                      None)
    return y_sum.reshape(b, nc * L, nh, hp)[:, :t], h


def apply_ssd(p, x, cfg, state=None):
    """x: (B, T, D). state: None or (B, nh, N, P) for streaming prefill.

    Returns (out (B, T, D), final_state (B, nh, N, P) f32)."""
    b, t, d = x.shape
    nh, hp, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                    cfg.ssm_state)
    L = min(cfg.ssm_chunk, t)
    z, xi, Bm, Cm, dt = _split_proj(p, x, cfg)
    xh = xi.reshape(b, t, nh, hp).float()
    Bh = Bm.reshape(b, t, g, n).float()
    Ch = Cm.reshape(b, t, g, n).float()
    dt = softplus(dt.float() + p["dt_bias"])  # (b,t,nh)
    a = -torch.exp(p["A_log"]) * dt  # <= 0

    y, h = _ssd_chunks(xh, Bh, Ch, dt, a, L, state)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(b, t, cfg.d_inner).to(x.dtype)
    y = _gated_norm(p, y, z, cfg)
    return constrain(y @ p["out_proj"], "batch", "seq_act", "embed"), h


def apply_ssd_step(p, x, cfg, state):
    """Single-token recurrent step. x: (B, 1, D); state: (B, nh, N, P).
    Returns (out (B, 1, D), new_state f32)."""
    b = x.shape[0]
    nh, hp, g, n = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
                    cfg.ssm_state)
    z, xi, Bm, Cm, dt = _split_proj(p, x, cfg)
    xh = xi.reshape(b, nh, hp).float()
    Bh = Bm.reshape(b, g, n).float()
    Ch = Cm.reshape(b, g, n).float()
    rep = nh // g
    Br = torch.repeat_interleave(Bh, rep, dim=1)  # (b,nh,n)
    Cr = torch.repeat_interleave(Ch, rep, dim=1)
    dt1 = softplus(dt.reshape(b, nh).float() + p["dt_bias"])
    a = torch.exp(-torch.exp(p["A_log"]) * dt1)  # (b,nh)
    upd = torch.einsum("bhn,bhp->bhnp", Br, xh * dt1[..., None])
    new_state = a[..., None, None] * state.float() + upd
    y = torch.einsum("bhn,bhnp->bhp", Cr, new_state)
    y = y + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, cfg.d_inner).to(x.dtype)
    y = _gated_norm(p, y, z, cfg)
    return constrain(y @ p["out_proj"], "batch", None, "embed"), new_state


def packed_segments(slot_ids, positions, slots: int):
    """Each slot's segment of a packed step, as the scan reads it: (first
    lane, tokens, position of the first token), int32 (slots,) each, from
    the step's slot ids (W,) (-1 on pad lanes) and positions (W,). A slot
    with no tokens has 0 tokens. The packer lays segments out contiguously
    in slot order with the pad lanes at the tail (serve/paged.py
    pack_slot_ids), so a slot's first lane is the tokens of the slots
    before it. A segment whose first position is 0 starts from zero state.
    A handful of small operations a step, whatever the slot count."""
    valid = slot_ids >= 0
    bins = torch.where(valid, slot_ids,
                       torch.full_like(slot_ids, slots)).long()
    length = torch.zeros(slots + 1, dtype=torch.int32,
                         device=slot_ids.device).scatter_add_(
        0, bins, valid.to(torch.int32))[:slots]
    start = (torch.cumsum(length, 0, dtype=torch.int32) - length)
    w = slot_ids.shape[0]
    pos0 = positions.to(torch.int32)[start.clamp(max=w - 1).long()]
    return start.contiguous(), length.contiguous(), pos0.contiguous()


def apply_mamba(p, h, cfg, cache=None):
    """The Mamba-2 mixer of an interleaved layer on its normed input h
    (B, T, D):

        z, xBC, dt = split(h W_in)            di, di + 2gn, nh
        xBC = silu(causal depthwise conv(xBC; conv_w, conv_b))
        x, B, C = split(xBC)                  nh heads of hp; g groups of n
        dt = softplus(dt + dt_bias); a = -exp(A_log) dt
        state_t = exp(a_t) state_{t-1} + dt_t x_t B_t^T    f32, per head
        y_t = state_t C_t + D x_t
        out = (rmsnorm(y silu(z)) * norm) W_out

    cache None: each row is one whole sequence from zero state. Else a
    packed step (B == 1): `ssm` (S, nh, n, hp) f32 and `conv` (S, K-1, C)
    are this layer's per-slot state and raw conv window, `segments` the
    step's packed_segments; the scan (kernels/ssd.py ssd_packed_scan)
    starts each segment from its slot's state, or zeros at position 0, and
    writes the final state and window back in place. The conv, the SSD and
    the state's read and write are the `repro.ssm.scan` range."""
    b, t, _ = h.shape
    di, nh, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    g, n, k = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_conv
    zxbcdt = h @ p["in_proj"]
    with span("repro.ssm.scan"):
        if cache is None:
            dev = h.device
            ssm_state = torch.zeros((b, nh, n, hp), dtype=torch.float32,
                                    device=dev)
            conv_state = torch.zeros((b, k - 1, di + 2 * g * n),
                                     dtype=h.dtype, device=dev)
            i32 = dict(dtype=torch.int32, device=dev)
            segments = (torch.arange(b, **i32) * t,
                        torch.full((b,), t, **i32), torch.zeros((b,), **i32))
            slot_ids = torch.arange(b, **i32).repeat_interleave(t)
        else:
            ssm_state, conv_state = cache["ssm"], cache["conv"]
            segments, slot_ids = cache["segments"], cache["slot_ids"]
        y = ssd_packed_scan(zxbcdt.reshape(b * t, -1), p["conv_w"],
                            p["conv_b"], conv_state, ssm_state, p["A_log"],
                            p["dt_bias"], p["D"], segments, slot_ids,
                            d_inner=di, state=n, head_dim=hp, groups=g,
                            chunk=cfg.ssm_chunk)
    y = _gated_norm(p, y.reshape(b, t, di), zxbcdt[..., :di], cfg)
    return y @ p["out_proj"]
