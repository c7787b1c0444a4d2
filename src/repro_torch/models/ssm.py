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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def init_ssm(gen, cfg, dtype, device, layers: int):
    """(L, ...) stacked SSD params, drawn like the JAX init: in_proj emits
    x_inner (di), the z gate (di), B and C (g*n each) and dt (nh)."""
    d, di, nh = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    g, n = cfg.ssm_groups, cfg.ssm_state
    proj_out = 2 * di + 2 * g * n + nh

    def full(shape, v, dt):
        return torch.full((layers,) + shape, v, dtype=dt, device=device)
    return {
        "in_proj": torch.randn((layers, d, proj_out), generator=gen,
                               dtype=dtype, device=device) * d ** -0.5,
        "out_proj": torch.randn((layers, di, d), generator=gen, dtype=dtype,
                                device=device) * di ** -0.5,
        "A_log": full((nh,), 0.0, torch.float32),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "D": full((nh,), 1.0, torch.float32),
        "norm": full((di,), 1.0, dtype),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softplus: logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _split_proj(p, x, cfg):
    di, g, n, nh = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    zxbcdt = x @ p["in_proj"]
    z, xi, Bm, Cm, dt = torch.split(zxbcdt, [di, di, g * n, g * n, nh],
                                    dim=-1)
    return z, xi, Bm, Cm, dt


def _gated_norm(p, y, z, cfg, eps=1e-6):
    yf = (y * F.silu(z.float())).float()
    ms = yf.square().mean(-1, keepdim=True)
    return (yf * torch.rsqrt(ms + eps) * p["norm"].float()).to(y.dtype)


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
    rep = nh // g
    dt = softplus(dt.float() + p["dt_bias"])  # (b,t,nh)
    a = -torch.exp(p["A_log"]) * dt  # <= 0

    nc = -(-t // L)
    pad = nc * L - t
    xp = F.pad(xh, (0, 0, 0, 0, 0, pad))
    Bp = F.pad(Bh, (0, 0, 0, 0, 0, pad))
    Cp = F.pad(Ch, (0, 0, 0, 0, 0, pad))
    dtp = F.pad(dt, (0, 0, 0, pad))
    ap = F.pad(a, (0, 0, 0, pad))

    xc = xp.reshape(b, nc, L, nh, hp)
    Bc = Bp.reshape(b, nc, L, g, n)
    Cc = Cp.reshape(b, nc, L, g, n)
    dtc = dtp.reshape(b, nc, L, nh)
    ac = ap.reshape(b, nc, L, nh)

    cum = torch.cumsum(ac, dim=2)  # (b,nc,L,nh)
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,Lq,Lk,nh)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=x.device))
    decay = torch.where(causal[None, None, :, :, None], torch.exp(seg),
                        torch.zeros((), device=x.device))

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
    h = (torch.zeros((b, nh, n, hp), device=x.device) if state is None
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

    y = (y_intra + y_inter).reshape(b, nc * L, nh, hp)[:, :t]
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(b, t, cfg.d_inner).to(x.dtype)
    y = _gated_norm(p, y, z, cfg)
    return y @ p["out_proj"], h


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
    return y @ p["out_proj"], new_state
