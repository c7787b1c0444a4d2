"""Plain reference of the benchmark's hybrid: a model whose layers mix with
Mamba-2 or with HCCS attention, as `layer_types` says, and follow every
mixer with a SwiGLU MLP, in float32 with TF32 off.

This file imports nothing of the program under test, of the harness or of
JAX; it shares the decoder reference's attention, norm and MLP (decoder.py
beside it). It takes the weights the benchmark made (the program's
parameter layout: (in, out) matrices; the norms and MLPs stacked over every
layer, `attn` over the attention layers, `ssm` over the Mamba-2 ones; HCCS
constants for the attention layers) and a configuration dict built from the
benchmark's configuration file, and recomputes one request's forward over
its whole sequence with no cache, no packing and no kernels.

The layer, as the configuration file states it (granitemoehybrid with no
experts):

    h = rmsnorm(x) * g1                              eps 1e-6, float32
    mamba:
      z, xBC, dt = split(h W_in; di, di + 2n, nh)    no projection bias
      xBC = silu(bias + sum_k w[:, k] * xBC_{t-K+1+k})   depthwise, causal,
                                                     zeros before token 0
      x, B, C = split(xBC; di, n, n)                 x: nh heads of hp; B, C
                                                     one group for all heads
      dt = softplus(dt + dt_bias);  a = -exp(A_log) * dt
      y_t = sum_{s <= t} (C_t . B_s) exp(cum_t - cum_s) dt_s x_s + D x_t
                                                     cum_t = a_1 + ... + a_t
      out = (rmsnorm(y * silu(z)) * g) W_out         one norm over all di
    attention: decoder.py's HCCS attention with no rotation (NoPE)
    x = x + out
    x = x + (silu(h2 Wg) * (h2 Wi)) Wo2,  h2 = rmsnorm(x) * g2
    logits = rmsnorm(x) * gf @ E^T over the published vocabulary

y is the SSD in its quadratic masked ("dual") form over the whole
sequence, from zero state, taken in blocks of heads so that the (heads, T,
T) decays fit: it shares no code or order of sums with the program's
chunked or recurrent scans. `cast` is the precision control's hook, as in
decoder.py: every product of an activation with a weight (the
projections, the MLP, the head) passes its operands through it; the conv
and the SSD stay float32.

Not modelled (the configuration file's `not_modelled`): Granite's
embedding, attention, residual and logits multipliers (run as 1, 1/8, 1,
1) and rms_norm_eps (run as 1e-6).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import decoder as base

full_float32 = base.full_float32
HEAD_BLOCK = 8          # heads whose (T, T) decays are held at once


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_dual(x, dt, a, B, C, D, head_block=HEAD_BLOCK):
    """The SSD of one sequence from zero state, in the dual form. x (T, nh,
    hp), dt and a (T, nh), B and C (T, g, n), D (nh,). Returns (T, nh,
    hp)."""
    t, nh = dt.shape
    g = B.shape[1]
    rep = nh // g
    gram = torch.einsum("tgn,sgn->gts", C, B)              # C_t . B_s
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=x.device))
    cum = torch.cumsum(a, 0).t()                           # (nh, T)
    y = torch.empty_like(x)
    for h0 in range(0, nh, head_block):
        h1 = min(h0 + head_block, nh)
        seg = cum[h0:h1, :, None] - cum[h0:h1, None, :]    # cum_t - cum_s
        decay = torch.exp(seg.masked_fill(~causal, float("-inf")))
        w = decay * gram[torch.arange(h0, h1, device=x.device) // rep] \
            * dt[:, h0:h1].t()[:, None, :]
        y[:, h0:h1] = torch.einsum("hts,shp->thp", w, x[:, h0:h1])
    return y + D[None, :, None] * x


def causal_conv(u, w, b):
    """Depthwise causal conv of u (T, C) with taps w (C, K), oldest first,
    and bias b (C,); zeros before the first token."""
    k = w.shape[1]
    up = F.pad(u, (0, 0, k - 1, 0))
    out = b[None, :].expand_as(u).clone()
    for j in range(k):
        out = out + w[:, j] * up[j:j + u.shape[0]]
    return out


def mamba(p, h, cfg, cast=None):
    """The Mamba-2 mixer on one sequence's normed input h (T, D); p holds
    the layer's weights in float32."""
    t = h.shape[0]
    di, n, g = cfg["d_inner"], cfg["ssm_state"], cfg["ssm_groups"]
    nh, hp = cfg["ssm_heads"], cfg["ssm_head_dim"]
    zxbcdt = base._mm(h, p["in_proj"], cast)
    z, xbc, dt = torch.split(zxbcdt, [di, di + 2 * g * n, nh], dim=-1)
    xbc = F.silu(causal_conv(xbc, p["conv_w"], p["conv_b"]))
    x, B, C = torch.split(xbc, [di, g * n, g * n], dim=-1)
    dt = softplus(dt + p["dt_bias"])
    a = -torch.exp(p["A_log"]) * dt
    y = ssd_dual(x.reshape(t, nh, hp), dt, a, B.reshape(t, g, n),
                 C.reshape(t, g, n), p["D"]).reshape(t, di)
    return base._mm(base.rmsnorm(y * F.silu(z), p["norm"]), p["out_proj"],
                    cast)


def attention(p, hc, h, cfg, cast=None):
    """The HCCS GQA attention mixer on h (T, D), with no rotation."""
    t = h.shape[0]
    hh, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = base._mm(h, p["wq"], cast).reshape(t, hh, hd).transpose(0, 1)
    k = base._mm(h, p["wk"], cast).reshape(t, hkv, hd).transpose(0, 1)
    v = base._mm(h, p["wv"], cast).reshape(t, hkv, hd).transpose(0, 1)
    theta = torch.stack([hc["B"], hc["S"], hc["D"]], -1)
    o = base.hccs_attention(q, k, v, theta, hc["scale"], cfg["hccs_mode"])
    return base._mm(o.transpose(0, 1).reshape(t, hh * hd), p["wo"], cast)


def layer(lp, mixer, hc, x, cfg, cast=None):
    """One layer on one sequence's hidden states x (T, D) float32: lp the
    norms and MLP, `mixer` the mixer's weights, both in float32; hc the
    attention layer's HCCS constants (None for Mamba-2)."""
    h = base.rmsnorm(x, lp["norm1"]["scale"])
    if hc is None:
        x = x + mamba(mixer, h, cfg, cast)
    else:
        x = x + attention(mixer, hc, h, cfg, cast)
    return x + base.mlp(lp["mlp"], base.rmsnorm(x, lp["norm2"]["scale"]),
                        cast)


def logits_at(weights, hccs, seqs, rows, cfg, cast=None):
    """Reference logits of several sequences, layer by layer over all of
    them: seqs a list of (T_i,) int64 token tensors, rows a list of (R_i,)
    positions whose logits are wanted. Returns a list of (R_i, vocab)
    float32 tensors over the published vocabulary."""
    table = weights["embed"]["table"]
    xs = [table[s.long()].float() for s in seqs]
    stacks = weights["layers"]
    seen = {"mamba": 0, "attention": 0}
    for i, kind in enumerate(cfg["layer_types"]):
        j = seen[kind]
        seen[kind] += 1
        lp = base._slice({k: stacks[k] for k in ("norm1", "norm2", "mlp")},
                         i)
        if kind == "mamba":
            mixer, hc = base._slice(stacks["ssm"], j), None
        else:
            mixer = base._slice(stacks["attn"], j)
            hc = {k: v[j] for k, v in hccs.items()}
        xs = [layer(lp, mixer, hc, x, cfg, cast) for x in xs]
    out = []
    emb = table[:cfg["vocab_size"]].float().t()
    for x, r in zip(xs, rows):
        h = base.rmsnorm(x[r.long()], weights["final_norm"]["scale"])
        out.append(base._mm(h, emb, cast))
    return out
