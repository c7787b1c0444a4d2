"""Plain reference of the benchmark's decoders: a dense and an MoE
transformer whose attention probability is HCCS, in float32 with TF32 off.

This file imports nothing of the program under test. It takes the weights
the benchmark made (the program's parameter layout: (in, out) matrices,
layers stacked on a leading axis) and a configuration dict built from the
benchmark's own configuration file, and recomputes one request's forward
over its whole sequence with no cache, no packing and no kernels.

The block, as the configuration files state it:

    h  = rmsnorm(x) * g1                         eps 1e-6, in float32
    q, k, v = h Wq, h Wk, h Wv                   GQA: query head j reads
                                                 kv head j // (H / Hkv)
    q, k = rope(q), rope(k)                      half-split rotation, theta
    logit[j, t, u] = (q_t . k_u) / sqrt(hd)      keys u <= t
    qi = clip(round_half_even(logit / scale[j]), -128, 127)
    m  = max_u qi;  s = B[j] - S[j] * min(m - qi, D[j])
    Z  = max(sum_u s, 1);  p = s * inv(Z)        inv: the HCCS mode's
                                                 Stage-5 reciprocal
    x  = x + (p V) Wo
    h2 = rmsnorm(x) * g2
    dense:  x = x + (silu(h2 Wg) * (h2 Wi)) Wo2
    moe:    router probs = softmax(h2 Wr), top-k (lower expert first on
            ties), gates renormalized to sum 1, no token dropped;
            x = x + sum_k gate_k * expert_k(h2)
    logits = rmsnorm(x) * gf @ E^T over the published vocabulary

`cast` is the hook the precision control uses: every matrix product's
activation passes through `cast.act` and its weight through `cast.weight`
(None: both unchanged). The router stays float32 in either case.
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

T_I16 = 32767
NORM_EPS = 1e-6


@contextlib.contextmanager
def full_float32():
    """float32 matrix products at full precision (no TF32) for the
    duration, restored after."""
    mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = mm
        torch.backends.cudnn.allow_tf32 = cudnn
        torch.set_float32_matmul_precision(prec)


def rmsnorm(x, g):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + NORM_EPS) \
        * g.float()


def rope(x, pos, theta):
    """x (H, T, d), pos (T,) -> the half-split rotation, in float32."""
    half = x.shape[-1] // 2
    freq = 1.0 / torch.pow(torch.tensor(float(theta), device=x.device),
                           torch.arange(half, device=x.device,
                                        dtype=torch.float32) / half)
    ang = pos.float()[:, None] * freq
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def hccs_inverse(z, mode):
    """The Stage-5 reciprocal of each HCCS mode on float Z >= 1: the exact
    one in `wide`, the integer truncations of the i16 modes applied to the
    accumulated numerator (HCCS is linear in its active window)."""
    if mode == "wide":
        return 1.0 / z
    if mode == "i16_div":
        return torch.floor(T_I16 / z) / T_I16
    if mode == "i16_clb":
        return torch.floor(T_I16 * torch.exp2(-torch.floor(torch.log2(z)))) \
            / T_I16
    raise ValueError(f"no reference for HCCS mode {mode!r}")


def hccs_attention(q, k, v, theta, scale, mode, q_block=512):
    """Causal HCCS attention of one sequence. q (H, T, d), k/v (Hkv, T, d),
    theta (H, 3) int (B, S, D), scale (H,) float. Query rows are taken in
    blocks of `q_block` so the logits fit. Returns (H, T, d) float32."""
    h, t, d = q.shape
    g = h // k.shape[0]
    kh = k.repeat_interleave(g, 0)
    vh = v.repeat_interleave(g, 0)
    B = theta[:, 0].float()[:, None, None]
    S = theta[:, 1].float()[:, None, None]
    D = theta[:, 2].float()[:, None, None]
    denom = torch.sqrt(torch.tensor(float(d), device=q.device))
    out = torch.empty_like(q)
    keys = torch.arange(t, device=q.device)
    for a in range(0, t, q_block):
        b = min(a + q_block, t)
        logits = torch.einsum("hqd,hkd->hqk", q[:, a:b], kh[:, :b]) / denom
        qi = torch.clamp(torch.round(logits / scale.float()[:, None, None]),
                         -128, 127)
        live = (keys[None, :b] <= torch.arange(a, b, device=q.device)[:, None]
                )[None]
        qi = torch.where(live, qi, torch.full_like(qi, -1e9))
        m = qi.max(-1, keepdim=True).values
        s = torch.where(live, B - S * torch.minimum(m - qi, D),
                        torch.zeros_like(qi))
        z = torch.clamp(s.sum(-1, keepdim=True), min=1.0)
        out[:, a:b] = torch.einsum("hqk,hkd->hqd", s, vh[:, :b]) \
            * hccs_inverse(z, mode)
    return out


def _mm(a, w, cast):
    if cast is None:
        return a @ w
    return cast.act(a) @ cast.weight(w)


def mlp(p, h, cast):
    return _mm(F.silu(_mm(h, p["w_gate"], cast)) * _mm(h, p["w_in"], cast),
               p["w_out"], cast)


def moe(p, h, cfg, cast):
    """Top-k routing with no capacity limit: every token reaches all k of
    its experts."""
    probs = torch.softmax(h @ p["router"].float(), dim=-1)     # (T, E)
    k = cfg["experts_per_token"]
    gate, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = gate[:, :k], idx[:, :k]
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    out = torch.zeros_like(h)
    ex = p["experts"]
    for e in range(cfg["num_experts"]):
        tok, choice = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        y = mlp({name: w[e] for name, w in ex.items()}, h[tok], cast)
        out.index_add_(0, tok, y * gate[tok, choice][:, None])
    return out


def layer(lp, hc, x, pos, cfg, cast=None):
    """One block on one sequence's hidden states x (T, D) float32; lp holds
    the layer's weights in float32."""
    t = x.shape[0]
    hh, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    h = rmsnorm(x, lp["norm1"]["scale"])
    a = lp["attn"]
    q = _mm(h, a["wq"], cast).reshape(t, hh, hd).transpose(0, 1)
    k = _mm(h, a["wk"], cast).reshape(t, hkv, hd).transpose(0, 1)
    v = _mm(h, a["wv"], cast).reshape(t, hkv, hd).transpose(0, 1)
    q, k = rope(q, pos, cfg["rope_theta"]), rope(k, pos, cfg["rope_theta"])
    theta = torch.stack([hc["B"], hc["S"], hc["D"]], -1)
    o = hccs_attention(q, k, v, theta, hc["scale"], cfg["hccs_mode"])
    x = x + _mm(o.transpose(0, 1).reshape(t, hh * hd), a["wo"], cast)
    h2 = rmsnorm(x, lp["norm2"]["scale"])
    if "moe" in lp:
        return x + moe(lp["moe"], h2, cfg, cast)
    return x + mlp(lp["mlp"], h2, cast)


def _slice(tree, i):
    """Layer i of a stacked tree, in float32."""
    return {k: (_slice(v, i) if isinstance(v, dict) else v[i].float())
            for k, v in tree.items()}


def logits_at(weights, hccs, seqs, rows, cfg, cast=None):
    """Reference logits of several sequences, layer by layer over all of
    them: seqs a list of (T_i,) int64 token tensors, rows a list of (R_i,)
    positions whose logits are wanted. Returns a list of (R_i, vocab)
    float32 tensors over the published vocabulary."""
    table = weights["embed"]["table"]
    xs = [table[s.long()].float() for s in seqs]
    pos = [torch.arange(s.shape[0], device=s.device) for s in seqs]
    for i in range(cfg["num_layers"]):
        lp = _slice(weights["layers"], i)
        hc = {k: v[i] for k, v in hccs.items()}
        xs = [layer(lp, hc, x, p, cfg, cast) for x, p in zip(xs, pos)]
    out = []
    emb = table[:cfg["vocab_size"]].float().t()
    for x, r in zip(xs, rows):
        h = rmsnorm(x[r.long()], weights["final_norm"]["scale"])
        out.append(_mm(h, emb, cast))
    return out
