"""Top-k Mixture-of-Experts with capacity dropping — the port of
`repro/models/moe.py`.

Tokens route in dispatch groups (`_num_groups`); inside a group each
(token, choice) entry takes its rank in its expert's queue from a stable
sort of the expert ids (FIFO: earlier tokens keep their place, later ones
past the capacity `int(M * k / e * cf)` drop). Dispatch and combine are
gathers: expert slot (e, c) pulls its token from the sorted entries, and
every kept entry reads its expert's output back, weighted by its gate in
x's dtype and summed over the k choices. The Switch-style load-balance
aux loss is returned beside the output.

Ties follow the JAX package: `jax.lax.top_k` puts the lower expert index
first among equal probabilities (the rule here is a stable descending
sort), which matters under `cfg.hccs_router`, where the router's
probabilities are HCCS on int8-quantized logits and tie often. The
sharding annotations (`constrain`) stand where the JAX module's do; they
return their argument outside `use_rules` or on a plain tensor.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.constraints import default_params
from repro_torch.core.hccs import HCCSParams, hccs_qat
from repro_torch.parallel.sharding import constrain
from repro_torch.spans import span


def init_moe(gen, cfg, dtype, device, layers: int):
    """(L, ...) stacked router (f32, (d, e)) and experts (cfg.dtype), drawn
    like the JAX init (normal, std d**-0.5; w_out f**-0.5); with
    cfg.hccs_router the router's HCCS (B, S, D) at the constraint-feasible
    default for e lanes and an int8 logit scale of 0.1, one per layer."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts

    def rand(shape, dt, std):
        return torch.randn((layers,) + shape, generator=gen, dtype=dt,
                           device=device) * std
    p = {"router": rand((d, e), torch.float32, d ** -0.5),
         "experts": {"w_in": rand((e, d, f), dtype, d ** -0.5),
                     "w_gate": rand((e, d, f), dtype, d ** -0.5),
                     "w_out": rand((e, f, d), dtype, f ** -0.5)}}
    if cfg.hccs_router:
        B, S, D = default_params(e)
        full = (lambda v, dt: torch.full((layers,), v, dtype=dt,
                                         device=device))
        p["hccs"] = {"B": full(B, torch.int32), "S": full(S, torch.int32),
                     "D": full(D, torch.int32),
                     "scale": full(0.1, torch.float32)}
    return p


def _router_probs(p, logits, cfg):
    if cfg.hccs_router and "hccs" in p:
        hp = p["hccs"]
        params = HCCSParams(B=hp["B"], S=hp["S"], D=hp["D"])
        return hccs_qat(logits, hp["scale"], params, mode=cfg.hccs_mode)
    return torch.softmax(logits, dim=-1)


def _num_groups(cfg, n_tok: int) -> int:
    """Dispatch groups: each routes its tokens independently (per-group
    capacity and FIFO dropping). Auto: halve the group size while it stays
    at least 4096 tokens, up to 64 groups."""
    if cfg.moe_groups:
        return min(cfg.moe_groups, n_tok)
    g = 1
    while g < 64 and n_tok % (g * 2) == 0 and n_tok // (g * 2) >= 4096:
        g *= 2
    return g


def top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries on the last axis, the
    lower index first among equal values (jax.lax.top_k's order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def route(p, x, cfg):
    """The routing half of apply_moe on x (B, T, D): a dict of the group
    layout and, per group, the router probabilities (G, M, E), the top-k
    expert ids and renormalized gates (G, M, K), the FIFO queue ranks,
    keep mask and slots of the M*K entries (G, M*K), the sort order, and
    the per-expert counts and queue starts (G, E); plus the aux loss."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    n_tok = b * t
    G = _num_groups(cfg, n_tok)
    M = n_tok // G
    cap = max(int(M * k / e * cfg.moe_capacity_factor), 1)
    xg = constrain(x.reshape(G, M, d), "moe_group", None, "moe_embed")
    logits = xg.float() @ p["router"]                             # (G, M, E)
    probs = _router_probs(p, logits, cfg)
    gate, idx = top_k(probs, k)                                   # (G, M, K)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)

    # load-balance aux loss (Switch-style), over all tokens
    density = F.one_hot(idx[..., 0], e).float().mean(dim=(0, 1))
    prob_mean = probs.mean(dim=(0, 1))
    aux = e * torch.sum(density * prob_mean)

    # rank of every (token, choice) entry inside its expert queue, from a
    # group-local stable sort (FIFO dropping)
    mk = M * k
    flat = idx.reshape(G, mk)                                     # (G, M*K)
    order = torch.argsort(flat, dim=1, stable=True)
    sorted_e = torch.gather(flat, 1, order)
    counts = torch.zeros_like(probs[:, 0], dtype=torch.int64)      # (G, E)
    counts.scatter_add_(1, flat, torch.ones_like(flat))
    starts = torch.cumsum(counts, dim=1) - counts                 # (G, E)
    ar = torch.arange(mk, device=x.device)
    pos_sorted = ar[None] - torch.gather(starts, 1, sorted_e)
    inv_order = torch.empty_like(order).scatter_(
        1, order, ar[None].expand(G, mk).contiguous())
    pos = torch.gather(pos_sorted, 1, inv_order)                  # (G, M*K)
    return dict(G=G, M=M, cap=cap, xg=xg, probs=probs, idx=idx, gate=gate,
                flat=flat, order=order, counts=counts, starts=starts,
                pos=pos, keep=pos < cap,
                slot=torch.clamp(pos, max=cap - 1), aux=aux)


def apply_moe(p, x, cfg):
    """x: (B, T, D) -> (out, aux_loss). Grouped capacity-dropped top-k
    routing; the experts' products are torch.einsum."""
    b, t, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    with span("repro.moe.route"):
        r = route(p, x, cfg)
    G, M, cap, xg = r["G"], r["M"], r["cap"], r["xg"]
    mk = M * k

    # dispatch: slot (e, c) pulls sorted entry starts[e] + c, i.e. token
    # order[.] // K — one gather from xg
    c_idx = torch.arange(cap, device=x.device)
    src_j = r["starts"][..., None] + c_idx[None, None]            # (G, E, cap)
    slot_valid = c_idx[None, None] < r["counts"][..., None]
    src_j = torch.clamp(src_j, max=mk - 1).reshape(G, e * cap)
    tok = torch.gather(r["order"], 1, src_j) // k                 # (G, E*cap)
    buf = torch.gather(xg, 1, tok[..., None].expand(G, e * cap, d))
    buf = torch.where(slot_valid.reshape(G, e * cap, 1), buf,
                      torch.zeros((), dtype=buf.dtype, device=x.device))
    buf = constrain(buf.reshape(G, e, cap, d), "moe_group", "expert", None,
                    None)

    w = p["experts"]
    h = torch.einsum("gecd,edf->gecf", buf, w["w_in"])
    gt = torch.einsum("gecd,edf->gecf", buf, w["w_gate"])
    h = constrain(F.silu(gt) * h, "moe_group", "expert", None, None)
    y = constrain(torch.einsum("gecf,efd->gecd", h, w["w_out"]),
                  "moe_group", "expert", None, None)

    # combine: entry (m, kk) reads its expert slot back — one gather
    slot_flat = r["flat"] * cap + r["slot"]                       # (G, M*K)
    y_flat = constrain(y.reshape(G, e * cap, d), "moe_group", None,
                       "moe_embed")
    out_flat = torch.gather(y_flat, 1,
                            slot_flat[..., None].expand(G, mk, d))
    out_flat = torch.where(r["keep"][..., None], out_flat,
                           torch.zeros((), dtype=out_flat.dtype,
                                       device=x.device))
    out = (out_flat.reshape(G, M, k, d) *
           r["gate"][..., None].to(x.dtype)).sum(dim=2)
    return constrain(out.reshape(b, t, d), "batch", "seq_act",
                     "embed"), r["aux"]
