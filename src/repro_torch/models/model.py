"""The LM: embedding -> a loop over the stacked blocks -> norm -> logits.
The port of `repro/models/model.py`.

Params layout (the JAX package's, as plain dicts of tensors):
    {"weights": {"embed": {"table"}, "layers": <stacked (L, ...) block
     dicts>, "final_norm": {...}, "lm_head"?: (D, V_pad)},
     "hccs": {"B", "S", "D", "scale": (L, H)}}

The JAX model scans the stacked layers with lax.scan; here a Python loop
hands layer i its slice of every (L, ...) leaf, views into the stacked
tensors. Learned position embeddings, classification heads and
embedding inputs are not ported yet (ROADMAP.md items A3, A10).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models.attention import init_hccs_head_params
from repro_torch.models.layers import apply_norm, embed_tokens, lm_logits

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
# per-step keys the paged engine attaches to the cache; forward hands them
# to every layer (one table, per-layer pools)
PAGED_EXTRAS = ("block_table", "write_pos", "kv_len", "slot_ids")
# the JAX package's other per-step keys steer paths not ported yet
_UNPORTED_EXTRAS = ("q_pos_grid", "grid_pos", "kv_len_slot", "fresh_blocks",
                    "stage_rows", "draft_rows")


def _check_supported(cfg):
    blocks.check_family(cfg)
    if cfg.rope == "learned" or cfg.num_classes or \
            cfg.input_mode != "tokens":
        raise NotImplementedError(
            "learned position embeddings, classification heads and "
            "embedding inputs are not ported yet: ROADMAP.md items A3, A10")


def _init(cfg, gen, device, hccs_n_ref: int):
    _check_supported(cfg)
    dt = DTYPES[cfg.dtype]
    L, d = cfg.num_layers, cfg.d_model
    weights = {
        "embed": {"table": torch.randn((cfg.padded_vocab, d), generator=gen,
                                       dtype=dt, device=device) * d ** -0.5},
        "layers": blocks.init_block(gen, cfg, dt, device, L),
        "final_norm": blocks.init_norm(cfg, dt, device),
    }
    if not cfg.tie_embeddings:
        weights["lm_head"] = torch.randn(
            (d, cfg.padded_vocab), generator=gen, dtype=dt,
            device=device) * d ** -0.5
    hccs = {}
    if cfg.attention_prob == "hccs" and cfg.num_heads > 0:
        one = init_hccs_head_params(cfg, device, n_ref=hccs_n_ref)
        hccs = {k: v[None].expand(L, -1).contiguous() for k, v in one.items()}
    return {"weights": weights, "hccs": hccs}


def init_params(cfg, seed: int = 0, device=None, hccs_n_ref: int = 128):
    """Random weights from `seed` with an explicit torch.Generator on the
    target device: the JAX init's distributions and scales, not its numbers
    (parity tests carry the JAX weights across with params_from_jax).
    The device defaults to CUDA and raises when there is no card."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return _init(cfg, gen, device, hccs_n_ref)


def param_shapes(cfg, hccs_n_ref: int = 128) -> dict:
    """The params tree as allocation-free meta tensors (shapes + dtypes)."""
    return _init(cfg, None, torch.device("meta"), hccs_n_ref)


def flatten_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, key + "."))
        else:
            out[key] = v
    return out


def unflatten_tree(flat):
    tree: dict = {}
    for key, v in flat.items():
        *path, leaf = key.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v
    return tree


def params_from_jax(np_params, cfg, device=None):
    """The JAX params tree, as numpy arrays (`jax.tree.map(np.asarray,
    repro.models.model.init_params(...))`), as the port's params on
    `device` (CUDA by default). Every leaf of the JAX tree must be consumed
    and every shape and dtype must match, or this raises. The (in, out)
    orientation of the weight matrices is kept as it is."""
    device = resolve_device(device)
    want = flatten_tree(param_shapes(cfg))
    got = flatten_tree(np_params)
    missing, extra = sorted(want.keys() - got.keys()), sorted(
        got.keys() - want.keys())
    if missing or extra:
        raise ValueError(f"params tree mismatch: missing {missing}, "
                         f"unconsumed {extra}")
    out = {}
    for key, meta in want.items():
        a = np.asarray(got[key])
        if tuple(a.shape) != tuple(meta.shape):
            raise ValueError(f"{key}: shape {a.shape} != {tuple(meta.shape)}")
        if str(a.dtype) != str(meta.dtype).removeprefix("torch."):
            raise ValueError(f"{key}: dtype {a.dtype} != {meta.dtype}")
        if a.dtype.name == "bfloat16":       # numpy has no bf16: via f32
            t = torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.tensor(a)              # copies: JAX's are read-only
        out[key] = t.to(device)
    return unflatten_tree(out)


def params_to(params, device):
    """A copy of a params tree on another device."""
    return unflatten_tree({k: v.to(device)
                           for k, v in flatten_tree(params).items()})


def _layer(tree, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def forward(weights, hccs, batch, cfg, cache):
    """batch: {"tokens": (1, T), "positions": (1, T)} — a packed token
    batch with each token's absolute position.

    cache: the paged model cache {"layers": {"k", "v": (L, N, Hkv, bs,
    hd)}} plus the step's PAGED_EXTRAS; layer i's K/V are written into
    pools k[i]/v[i] in place. Returns (hidden, cache, aux) like the JAX
    forward (aux is 0: no MoE)."""
    _check_supported(cfg)
    unported = [k for k in _UNPORTED_EXTRAS if k in cache]
    if unported:
        raise NotImplementedError(
            f"cache keys {unported} steer paths not ported yet (per-slot STE "
            f"grid, int8 KV, speculative verify): ROADMAP.md items A4, A6")
    x = embed_tokens(weights["embed"], batch["tokens"], cfg)
    extras = {k: cache[k] for k in PAGED_EXTRAS if k in cache}
    for i in range(cfg.num_layers):
        lc = {"k": cache["layers"]["k"][i], "v": cache["layers"]["v"][i],
              **extras}
        x, _ = blocks.apply_block(_layer(weights["layers"], i), x, cfg,
                                  {k: v[i] for k, v in hccs.items()} or None,
                                  lc, batch["positions"])
    x = apply_norm(weights["final_norm"], x, cfg)
    return x, {"layers": cache["layers"]}, torch.zeros((), device=x.device)


def logits_from_hidden(weights, x, cfg):
    return lm_logits(weights["embed"], weights, x, cfg)
