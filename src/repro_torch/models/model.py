"""The LM: embedding -> a loop over the stacked blocks -> norm -> logits.
The port of `repro/models/model.py`.

Params layout (the JAX package's, as plain dicts of tensors):
    {"weights": {"embed": {"table"}, "pos_embed"?: (P, D), "layers":
     <stacked (L, ...) block dicts>, "final_norm": {...}, "lm_head"?:
     (D, V_pad), "cls_head"?: (D, C)},
     "hccs": {"B", "S", "D", "scale": (L, H)} | {}}

The JAX model scans the stacked layers with lax.scan; here a Python loop
hands layer i its slice of every (L, ...) leaf, views into the stacked
tensors, and sums the layers' aux losses (the MoE load balance). Without a
cache (training) each block runs under torch.utils.checkpoint when
cfg.remat is "dots" or "full" and autograd is on: the JAX scan's remat
unit, recomputed whole (memory changes, numbers do not). `hccs` is
detached, as the JAX forward stops its gradient: theta and the logit
scales stay frozen during QAT. Inputs are token ids or, for the
embedding-input families (audio, VLM), precomputed embeddings; learned
position embeddings (`rope="learned"`, the encoders) are added to them,
and M-RoPE models take (3, B, T) position streams.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import blocks
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.attention import init_hccs_head_params
from repro_torch.models.layers import (DTYPES, apply_norm, embed_tokens,
                                      lm_logits)
from repro_torch.parallel.sharding import constrain
from repro_torch.spans import span

# per-step keys the paged engine attaches to the cache; forward hands them
# to every layer (one table, per-layer pools): the packed step's slot ids,
# its per-slot STE grid steering, the int8 pool's fresh blocks, and a
# speculative verify step's draft rows and row staging
PAGED_EXTRAS = ("block_table", "write_pos", "kv_len", "slot_ids",
                "q_pos_grid", "grid_pos", "kv_len_slot", "fresh_blocks",
                "stage_rows", "draft_rows")


def _init(cfg, gen, device, hccs_n_ref: int):
    dt = DTYPES[cfg.dtype]
    L, d = cfg.num_layers, cfg.d_model
    weights = {
        "embed": {"table": torch.randn((cfg.padded_vocab, d), generator=gen,
                                       dtype=dt, device=device) * d ** -0.5},
        "layers": blocks.init_block(gen, cfg, dt, device, L),
        "final_norm": blocks.init_norm(cfg, dt, device),
    }
    if cfg.rope == "learned":
        weights["pos_embed"] = torch.randn(
            (cfg.max_position, d), generator=gen, dtype=dt,
            device=device) * 0.02
    if not cfg.tie_embeddings:
        weights["lm_head"] = torch.randn(
            (d, cfg.padded_vocab), generator=gen, dtype=dt,
            device=device) * d ** -0.5
    if cfg.num_classes:
        weights["cls_head"] = torch.randn(
            (d, cfg.num_classes), generator=gen, dtype=dt,
            device=device) * d ** -0.5
    hccs = {}
    if cfg.attention_prob == "hccs" and cfg.num_heads > 0:
        one = init_hccs_head_params(cfg, device, n_ref=hccs_n_ref)
        la = (cfg.layers_of("attention") if cfg.family == "interleaved"
              else L)
        hccs = {k: v[None].expand(la, -1).contiguous()
                for k, v in one.items()}
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
    return {"hccs": {}, **unflatten_tree(out)}   # a softmax model's is empty


def params_to(params, device):
    """A copy of a params tree on another device."""
    return {"hccs": {}, **unflatten_tree(
        {k: v.to(device) for k, v in flatten_tree(params).items()})}


def _layer(tree, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


# the params and the per-layer cache leaves each mixer of the interleaved
# family reads
MIXER_PARAMS = {"mamba": "ssm", "attention": "attn"}
MIXER_CACHE = {"mamba": ("ssm", "conv"),
               "attention": ("k", "v", "k_scale", "v_scale")}


def _layer_parts(layers, hccs, cache_layers, cfg, i):
    """Layer i's (params, HCCS constants or None, cache leaves or None).
    Every family but the interleaved one stacks every leaf over every
    layer (a "block" layer). An interleaved model stacks the norms and the
    MLP over every layer, and the mixer's params, HCCS constants
    (attention layers only) and cache leaves over its own kind's layers
    (cfg.layer_plan)."""
    kind, j = (cfg.layer_plan[i] if cfg.family == "interleaved"
               else ("block", i))
    mixer = MIXER_PARAMS.get(kind)
    p = {k: _layer(v, j if k == mixer else i) for k, v in layers.items()
         if mixer is None or k not in MIXER_PARAMS.values() or k == mixer}
    hc = ({k: v[j] for k, v in hccs.items()} or None
          if kind != "mamba" else None)
    lc = (None if cache_layers is None else
          {k: v[j] for k, v in cache_layers.items()
           if mixer is None or k in MIXER_CACHE[kind]})
    return p, hc, lc


def _block_caller(cfg):
    """apply_block without a cache, under torch.utils.checkpoint when
    cfg.remat asks for it and autograd is recording. Returns (x, aux)."""
    def call(lp, x, hc, positions, mrope_positions):
        x, _, aux = blocks.apply_block(lp, x, cfg, hc, None, None,
                                       positions, mrope_positions)
        return x, aux

    if cfg.remat in ("dots", "full") and torch.is_grad_enabled():
        return lambda *a: checkpoint(call, *a, use_reentrant=False)
    return call


def _embed(weights, batch, cfg):
    if cfg.input_mode == "embeddings" and "embeddings" in batch:
        return batch["embeddings"].to(DTYPES[cfg.dtype])
    return embed_tokens(weights["embed"], batch["tokens"], cfg)


def forward(weights, hccs, batch, cfg, cache=None, decode: bool = False):
    """batch: {"tokens": (B, T)} or {"embeddings": (B, T, D)} (the
    embedding-input families), with optional "positions" (B, T) and
    "mrope_positions" (3, B, T).

    cache None: the training / calibration forward (positions default to
    arange(T); nothing is written; returns (hidden, None, aux)). Otherwise
    cache: the model cache {"layers": {"k", "v": (L, ...), "ssm"?}, "length"}
    — a slot arena (L, B, Hkv, Tmax, hd) with a scalar or (B,) `length`
    (the SSM and hybrid families add the (L, B, nh, N, P) f32 SSD state), or
    the paged pools (L, N, Hkv, bs, hd) (int8 pools with "k_scale"/"v_scale"
    (L, N, Hkv) beside them) plus the step's PAGED_EXTRAS (the lockstep step
    adds a (B,) `length`; the packed step passes explicit positions and no
    length). Default positions are length + arange(T). Layer i's K/V (and
    scales, and SSD state) are written into its slices in place. `decode`
    runs the SSD's one-token recurrent step (decode_step sets it). An
    interleaved model (configs/granite_4_0_h_micro.py) takes only the packed
    paged step, whose cache adds each Mamba-2 layer's per-slot `ssm`
    (Lm, S, nh, N, P) f32 and `conv` (Lm, S, K-1, C) state beside the
    attention layers' pools (serve/paged.py init_paged_cache). Returns
    (hidden, cache, aux) like the JAX forward, aux the sum of the layers'
    MoE load-balance losses (0 without MoE); the returned cache's length is
    advanced by T. With `stage_rows` in the cache, the returned layers also
    hold every layer's raw new rows as f32 `staged_k` / `staged_v`
    (L, B, Hkv, T, hd), in a new dict beside the pools."""
    x = _embed(weights, batch, cfg)
    b, t = x.shape[:2]
    length = cache.get("length") if cache is not None else None
    positions = batch.get("positions")
    if positions is None:
        # length is a scalar (lockstep) or a (B,) per-slot vector
        base = (length if length is not None else
                torch.zeros((), dtype=torch.int32, device=x.device))
        positions = (torch.atleast_1d(base)[:, None]
                     + torch.arange(t, device=x.device)[None, :]
                     ).expand(b, t)
    if cfg.rope == "learned":
        x = x + weights["pos_embed"][positions.long()]
    mrope_positions = batch.get("mrope_positions")
    x = constrain(x, "batch", "seq_act", "embed")
    hccs = {k: v.detach() for k, v in hccs.items()}   # theta frozen (QAT)
    aux = 0.0                   # a tensor once a MoE block adds its loss
    if cache is None:
        call = _block_caller(cfg)
        for i in range(cfg.num_layers):
            lp, hc, _ = _layer_parts(weights["layers"], hccs, None, cfg, i)
            x, aux_l = call(lp, x, hc, positions, mrope_positions)
            aux = aux + aux_l
        x = apply_norm(weights["final_norm"], x, cfg)
        return x, None, _aux_tensor(aux, x.device)
    extras = {k: cache[k] for k in PAGED_EXTRAS if k in cache}
    if cfg.hot_buffer > 0:
        # hot-buffer decode: tokens past prompt_len live in the hot buffer;
        # every layer needs the split point
        extras["hot_len"] = length - cache.get(
            "prompt_len", torch.zeros((), dtype=torch.int32,
                                      device=x.device))
    if cfg.family == "interleaved":
        if "slot_ids" not in extras:
            raise ValueError("an interleaved model's cache is the packed "
                             "paged step's: its Mamba-2 state is per slot")
        # each slot's segment of the step, once for every Mamba-2 layer
        extras["segments"] = ssm_mod.packed_segments(
            extras["slot_ids"], positions[0],
            cache["layers"]["ssm"].shape[1])
    staged = {"staged_k": [], "staged_v": []}
    for i in range(cfg.num_layers):
        lp, hc, lc = _layer_parts(weights["layers"], hccs, cache["layers"],
                                  cfg, i)
        lc.update(extras)
        with span("repro.layer"):
            x, lnew, aux_l = blocks.apply_block(
                lp, x, cfg, hc, lc, length, positions, mrope_positions,
                decode=decode)
        aux = aux + aux_l
        if "ssm" in lnew:
            cache["layers"]["ssm"][i].copy_(lnew["ssm"])
        if "stage_rows" in cache:
            for name, rows in staged.items():
                rows.append(lnew[name])
    x = apply_norm(weights["final_norm"], x, cfg)
    new_cache = {"layers": cache["layers"]}
    if "stage_rows" in cache:
        new_cache["layers"] = dict(cache["layers"], **{
            name: torch.stack(rows) for name, rows in staged.items()})
    if length is not None:
        new_cache["length"] = length + t
    if "prompt_len" in cache:
        new_cache["prompt_len"] = cache["prompt_len"]
    return x, new_cache, _aux_tensor(aux, x.device)


def _aux_tensor(aux, device):
    if isinstance(aux, torch.Tensor):
        return aux
    return torch.zeros((), dtype=torch.float32, device=device)


def logits_from_hidden(weights, x, cfg):
    return lm_logits(weights["embed"], weights, x, cfg)


def lm_loss(weights, hccs, batch, cfg):
    """Next-token cross-entropy. batch needs "labels" (B, T) with -100 =
    pad. The gold logit is gathered (the JAX package's one-hot einsum has
    exactly one nonzero term, so the value is the same, and no (B, T, V)
    one-hot is made)."""
    x, _, aux = forward(weights, hccs, batch, cfg)
    logits = logits_from_hidden(weights, x, cfg)
    labels = batch["labels"].long()
    mask = labels >= 0
    labels_c = torch.clamp(labels, min=0)
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, labels_c[..., None])[..., 0].float()
    nll = (logz - gold) * mask
    loss = nll.sum() / torch.clamp(mask.sum(), min=1)
    return loss, {"lm_loss": loss, "aux_loss": aux}


def cls_loss(weights, hccs, batch, cfg):
    """Sequence classification via first-token pooling (BERT-style).
    batch needs "cls_labels" (B,)."""
    x, _, aux = forward(weights, hccs, batch, cfg)
    pooled = x[:, 0]
    logits = (pooled @ weights["cls_head"]).float()
    labels = batch["cls_labels"].long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    loss = torch.mean(logz - gold)
    acc = torch.mean((torch.argmax(logits, -1) == labels).float())
    return loss, {"cls_loss": loss, "acc": acc, "aux_loss": aux}


def init_cache(cfg, batch_size: int, max_len: int, cache_dtype=None,
               per_slot_lengths: bool = False, device=None):
    """Zero slot-arena cache {"layers": {"k", "v": (L, B, Hkv, len_c, hd),
    "ssm"?: (L, B, nh, N, P) f32}, "length"} (K/V for the attention
    families, the SSD state for ssm and hybrid). per_slot_lengths=True
    makes `length` a (batch,) vector (the continuous engine's per-slot
    frontiers). With cfg.hot_buffer > 0 the layers also hold the hot
    buffers and the cache a scalar `prompt_len` (0 until prefill sets it);
    hot buffers track one prompt length, so per-slot lengths raise
    ValueError. cache_dtype=None resolves to cfg.cache_dtype. The device
    defaults to CUDA and raises without a card."""
    if cfg.hot_buffer > 0 and per_slot_lengths:
        raise ValueError("hot buffers are lockstep-only: they track a "
                         "single scalar prompt_len, incompatible with "
                         "per-slot lengths")
    device = resolve_device(device)
    one = blocks.init_layer_cache(cfg, batch_size, max_len, cache_dtype,
                                  device)
    layers = {k: torch.zeros((cfg.num_layers,) + tuple(v.shape),
                             dtype=v.dtype, device=device)
              for k, v in one.items()}
    shape = (batch_size,) if per_slot_lengths else ()
    c = {"layers": layers,
         "length": torch.zeros(shape, dtype=torch.int32, device=device)}
    if cfg.hot_buffer > 0:
        c["prompt_len"] = torch.zeros((), dtype=torch.int32, device=device)
    return c


def prefill(weights, hccs, batch, cfg, max_len: int, cache_dtype=None,
            cache=None):
    """Run the prompt (batch["tokens"] (B, T), or "embeddings" (B, T, D))
    through the model into a fresh cache on the inputs' device (or into
    `cache`, a zero cache of init_cache's layout the caller made, as the
    dry-run's DTensors are). Returns (last-token logits (B, V), cache)."""
    inp = batch["tokens"] if "tokens" in batch else batch["embeddings"]
    b, t = inp.shape[:2]
    if cache is None:
        cache = init_cache(cfg, b, max_len, cache_dtype, device=inp.device)
    x, cache, _ = forward(weights, hccs, batch, cfg, cache)
    if cfg.hot_buffer > 0:
        cache = dict(cache, prompt_len=cache["length"])
    logits = logits_from_hidden(weights, x[:, -1:], cfg)
    return logits[:, 0], cache


def decode_step(weights, hccs, tokens, cache, cfg, embeddings=None):
    """One-token decode. tokens: (B, 1) (or embeddings (B, 1, D)). The SSD
    takes its recurrent step. Returns (logits (B, V), new_cache)."""
    batch = ({"embeddings": embeddings} if embeddings is not None
             else {"tokens": tokens})
    x, cache, _ = forward(weights, hccs, batch, cfg, cache, decode=True)
    logits = logits_from_hidden(weights, x, cfg)
    return logits[:, 0], cache
