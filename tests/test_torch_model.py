"""The port's model against the JAX model on the same weights.

Weights are made by `repro.models.model.init_params` and carried across by
`params_from_jax`; one packed paged step (prefill chunks, decode lanes, pad
lanes, a random KV history in a shuffled pool) runs through both forwards,
the JAX one with its Pallas kernel in interpret mode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import model as JM
from repro.serve.paged import init_paged_cache as jax_init_paged_cache
from repro.serve.paged import pack_slot_ids, packed_write_positions
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M

# Tolerances. Measured on these three configs (torch 2.13 CPU against jax
# 0.9 CPU, f32): max |d| 2.6e-6 on the hidden state, 2.9e-6 on the logits
# and 1.9e-6 on the written K/V rows (the projections of one token drift by
# a few ulp between the frameworks' matmuls), with identical top-1 tokens.
# The gates sit 5-7x above the measurement, inside the 7.6e-6 to 3.1e-5
# cross-framework matmul drift ROADMAP.md records.
HIDDEN_ATOL = 2e-5
LOGIT_ATOL = 2e-5
POOL_ATOL = 1e-5


def _jax_params(cfg):
    return jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0),
                                                   cfg))


def _port_cfg(jax_cfg):
    return ModelConfig(**dataclasses.asdict(jax_cfg))


def test_params_from_jax_consumes_every_leaf(tiny_cfg):
    cfg = tiny_cfg(decode_kernel="fused", tie_embeddings=False)
    np_params = _jax_params(cfg)
    pcfg = _port_cfg(cfg)
    port = M.params_from_jax(np_params, pcfg, device="cpu")
    flat_j = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(np_params)[0]}
    flat_p = M.flatten_tree(port)
    assert len(flat_j) == len(flat_p)
    for key, val in flat_p.items():
        jkey = "".join(f"['{part}']" for part in key.split("."))
        np.testing.assert_array_equal(val.numpy(), flat_j[jkey])
    # a missing leaf, an unconsumed leaf and a wrong shape all raise
    bad = jax.tree.map(lambda a: a, np_params)
    del bad["weights"]["lm_head"]
    with pytest.raises(ValueError, match="missing"):
        M.params_from_jax(bad, pcfg, device="cpu")
    bad = jax.tree.map(lambda a: a, np_params)
    bad["weights"]["extra"] = np.zeros(3)
    with pytest.raises(ValueError, match="unconsumed"):
        M.params_from_jax(bad, pcfg, device="cpu")
    bad = jax.tree.map(lambda a: a, np_params)
    bad["hccs"]["B"] = bad["hccs"]["B"][:, :1]
    with pytest.raises(ValueError, match="shape"):
        M.params_from_jax(bad, pcfg, device="cpu")


def _step_inputs(cfg, rng, bs, max_batch=3, max_len=64, width=32):
    """One packed step: slot 0 decodes at position 20, slot 1 prefills a
    9-token chunk at 5..13, slot 2 a fresh 12-token chunk; 10 pad lanes."""
    nblk = max_len // bs
    n_blocks = 16
    start = np.array([20, 5, 0])
    t_valid = np.array([1, 9, 12], np.int32)
    table = np.full((max_batch, nblk), -1, np.int32)
    ids = iter(rng.permutation(np.arange(1, n_blocks)))
    for s in range(max_batch):
        for j in range(-(-int(start[s] + t_valid[s]) // bs)):
            table[s, j] = next(ids)
    sid, off = pack_slot_ids(t_valid, width)
    pos = np.zeros(width, np.int32)
    for s in range(max_batch):
        pos[off[s]:off[s] + t_valid[s]] = start[s] + np.arange(t_valid[s])
    toks = np.where(sid >= 0, rng.integers(0, cfg.vocab_size, width), 0)
    wp = packed_write_positions(t_valid, off, table, start, bs, width)
    kv_len = np.where(sid >= 0, pos + 1, 0).astype(np.int32)
    hist = rng.normal(0, 1, (2, cfg.num_layers, n_blocks, cfg.num_kv_heads,
                             bs, cfg.head_dim)).astype(np.float32)
    extras = dict(length=start.astype(np.int32), block_table=table,
                  write_pos=wp[None], kv_len=kv_len, slot_ids=sid)
    return (toks.astype(np.int32), pos, extras, hist, n_blocks, sid)


@pytest.mark.parametrize("which", ["tiny-wide", "tiny-i16_clb-static",
                                   "granite-reduced"])
def test_packed_step_matches_jax_forward(which, tiny_cfg):
    if which == "tiny-wide":
        cfg = tiny_cfg(decode_kernel="fused", cache_layout="paged")
    elif which == "tiny-i16_clb-static":
        cfg = tiny_cfg(decode_kernel="static_max", hccs_mode="i16_clb",
                       cache_layout="paged")
    else:
        cfg = jax_reduced_config("granite-3-2b").replace(
            decode_kernel="fused", cache_layout="paged")
    bs = 16
    rng = np.random.default_rng(7)
    toks, pos, extras, hist, n_blocks, sid = _step_inputs(cfg, rng, bs)
    np_params = _jax_params(cfg)

    # JAX: its lane-padded pool (the TPU layout), history in the true lanes
    jc = jax_init_paged_cache(cfg, n_blocks, bs, 3)
    hd = cfg.head_dim
    jc["layers"] = {name: jc["layers"][name].at[..., :hd].set(hist[i])
                    for i, name in enumerate(("k", "v"))}
    jx, jcache, _ = JM.forward(
        np_params["weights"], np_params["hccs"],
        {"tokens": jnp.asarray(toks[None]),
         "positions": jnp.asarray(pos[None])}, cfg,
        cache=dict(jc, **{k: jnp.asarray(v) for k, v in extras.items()}),
        decode=True)
    jlogits = JM.logits_from_hidden(np_params["weights"], jx, cfg)

    pcfg = _port_cfg(cfg)
    params = M.params_from_jax(np_params, pcfg, device="cpu")
    pcache = {"layers": {"k": torch.from_numpy(hist[0].copy()),
                         "v": torch.from_numpy(hist[1].copy())}}
    pcache.update({k: torch.from_numpy(np.ascontiguousarray(v))
                   for k, v in extras.items()})
    px, pnew, _ = M.forward(params["weights"], params["hccs"],
                            {"tokens": torch.from_numpy(toks[None]),
                             "positions": torch.from_numpy(pos[None])},
                            pcfg, pcache)
    plogits = M.logits_from_hidden(params["weights"], px, pcfg)

    d_hidden = np.abs(px.numpy() - np.asarray(jx)).max()
    d_logits = np.abs(plogits.numpy() - np.asarray(jlogits)).max()
    live = sid >= 0
    top1 = (plogits.numpy()[0, live].argmax(-1)
            == np.asarray(jlogits)[0, live].argmax(-1))
    print(f"{which}: max |d| hidden {d_hidden:.2e} logits {d_logits:.2e}")
    assert d_hidden <= HIDDEN_ATOL
    assert d_logits <= LOGIT_ATOL
    assert top1.all()
    for name in ("k", "v"):
        want = np.asarray(jcache["layers"][name])[..., :hd]
        got = pnew["layers"][name].numpy()
        print(f"{which}: max |d| {name} pool {np.abs(got - want).max():.2e}")
        assert np.abs(got - want).max() <= POOL_ATOL
        # the step wrote every live lane's K/V at its write target
        wp = extras["write_pos"][0][live]
        before = hist[0 if name == "k" else 1][:, wp // bs, :, wp % bs]
        assert (np.abs(got[:, wp // bs, :, wp % bs] - before)
                .max(axis=(0, 2, 3)) > 0).all()
