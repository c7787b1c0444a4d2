"""The twin of tests/test_attention_modes.py: attention-path equivalences in
the port (blockwise == dense per HCCS mode, the sliding window and its
blockwise form, M-RoPE, the decode row against the full row, degenerate
kernel rows), each also held to the JAX package on the same weights
(`init_attention` in JAX, carried across as numpy); the hot-buffer decode
against the classic one and against JAX's hot-buffer model and wave engine.

Tolerances: the reference's own gates within the port (3e-5 blockwise
against dense, 1e-5 for the window and RoPE identities); against JAX's
outputs, max |d| 7.2e-7 measured on these shapes (f32 projections a few
ulp apart), gate 1e-5 (CROSS_ATOL). The kernel's degenerate rows are
integers: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JaxModelConfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro_torch.configs.base import ModelConfig
from repro_torch.core.constraints import default_params
from repro_torch.models.attention import apply_attention
from repro_torch.models.layers import apply_mrope, apply_rope

CROSS_ATOL = 1e-5


def _cfgs(**kw):
    d = dict(name="t", family="dense", num_layers=1, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=64, vocab_size=64, vocab_pad_multiple=1)
    d.update(kw)
    return ModelConfig(**d), JaxModelConfig(**d)


RNG = np.random.default_rng(0)
X = RNG.normal(0, 1, (2, 40, 64)).astype(np.float32)


def _params(jcfg, seed=0):
    jp = JA.init_attention(jax.random.PRNGKey(seed), jcfg)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _hccs(cfg, n):
    B, S, D = default_params(n)
    h = cfg.num_heads
    return {"B": np.full((h,), B, np.int32), "S": np.full((h,), S, np.int32),
            "D": np.full((h,), D, np.int32),
            "scale": np.full((h,), 0.07, np.float32)}


def _run(cfg, jcfg, hccs=None, x=X):
    """The port's output and JAX's on the same weights and input."""
    jp, p = _params(jcfg)
    th = None if hccs is None else {k: torch.from_numpy(v)
                                     for k, v in hccs.items()}
    jh = None if hccs is None else jax.tree.map(jnp.asarray, hccs)
    with torch.no_grad():
        out, _ = apply_attention(p, torch.from_numpy(x), cfg, hccs=th)
    jout, _ = JA.apply_attention(jp, jnp.asarray(x), jcfg, hccs=jh)
    return out.numpy(), np.asarray(jout)


@pytest.mark.parametrize("prob,mode", [("softmax", "wide"), ("hccs", "wide"),
                                       ("hccs", "i16_div")])
def test_blockwise_matches_dense(prob, mode):
    cfg_d, jcfg_d = _cfgs(attention_prob=prob, hccs_mode=mode,
                          attention_impl="dense")
    cfg_b = cfg_d.replace(attention_impl="blockwise", block_k=16)
    jcfg_b = jcfg_d.replace(attention_impl="blockwise", block_k=16)
    hccs = _hccs(cfg_d, 40) if prob == "hccs" else None
    dense, jdense = _run(cfg_d, jcfg_d, hccs)
    block, jblock = _run(cfg_b, jcfg_b, hccs)
    np.testing.assert_allclose(dense, block, atol=3e-5)
    np.testing.assert_allclose(dense, jdense, atol=CROSS_ATOL)
    np.testing.assert_allclose(block, jblock, atol=CROSS_ATOL)


def test_sliding_window_masks_old_keys():
    """With window=w, key j contributes to query i iff i-w < j <= i."""
    cfg, jcfg = _cfgs(attention_prob="softmax", window=8,
                      attention_impl="dense")
    x = RNG.normal(0, 1, (1, 30, 64)).astype(np.float32)
    out_w, jout_w = _run(cfg, jcfg, x=x)
    # perturbing a key OUTSIDE every window of the last query must not
    # change the last query's output
    x2 = x.copy()
    x2[0, 2] += 5.0
    out_w2, _ = _run(cfg, jcfg, x=x2)
    np.testing.assert_allclose(out_w[0, -1], out_w2[0, -1], atol=1e-5)
    # ...but it does change the early outputs
    assert np.abs(out_w[0, 3] - out_w2[0, 3]).max() > 1e-4
    np.testing.assert_allclose(out_w, jout_w, atol=CROSS_ATOL)


def test_window_blockwise_matches_dense():
    cfg_d, jcfg_d = _cfgs(attention_prob="hccs", window=8,
                          attention_impl="dense")
    hccs = _hccs(cfg_d, 40)
    dense, jdense = _run(cfg_d, jcfg_d, hccs)
    block, jblock = _run(cfg_d.replace(attention_impl="blockwise", block_k=8),
                         jcfg_d.replace(attention_impl="blockwise",
                                        block_k=8), hccs)
    np.testing.assert_allclose(dense, block, atol=3e-5)
    np.testing.assert_allclose(block, jblock, atol=CROSS_ATOL)


def test_mrope_sections_differ_from_rope():
    """With distinct t/h/w position streams, M-RoPE != plain RoPE; with
    identical streams it reduces to plain RoPE. Both equal JAX's, and an
    M-RoPE attention layer equals JAX's on its position streams."""
    x = RNG.normal(0, 1, (1, 2, 12, 32)).astype(np.float32)
    pos = np.arange(12)[None]
    same3 = np.broadcast_to(pos[None], (3, 1, 12))
    sections = (6, 5, 5)
    xt = torch.from_numpy(x)
    a = apply_mrope(xt, torch.from_numpy(same3.copy()), 1e4, sections)
    b = apply_rope(xt, torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    mixed = np.stack([pos, pos * 3 % 12, pos * 7 % 12])
    c = apply_mrope(xt, torch.from_numpy(mixed), 1e4, sections)
    assert np.abs(c.numpy() - b.numpy()).max() > 1e-3
    jc = JL.apply_mrope(jnp.asarray(x), jnp.asarray(mixed), 1e4, sections)
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=CROSS_ATOL)

    cfg, jcfg = _cfgs(attention_prob="softmax", rope="mrope",
                      mrope_sections=(2, 3, 3))
    jp, p = _params(jcfg)
    p3 = np.stack([np.tile(np.arange(40), (2, 1)),
                   np.tile(np.arange(40) * 3 % 40, (2, 1)),
                   np.tile(np.arange(40) * 7 % 40, (2, 1))]).astype(np.int32)
    with torch.no_grad():
        out, _ = apply_attention(p, torch.from_numpy(X), cfg,
                                 mrope_positions=torch.from_numpy(p3))
        plain, _ = apply_attention(p, torch.from_numpy(X), cfg)
    jout, _ = JA.apply_attention(jp, jnp.asarray(X), jcfg,
                                 mrope_positions=jnp.asarray(p3))
    jplain, _ = JA.apply_attention(jp, jnp.asarray(X), jcfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=CROSS_ATOL)
    np.testing.assert_allclose(plain.numpy(), np.asarray(jplain),
                               atol=CROSS_ATOL)
    assert np.abs(out.numpy() - plain.numpy()).max() > 1e-3


def test_decode_row_equals_full_row():
    """One cached decode step reproduces the last row of full attention."""
    cfg, jcfg = _cfgs(attention_prob="hccs", attention_impl="dense")
    hccs = {k: torch.from_numpy(v) for k, v in _hccs(cfg, 40).items()}
    jp, p = _params(jcfg, seed=1)
    x = torch.from_numpy(X)
    T = X.shape[1]
    with torch.no_grad():
        full, _ = apply_attention(p, x, cfg, hccs=hccs)
        cache = {"k": torch.zeros((2, 2, T, 16)),
                 "v": torch.zeros((2, 2, T, 16)),
                 "length": torch.tensor(0, dtype=torch.int32)}
        _, cache = apply_attention(p, x[:, :T - 1], cfg, hccs=hccs,
                                   cache=cache)
        cache["length"] = torch.tensor(T - 1, dtype=torch.int32)
        last, _ = apply_attention(p, x[:, T - 1:], cfg, hccs=hccs,
                                  cache=cache)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               atol=3e-5)
    jfull, _ = JA.apply_attention(jp, jnp.asarray(X), jcfg,
                                  hccs=jax.tree.map(jnp.asarray,
                                                    _hccs(cfg, 40)))
    np.testing.assert_allclose(full.numpy(), np.asarray(jfull),
                               atol=CROSS_ATOL)


def test_hccs_kernel_degenerate_rows():
    """All-equal and all-minimum rows stay valid probability rows, equal to
    the JAX kernel's."""
    from repro.kernels import hccs_softmax as jax_hccs_softmax
    from repro_torch.kernels import hccs_softmax
    from repro_torch.kernels import ref as REF
    n = 64
    B, S, D = default_params(n)
    theta = np.tile(np.asarray([[B, S, D]], np.int32), (3, 1))
    rows = np.stack([np.full(n, -128), np.full(n, 127),
                     np.concatenate([[127], np.full(n - 1, -128)])]
                    ).astype(np.int8)
    got = hccs_softmax(torch.from_numpy(rows),
                       torch.from_numpy(theta), "i16_div").numpy()
    want = REF.hccs_rows_ref(torch.from_numpy(rows), torch.from_numpy(theta),
                             "i16_div").numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.asarray(jax_hccs_softmax(
        jnp.asarray(rows), jnp.asarray(theta), "i16_div")))
    assert (got >= 0).all() and (got.sum(-1) <= 32767).all()
    # focused row: the max position dominates
    assert got[2, 0] > got[2, 1]


# ------------------------------------------------------------ hot buffers --

HOT_TOKENS = RNG.integers(0, 64, (2, 12)).astype(np.int32)


def _hot_models(prob):
    """A 1-layer model's JAX params and the same weights in the port, with
    the classic and the hot-buffer (8 rows) configs of both packages."""
    from repro.models import model as JM
    from repro_torch.models import model as M
    cfg0, jcfg0 = _cfgs(attention_prob=prob)
    jp = JM.init_params(jax.random.PRNGKey(0), jcfg0)
    p = M.params_from_jax(jax.tree.map(np.asarray, jp), cfg0, device="cpu")
    return (jp, jcfg0, jcfg0.replace(hot_buffer=8)), (
        p, cfg0, cfg0.replace(hot_buffer=8))


def _decode_logits(M, p, cfg, steps, tokens, cache_dtype):
    """Prefill logits and `steps` greedy decode steps' logits, fed the
    tokens the caller gives (argmax of its own reference run)."""
    w, h = p["weights"], p["hccs"]
    lg, c = M.prefill(w, h, {"tokens": tokens[0]}, cfg, max_len=24,
                      cache_dtype=cache_dtype)
    out = [np.asarray(lg)]
    for nxt in tokens[1:steps + 1]:
        lg, c = M.decode_step(w, h, nxt, c, cfg)
        out.append(np.asarray(lg))
    return out, c


@pytest.mark.parametrize("prob", ["hccs", "softmax"])
def test_hot_buffer_decode_matches_classic(prob):
    """The twin of the reference's test: the port's hot-buffer decode
    (append to the hot buffer, main and hot segments merged against a
    shared max) reproduces its classic single-cache decode, with the
    reference's gates (2e-5 on the prefill, 5e-4 on 4 decode steps;
    measured 0 and 1.4e-6); the cache holds the prompt_len and the
    decoded rows in the hot buffer."""
    from repro_torch.models import model as M
    _, (p, cfg0, cfg1) = _hot_models(prob)
    toks = [torch.from_numpy(HOT_TOKENS)]
    lg0, c0 = M.prefill(p["weights"], p["hccs"], {"tokens": toks[0]}, cfg0,
                        max_len=24, cache_dtype="float32")
    for _ in range(4):
        toks.append(torch.argmax(lg0, -1)[:, None].to(torch.int32))
        lg0, c0 = M.decode_step(p["weights"], p["hccs"], toks[-1], c0, cfg0)
    ref, _ = _decode_logits(M, p, cfg0, 4, toks, "float32")
    hot, c1 = _decode_logits(M, p, cfg1, 4, toks, "float32")
    np.testing.assert_allclose(hot[0], ref[0], atol=2e-5)
    for a, b in zip(hot[1:], ref[1:]):
        np.testing.assert_allclose(a, b, atol=5e-4)
    assert int(c1["prompt_len"]) == 12 and int(c1["length"]) == 16
    assert c1["layers"]["hot_k"].shape == (1, 2, 2, 8, 16)
    assert c1["layers"]["hot_k"][:, :, :, :4].abs().sum() > 0
    assert c1["layers"]["hot_k"][:, :, :, 4:].abs().sum() == 0


@pytest.mark.parametrize("plen", [12, 6])
@pytest.mark.parametrize("prob", ["hccs", "softmax"])
def test_hot_buffer_logits_match_jax(prob, plen):
    """The port's hot-buffer prefill and 4 decode steps against JAX's
    hot-buffer model on the same weights (numpy bridge) and the same fed
    tokens: gate CROSS_ATOL (1e-5) on every step's logits (measured
    1.4e-6 at most). A prompt of 8 tokens or fewer takes JAX's hot branch
    in the prefill too, and its first decode step overwrites the prompt's
    hot rows (ROADMAP.md C3); the port reproduces that at 6 tokens."""
    from repro.models import model as JM
    from repro_torch.models import model as M
    (jp, _, jcfg1), (p, _, cfg1) = _hot_models(prob)
    prompt = HOT_TOKENS[:, :plen]
    jlg, jc = JM.prefill(jp["weights"], jp["hccs"],
                         {"tokens": jnp.asarray(prompt)}, jcfg1,
                         max_len=24, cache_dtype=jnp.float32)
    jout, toks = [np.asarray(jlg)], [torch.from_numpy(prompt)]
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jlg, -1))[:, None].astype(np.int32)
        toks.append(torch.from_numpy(nxt))
        jlg, jc = JM.decode_step(jp["weights"], jp["hccs"], jnp.asarray(nxt),
                                 jc, jcfg1)
        jout.append(np.asarray(jlg))
    out, c = _decode_logits(M, p, cfg1, 4, toks, "float32")
    for a, b in zip(out, jout):
        np.testing.assert_allclose(a, b, atol=CROSS_ATOL)
    np.testing.assert_allclose(c["layers"]["hot_k"].numpy(),
                               np.asarray(jc["layers"]["hot_k"]),
                               atol=CROSS_ATOL)


def test_hot_buffer_wave_engine_matches_jax():
    """The wave engine with hot_buffer on serves the JAX wave engine's
    greedy tokens (two waves, 7 new tokens a request, 8 hot rows), and
    counts the hot buffers in its KV bytes as JAX does."""
    from repro.models import model as JM
    from repro.serve import engine as JE
    from repro_torch.models import model as M
    from repro_torch.serve import engine as PE
    cfg, jcfg = _cfgs(attention_prob="hccs", num_layers=2, hot_buffer=8)
    jp = JM.init_params(jax.random.PRNGKey(1), jcfg)
    p = M.params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    prompts = [RNG.integers(0, 64, n).astype(np.int32)
               for n in (10, 10, 10, 13)]
    outs = []
    for eng, Req in ((JE.ServeEngine(jp, jcfg, max_batch=4, max_len=32,
                                     cache_dtype=jnp.float32), JE.Request),
                     (PE.ServeEngine(p, cfg, max_batch=4, max_len=32,
                                     cache_dtype="float32", device="cpu"),
                      PE.Request)):
        for i, pr in enumerate(prompts):
            eng.submit(Req(uid=i, prompt=pr, max_new_tokens=7))
        done = sorted(eng.run(), key=lambda r: r.uid)
        outs.append([r.out_tokens for r in done])
    assert outs[0] == outs[1]
    assert all(len(o) == 7 for o in outs[1])
    jcache = JM.init_cache(jcfg, 4, 32, cache_dtype=jnp.float32)
    pcache = M.init_cache(cfg, 4, 32, cache_dtype="float32", device="meta")
    assert PE.kv_cache_bytes(pcache) == JE.kv_cache_bytes(jcache)
