"""The port's STE attention (`repro_torch.models.attention`) against the JAX
package's, on the same weights and inputs.

(a) `_dense_attention` and `_blockwise_attention` against their JAX twins
    in the five HCCS modes and the softmax baseline, with causal masks and
    per-slot key lengths (one slot's frontier cuts a block in half).
(b) Every cache branch of `apply_attention` the engines run — the slot
    arena's whole-cache overwrite, its offset write (scalar length) and its
    per-slot frontier write, the lockstep paged chunk and decode steps —
    with the kernels off and on: the attention output and the written K/V.
(c) Identities the JAX package asserts within itself, held within the port:
    blockwise equals dense (tests/test_attention_modes.py:43, :68) and one
    cached decode step equals the last row of full attention (:90).

Tolerances. Measured (torch 2.13 CPU against jax 0.9 CPU, f32): (a) max |d|
2.7e-7 dense and 2.4e-7 blockwise; (b) max |d| 7.2e-7 on the outputs and
1.2e-6 on the written K/V (the projections drift by a few ulp). No int8
bin flipped in any case here, so every difference is summation order. The
gates sit 4-8x above the measurement. (c) uses the reference's own 3e-5.
"""
import dataclasses
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JConfig
from repro.core.constraints import default_params
from repro.models import attention as JA
from repro_torch.configs.base import ModelConfig as PConfig
from repro_torch.models import attention as PA

KERNEL_ATOL = 2e-6       # (a), outputs of O(1)
BRANCH_ATOL = 5e-6       # (b), attention outputs after the projection
KV_ATOL = 5e-6           # (b), written K/V
REF_ATOL = 3e-5          # (c), the reference's own gate


def _cfg(**kw):
    d = dict(name="t", family="dense", num_layers=1, d_model=64,
             num_heads=4, num_kv_heads=2, d_ff=64, vocab_size=64,
             vocab_pad_multiple=1)
    d.update(kw)
    return JConfig(**d)


def _port(cfg):
    return PConfig(**dataclasses.asdict(cfg))


def _hccs(h, scale=0.07, n=40):
    B, S, D = default_params(n)
    j = {"B": jnp.full((h,), B, jnp.int32), "S": jnp.full((h,), S, jnp.int32),
         "D": jnp.full((h,), D, jnp.int32),
         "scale": jnp.full((h,), scale, jnp.float32)}
    return j, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in j.items()}


def _weights(cfg, seed=0):
    p = JA.init_attention(jax.random.PRNGKey(seed), cfg)
    return p, {k: torch.from_numpy(np.asarray(v).copy()) for k, v in p.items()}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------- (a) --

PROBS = [("softmax", "wide"), ("hccs", "wide"), ("hccs", "i16_div"),
         ("hccs", "i16_clb"), ("hccs", "i8_div"), ("hccs", "i8_clb")]


@pytest.mark.parametrize("prob,mode", PROBS)
def test_dense_and_blockwise_match_jax(prob, mode):
    cfg = _cfg(attention_prob=prob, hccs_mode=mode, block_k=8)
    pcfg = _port(cfg)
    rng = np.random.default_rng(zlib.crc32(f"{prob}{mode}".encode()))
    b, h, hkv, tq, tk, hd = 2, 4, 2, 5, 37, 16
    q = rng.normal(0, 1, (b, h, tq, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, hkv, tk, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, hkv, tk, hd)).astype(np.float32)
    q_pos = np.stack([np.arange(20, 25), np.arange(8, 13)]).astype(np.int32)
    k_len = np.asarray([25, 13], np.int32)       # slot 1 cuts block 1
    jh, ph = _hccs(h) if prob == "hccs" else (None, None)
    jvalid = JA._block_valid(cfg, jnp.asarray(q_pos), jnp.arange(tk),
                             jnp.asarray(k_len))
    pvalid = PA._block_valid(pcfg, _t(q_pos), torch.arange(tk), _t(k_len))
    np.testing.assert_array_equal(pvalid.numpy(), np.asarray(jvalid))
    want = JA._dense_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jvalid, cfg, jh)
    got = PA._dense_attention(_t(q), _t(k), _t(v), pvalid, pcfg, ph)
    d_dense = np.abs(got.numpy() - np.asarray(want)).max()
    want = JA._blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(q_pos),
                                   jnp.asarray(k_len), cfg, jh)
    got = PA._blockwise_attention(_t(q), _t(k), _t(v), _t(q_pos), _t(k_len),
                                  pcfg, ph)
    d_block = np.abs(got.numpy() - np.asarray(want)).max()
    print(f"{prob} {mode}: max |d| dense {d_dense:.2e} "
          f"blockwise {d_block:.2e}")
    assert d_dense <= KERNEL_ATOL and d_block <= KERNEL_ATOL


def test_slot_scatter_clamps_like_dynamic_update_slice():
    rng = np.random.default_rng(1)
    cache = rng.normal(size=(3, 2, 10, 4)).astype(np.float32)
    new = rng.normal(size=(3, 2, 3, 4)).astype(np.float32)
    lengths = np.asarray([0, 5, 9], np.int32)         # 9 + 3 > 10: clamped
    want = JA._slot_scatter(jnp.asarray(cache), jnp.asarray(new),
                            jnp.asarray(lengths))
    got = PA._slot_scatter(_t(cache.copy()), _t(new), _t(lengths))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------------- (b) --

def _branch_case(branch, cfg, rng):
    """x, positions (None = from the cache length) and the cache of one
    apply_attention call, as numpy."""
    b, hkv, hd, tmax, bs, nblk = 2, 2, 16, 37, 8, 5
    hist = (lambda *s: rng.normal(0, 1, s).astype(np.float32))
    if branch in ("overwrite", "prefill", "wave-decode", "cont-decode"):
        t = {"overwrite": tmax, "prefill": 12}.get(branch, 1)
        zero = branch in ("overwrite", "prefill")
        kv = (np.zeros((2, b, hkv, tmax, hd), np.float32) if zero
              else hist(2, b, hkv, tmax, hd))
        length = (np.int32(0) if zero else np.int32(20)
                  if branch == "wave-decode" else np.asarray([36, 5],
                                                             np.int32))
        cache = dict(k=kv[0], v=kv[1], length=length)
    else:
        t = bs if branch == "lock-chunk" else 1
        n = 12
        pools = hist(2, n, hkv, bs, hd)
        table = np.full((b, nblk), -1, np.int32)
        table[0, :4] = [3, 7, 1, 10]
        table[1, :2] = [5, 2]
        lengths = np.asarray([20, 3], np.int32)
        t_valid = np.asarray([t, 1 if t == 1 else 5], np.int32)
        wp = np.tile(np.arange(t, dtype=np.int64), (b, 1))
        for s in range(b):
            gpos = lengths[s] + np.arange(t_valid[s])
            wp[s, :t_valid[s]] = table[s, gpos // bs] * bs + gpos % bs
        cache = dict(k=pools[0], v=pools[1], length=lengths,
                     block_table=table, write_pos=wp.astype(np.int32),
                     kv_len=lengths + t_valid)
    x = rng.normal(0, 1, (b, t, cfg.d_model)).astype(np.float32)
    return x, cache


BRANCHES = ["overwrite", "prefill", "wave-decode", "cont-decode",
            "lock-chunk", "lock-decode"]


@pytest.mark.parametrize("kernel", ["none", "fused"])
@pytest.mark.parametrize("branch", BRANCHES)
def test_cache_branches_match_jax(branch, kernel):
    """With the kernel on, the t > 1 branches also take the blockwise path
    (threshold 16, 8-key blocks)."""
    kw = dict(decode_kernel=kernel, hccs_mode="i16_div")
    if kernel == "fused":
        kw.update(blockwise_threshold=16, block_k=8)
    cfg = _cfg(**kw)
    pcfg = _port(cfg)
    rng = np.random.default_rng(BRANCHES.index(branch))
    x, cache = _branch_case(branch, cfg, rng)
    jw, pw = _weights(cfg)
    jh, ph = _hccs(cfg.num_heads)
    jout, jcache = jax.jit(JA.apply_attention, static_argnums=2)(
        jw, jnp.asarray(x), cfg, hccs=jh,
        cache={k: jnp.asarray(v) for k, v in cache.items()})
    pcache = {k: _t(v.copy() if isinstance(v, np.ndarray) else v)
              for k, v in cache.items()}
    pout, pnew = PA.apply_attention(pw, _t(x), pcfg, hccs=ph, cache=pcache)
    d_out = np.abs(pout.numpy() - np.asarray(jout)).max()
    d_kv = max(np.abs(pnew[n].numpy() - np.asarray(jcache[n])).max()
               for n in ("k", "v"))
    print(f"{branch} {kernel}: max |d| out {d_out:.2e} kv {d_kv:.2e}")
    assert d_out <= BRANCH_ATOL and d_kv <= KV_ATOL


def test_cache_branch_dispatch_runs_the_kernels():
    """t == 1 with the kernel on runs the decode kernels' plain versions
    (CPU tensors); a blocked config (i8 mode) keeps the STE path, as in
    the JAX package."""
    for kernel, mode, want in (("fused", "wide", 2), ("fused", "i8_div", 0),
                               ("none", "wide", 0)):
        cfg = _port(_cfg(decode_kernel=kernel, hccs_mode=mode))
        _, pw = _weights(_cfg())
        _, ph = _hccs(cfg.num_heads)
        n = []
        for branch in ("cont-decode", "lock-decode"):
            x, cache = _branch_case(branch, cfg, np.random.default_rng(0))
            orig = (PA.hccs_decode, PA.hccs_paged_decode)
            try:
                PA.hccs_decode = (lambda *a, **k: n.append(1)
                                  or orig[0](*a, **k))
                PA.hccs_paged_decode = (lambda *a, **k: n.append(1)
                                        or orig[1](*a, **k))
                PA.apply_attention(pw, _t(x), cfg, hccs=ph,
                                   cache={k: _t(np.asarray(v).copy())
                                          for k, v in cache.items()})
            finally:
                PA.hccs_decode, PA.hccs_paged_decode = orig
        assert len(n) == want, (kernel, mode)


# ------------------------------------------------------------------- (c) --

X = np.random.default_rng(0).normal(0, 1, (2, 40, 64)).astype(np.float32)


def _run_port(cfg, hccs=None, x=X):
    _, pw = _weights(cfg)
    out, _ = PA.apply_attention(pw, _t(x), _port(cfg), hccs=hccs)
    return out.numpy()


@pytest.mark.parametrize("prob,mode", [("softmax", "wide"), ("hccs", "wide"),
                                       ("hccs", "i16_div")])
def test_blockwise_matches_dense_within_port(prob, mode):
    cfg_d = _cfg(attention_prob=prob, hccs_mode=mode, attention_impl="dense")
    cfg_b = cfg_d.replace(attention_impl="blockwise", block_k=16)
    ph = _hccs(4)[1] if prob == "hccs" else None
    np.testing.assert_allclose(_run_port(cfg_d, ph), _run_port(cfg_b, ph),
                               atol=REF_ATOL)


def test_window_blockwise_matches_dense_within_port():
    cfg_d = _cfg(attention_prob="hccs", window=8, attention_impl="dense")
    cfg_b = cfg_d.replace(attention_impl="blockwise", block_k=8)
    ph = _hccs(4)[1]
    np.testing.assert_allclose(_run_port(cfg_d, ph), _run_port(cfg_b, ph),
                               atol=REF_ATOL)


@pytest.mark.parametrize("kernel", ["none", "fused"])
def test_decode_row_equals_full_row(kernel):
    """One cached decode step reproduces the last row of full attention
    (with the kernel on, the decode row runs hccs_decode's plain
    version)."""
    cfg = _port(_cfg(attention_prob="hccs", attention_impl="dense",
                     decode_kernel=kernel))
    ph = _hccs(4)[1]
    _, pw = _weights(_cfg(), seed=1)
    x = _t(X)
    full, _ = PA.apply_attention(pw, x, cfg, hccs=ph)
    T = X.shape[1]
    cache = {"k": torch.zeros(2, 2, T, 16), "v": torch.zeros(2, 2, T, 16),
             "length": torch.tensor(0, dtype=torch.int32)}
    PA.apply_attention(pw, x[:, :T - 1], cfg, hccs=ph, cache=cache)
    cache["length"] = torch.tensor(T - 1, dtype=torch.int32)
    last, _ = PA.apply_attention(pw, x[:, T - 1:], cfg, hccs=ph, cache=cache)
    np.testing.assert_allclose(last[:, 0].numpy(), full[:, -1].numpy(),
                               atol=REF_ATOL)
