"""The port's threefry streams (repro_torch/serve/prng.py) against
jax.random, and temperature sampling against the JAX engines.

fold_in, the uint32/uint16/uint8 bits and the f32/bf16 uniforms are
bit-equal to jax.random's; bf16 Gumbel noise too. f32 Gumbel noise differs
from XLA's where XLA's CPU log is not correctly rounded (within 5e-4), so
f32 draws are held to equal tokens, which they give away from near ties.
Then the port's sample_tokens against the JAX one on mixed greedy and hot
rows, and every engine's temperature-sampled tokens against the JAX
engine on the same weights (tiny config)."""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServe
from repro.serve.engine import sample_tokens as jax_sample_tokens
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import (ContinuousEngine, PagedEngine, Request,
                               ServeEngine, prng)
from repro_torch.serve.engine import BASE_KEY, sample_tokens

KEY = jax.random.PRNGKey(0)
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _jax_key(uid, gen):
    """The JAX engines' per-token key; np.uint32 refuses a negative uid
    under numpy 2, so it is wrapped here as the port wraps it."""
    return jax.random.fold_in(jax.random.fold_in(KEY, np.uint32(uid % 2**32)),
                              np.uint32(gen))


def _keys(rng, n):
    uids = rng.integers(-3, 2**31, n)
    gens = rng.integers(0, 4096, n)
    port = [prng.fold_in(prng.fold_in(BASE_KEY, int(u)), int(g))
            for u, g in zip(uids, gens)]
    ref = [_jax_key(int(u), int(g)) for u, g in zip(uids, gens)]
    return port, ref


def test_prng_key_is_jax_prngkey():
    for seed in (0, 1, 12345, 2**32 - 1):
        want = np.asarray(jax.random.PRNGKey(np.uint32(seed)))
        assert prng.prng_key(seed) == tuple(int(w) for w in want)
    with pytest.raises(ValueError):
        prng.prng_key(-1)


def test_fold_in_bit_equal(rng):
    port, ref = _keys(rng, 64)
    assert [tuple(k) for k in port] == \
        [tuple(int(w) for w in np.asarray(k)) for k in ref]


@pytest.mark.parametrize("width", [32, 16, 8])
@pytest.mark.parametrize("n", [1, 7, 256, 4099])
def test_random_bits_bit_equal(rng, width, n):
    port, ref = _keys(rng, 4)
    dt = {32: jnp.uint32, 16: jnp.uint16, 8: jnp.uint8}[width]
    got = prng.random_bits(torch.tensor(port), n, width).numpy()
    want = np.stack([np.asarray(jax.random.bits(k, (n,), dt)) for k in ref])
    assert np.array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_uniform_bit_equal(rng, dtype):
    tdt, jdt = DTYPES[dtype]
    port, ref = _keys(rng, 8)
    got = prng.uniform(torch.tensor(port), 3000, tdt)
    want = np.stack([np.asarray(jax.random.uniform(
        k, (3000,), jdt, minval=jnp.finfo(jdt).tiny, maxval=1.0))
        for k in ref])
    assert np.array_equal(got.float().numpy(),
                          want.astype(np.float32))
    assert (got > 0).all() and (got < 1).all()


def test_gumbel_bf16_bit_equal_f32_close(rng):
    port, ref = _keys(rng, 8)
    keys = torch.tensor(port)
    got = prng.gumbel(keys, 3000, torch.bfloat16).float().numpy()
    want = np.stack([np.asarray(jax.random.gumbel(k, (3000,), jnp.bfloat16))
                     for k in ref]).astype(np.float32)
    assert np.array_equal(got, want)
    got = prng.gumbel(keys, 3000, torch.float32).numpy()
    want = np.stack([np.asarray(jax.random.gumbel(k, (3000,), jnp.float32))
                     for k in ref])
    # XLA's f32 log (most of all near 1) is less accurate than torch's:
    # measured at most 1.0e-4 apart on noise of magnitude up to ~16, with
    # 10-23% of the elements not bit-equal
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("vocab", [2, 256, 2000])
def test_categorical_equal_to_jax(rng, dtype, vocab):
    """200 draws a case over seeded keys, logits and temperatures."""
    tdt, jdt = DTYPES[dtype]
    port, ref = _keys(rng, 200)
    logits = (rng.normal(size=(200, vocab)) * 3).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, 200).astype(np.float32)
    jl = jnp.asarray(logits, jdt) / jnp.asarray(temps[:, None], jdt)
    tl = (torch.tensor(logits).to(tdt)
          / torch.tensor(temps[:, None]).to(tdt))
    assert np.array_equal(np.asarray(jl.astype(jnp.float32)),
                          tl.float().numpy())
    want = np.asarray(jax.vmap(jax.random.categorical)(jnp.stack(ref), jl))
    got = prng.categorical(torch.tensor(port), tl).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sample_tokens_equal_to_jax(rng, dtype):
    """Mixed greedy and hot rows, negative and repeated uids, several
    generation indices of one request in one batch (a verify row)."""
    tdt, jdt = DTYPES[dtype]
    b, v = 24, 1000
    logits = (rng.normal(size=(b, v)) * 2).astype(np.float32)
    temps = np.where(rng.random(b) < 0.6, rng.uniform(0.5, 1.2, b), 0.0)
    uids = rng.integers(-4, 40, b)
    uids[5:9] = 17
    gen = rng.integers(0, 64, b)
    gen[5:9] = np.arange(30, 34)
    hot = temps > 0
    want = np.array(jnp.argmax(jnp.asarray(logits, jdt), -1))
    if hot.any():
        keys = jnp.stack([_jax_key(int(uids[i]), int(gen[i]))
                          for i in np.flatnonzero(hot)])
        want[hot] = np.asarray(jax.vmap(jax.random.categorical)(
            keys, jnp.asarray(logits, jdt)[hot]
            / jnp.asarray(temps[hot, None], jdt)))
    got = sample_tokens(BASE_KEY, torch.tensor(logits).to(tdt), temps, uids,
                        gen)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    # the JAX package's own sampler where its uids are non-negative
    keep = uids >= 0
    jl = jnp.asarray(logits[keep], jdt)
    ref = jax_sample_tokens(KEY, jl, temps[keep], uids[keep], gen[keep])
    assert np.array_equal(got[keep], ref)


def test_sample_tokens_greedy_only_never_draws(monkeypatch):
    def no_draw(*a, **kw):
        raise AssertionError("a greedy batch drew noise")
    monkeypatch.setattr(prng, "categorical", no_draw)
    logits = torch.tensor([[0.0, 2.0, 2.0], [5.0, 1.0, 5.0]])
    got = sample_tokens(BASE_KEY, logits, [0.0, 0.0], [1, 2], [0, 0])
    assert got.tolist() == [1, 0]            # first maximal index on ties


# ------------------------------------------------ engine-level twins --

_MODELS: dict = {}


def _models(tiny_cfg):
    if not _MODELS:
        cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div")
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device="cpu")
        _MODELS["m"] = (cfg, params, pcfg, pparams)
    return _MODELS["m"]


def _hot_requests(cls, n=8, temps=(0.8, 0.0, 1.3, 0.6), repeat=False):
    """Seeded prompts; with `repeat` each prompt repeats a short motif, so
    speculative decoding finds drafts to verify."""
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        if repeat:
            motif = rng.integers(0, 256, 4).astype(np.int32)
            prompt = np.tile(motif, 5)
        else:
            prompt = rng.integers(0, 256, int(rng.integers(4, 20))).astype(
                np.int32)
        out.append(cls(uid=i, prompt=prompt,
                       max_new_tokens=int(rng.integers(3, 10)),
                       temperature=float(temps[i % len(temps)])))
    return out


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


ENGINES = {
    "wave": (JServe, ServeEngine, {}),
    "continuous": (JContinuous, ContinuousEngine, {}),
    "paged": (JPaged, PagedEngine, dict(block_size=8)),
    "lockstep": (JPaged, PagedEngine, dict(block_size=8, packed=False)),
    "speculative": (JPaged, PagedEngine,
                    dict(block_size=8, speculative=True,
                         prefix_sharing=True)),
}


@pytest.mark.parametrize("name", sorted(ENGINES))
def test_engine_temperature_tokens_equal_jax(tiny_cfg, name):
    """Hot and greedy requests in one batch: the port's tokens equal the
    JAX engine's on the same weights, every engine, speculative verify
    lanes included (each lane samples with its own generation index)."""
    cfg, params, pcfg, pparams = _models(tiny_cfg)
    jcls, pcls, kw = ENGINES[name]
    repeat = name == "speculative"
    jeng = jcls(params, cfg, max_batch=4, max_len=64, **kw)
    peng = pcls(pparams, pcfg, max_batch=4, max_len=64, device="cpu", **kw)
    ref = _serve(jeng, _hot_requests(JRequest, repeat=repeat))
    got = _serve(peng, _hot_requests(Request, repeat=repeat))
    assert got == ref
    if name == "speculative":
        assert peng.drafted_tokens == jeng.drafted_tokens > 0
        assert peng.accepted_tokens == jeng.accepted_tokens


def test_sampled_output_independent_of_batch(tiny_cfg):
    """A hot request draws the same tokens alone and beside others (its
    keys fold its uid and generation index, not its batch position)."""
    _, _, pcfg, pparams = _models(tiny_cfg)
    reqs = _hot_requests(Request)
    alone = copy.deepcopy(reqs[2])
    eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=64, block_size=8,
                      device="cpu")
    batch = _serve(eng, reqs)
    eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=64, block_size=8,
                      device="cpu")
    assert _serve(eng, [alone]) == {2: batch[2]}
