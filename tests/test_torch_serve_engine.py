"""The port's slot-arena engines and the lockstep paged layout against the
JAX package's engines, and the identities the JAX package asserts among its
engines, held within the port.

(a) The wave ServeEngine, the ContinuousEngine and the lockstep PagedEngine
    (packed=False) of both packages serve the same requests with the same
    weights (carried across by params_from_jax; the JAX kernels run in
    interpret mode): greedy tokens must be identical, with the fused kernel
    on and off, and with the blockwise STE path forced on.
(b) Within the port, as tests/test_serve_engine.py asserts them for the JAX
    engines: wave == continuous (:40, :62, EOS included), continuous ==
    each request served alone (:85), paged == continuous (:209), packed ==
    lockstep (:733), kernel on == kernel off (:187), and a finished slot's
    stale cache is never read (:153).

Every gate here is token identity: on these tiny f32 configs no greedy
token moved in any comparison.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JWave
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import (ContinuousEngine, PagedEngine, Request,
                               ServeEngine)


@pytest.fixture
def served(tiny_cfg):
    """The JAX config and params, and the port's twins."""
    def make(**kw):
        cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div", **kw)
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device="cpu")
        return cfg, params, pcfg, pparams
    return make


def _requests(seed, n=6, lens=(5, 9, 13), max_new=6):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, 256, int(rng.choice(lens))).astype(np.int32),
             max_new) for i in range(n)]


def _serve(engine, reqs, cls=Request):
    for uid, prompt, m in reqs:
        engine.submit(cls(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    return {r.uid: list(r.out_tokens) for r in engine.run()}


ENGINES = {"wave": (JWave, ServeEngine, {}),
           "continuous": (JContinuous, ContinuousEngine, {}),
           "lockstep": (JPaged, PagedEngine,
                        dict(packed=False, block_size=16))}


@pytest.mark.parametrize("kernel", ["fused", "none"])
@pytest.mark.parametrize("engine", list(ENGINES))
def test_engine_matches_jax_engine(served, engine, kernel):
    """Mixed lengths (several waves), a one-token budget, a prompt longer
    than one paged block; with the kernel on, blockwise attention is forced
    (threshold 16, 8-key blocks) so prefill and chunk steps take it."""
    kw = dict(decode_kernel=kernel)
    if kernel == "fused":
        kw.update(blockwise_threshold=16, block_k=8)
    cfg, params, pcfg, pparams = served(**kw)
    reqs = _requests(0, lens=(5, 21))
    reqs[2] = (reqs[2][0], reqs[2][1], 1)
    jcls, pcls, ekw = ENGINES[engine]
    want = _serve(jcls(params, cfg, max_batch=4, max_len=64, **ekw), reqs,
                  JRequest)
    got = _serve(pcls(pparams, pcfg, max_batch=4, max_len=64, device="cpu",
                      **ekw), reqs)
    assert got == want
    assert len(got[2]) == 1


def test_engine_counts_match_jax_engine(served):
    """The lockstep engine's step and lane accounting and its tables, step
    by step; the continuous engine's occupancy."""
    cfg, params, pcfg, pparams = served(decode_kernel="fused")
    reqs = _requests(1, lens=(5, 19, 40))
    kw = dict(max_batch=3, max_len=64, block_size=16, packed=False)
    jeng = JPaged(params, cfg, **kw)
    peng = PagedEngine(pparams, pcfg, device="cpu", **kw)
    for uid, p, m in reqs:
        jeng.submit(JRequest(uid=uid, prompt=p.copy(), max_new_tokens=m))
        peng.submit(Request(uid=uid, prompt=p.copy(), max_new_tokens=m))
    while jeng.busy or peng.busy:
        jeng.step()
        peng.step()
        np.testing.assert_array_equal(jeng._tables, peng._tables)
        assert jeng.occupancy_steps == peng.occupancy_steps
    assert jeng.padding_stats() == peng.padding_stats()
    assert peng.alloc.num_free == peng.num_blocks - 1
    assert 0 < peng.decode_steps < peng.occupancy_steps
    jc = JContinuous(params, cfg, max_batch=2, max_len=64)
    pc = ContinuousEngine(pparams, pcfg, max_batch=2, max_len=64,
                          device="cpu")
    assert _serve(jc, reqs, JRequest) == _serve(pc, reqs)
    assert (jc.occupancy_steps, jc.occupancy_sum) == (pc.occupancy_steps,
                                                      pc.occupancy_sum)


# ------------------------------------------------------------------- (b) --

@pytest.mark.parametrize("kernel", ["fused", "none"])
def test_wave_vs_continuous_within_port(served, kernel):
    _, _, pcfg, pparams = served(decode_kernel=kernel)
    reqs = _requests(2)
    reqs[2] = (reqs[2][0], reqs[2][1], 1)
    reqs[4] = (reqs[4][0], reqs[4][1], 3)
    wave = _serve(ServeEngine(pparams, pcfg, max_batch=4, max_len=64,
                              device="cpu"), reqs)
    cont = _serve(ContinuousEngine(pparams, pcfg, max_batch=4, max_len=64,
                                   device="cpu"), reqs)
    assert wave == cont
    assert len(wave[2]) == 1


def test_wave_vs_continuous_with_eos_within_port(served):
    _, _, pcfg, pparams = served(decode_kernel="fused")
    reqs = _requests(3, n=4, max_new=8)
    probe = _serve(ContinuousEngine(pparams, pcfg, max_batch=4, max_len=64,
                                    device="cpu"), reqs)
    eos = probe[0][0]
    kw = dict(max_batch=4, max_len=64, eos_id=eos, device="cpu")
    wave = _serve(ServeEngine(pparams, pcfg, **kw), reqs)
    cont = _serve(ContinuousEngine(pparams, pcfg, **kw), reqs)
    assert wave == cont
    assert any(toks == [eos] for toks in wave.values())


@pytest.mark.parametrize("engine", ["continuous", "lockstep"])
def test_matches_isolated_decode_within_port(served, engine):
    _, _, pcfg, pparams = served(decode_kernel="fused")
    reqs = _requests(4, n=5, lens=(4, 7, 11, 15), max_new=5)
    _, pcls, ekw = ENGINES[engine]
    make = (lambda: pcls(pparams, pcfg, max_batch=2, max_len=64,
                         device="cpu", **ekw))
    got = _serve(make(), reqs)
    for req in reqs:
        assert _serve(make(), [req]) == {req[0]: got[req[0]]}


@pytest.mark.parametrize("kernel", ["fused", "none"])
def test_paged_vs_continuous_within_port(served, kernel):
    _, _, pcfg, pparams = served(decode_kernel=kernel)
    reqs = _requests(5, n=8, lens=(4, 7, 11, 15, 21))
    reqs[1] = (reqs[1][0], reqs[1][1], 1)
    reqs[5] = (reqs[5][0], reqs[5][1], 12)
    cont = _serve(ContinuousEngine(pparams, pcfg, max_batch=4, max_len=64,
                                   device="cpu"), reqs)
    paged = PagedEngine(pparams, pcfg, max_batch=4, max_len=64,
                        block_size=16, packed=False, device="cpu")
    assert _serve(paged, reqs) == cont
    assert paged.alloc.num_free == paged.num_blocks - 1
    assert (paged._tables == -1).all()


def test_packed_vs_lockstep_within_port(served):
    """The packed token step and the lockstep layout give identical tokens
    while the packed layout pads far fewer lanes (twin of
    tests/test_serve_engine.py:733, without prefix sharing)."""
    _, _, pcfg, pparams = served(decode_kernel="fused")
    rng = np.random.default_rng(6)
    reqs = [(i, rng.integers(0, 256, int(n)).astype(np.int32), 5)
            for i, n in enumerate((5, 13, 21, 39, 35, 32))]
    reqs[1] = (1, reqs[1][1], 1)
    outs, pads = {}, {}
    for packed in (False, True):
        eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=64,
                          block_size=16, packed=packed, device="cpu")
        outs[packed] = _serve(eng, reqs)
        pads[packed] = eng.padding_stats()
    assert outs[False] == outs[True]
    assert pads[True]["efficiency"] > pads[False]["efficiency"]
    assert pads[True]["pad_lanes_skipped"] > 0
    assert pads[False]["pad_lanes_skipped"] == 0


@pytest.mark.parametrize("engine", list(ENGINES))
def test_kernel_on_equals_kernel_off_within_port(served, engine):
    _, _, pcfg, pparams = served()
    reqs = _requests(7, n=4)
    _, pcls, ekw = ENGINES[engine]
    outs = [_serve(pcls(pparams, pcfg.replace(decode_kernel=k), max_batch=4,
                        max_len=64, device="cpu", **ekw), reqs)
            for k in ("none", "fused")]
    assert outs[0] == outs[1]


def test_finished_slot_cache_isolation_within_port(served):
    """A slot freed by a finished request keeps stale K/V; poisoning it
    must not change any live request's tokens."""
    _, _, pcfg, pparams = served(decode_kernel="fused")

    def run(poison: bool):
        eng = ContinuousEngine(pparams, pcfg, max_batch=2, max_len=64,
                               device="cpu")
        eng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32) + 3,
                           max_new_tokens=2))
        eng.submit(Request(uid=1, prompt=np.arange(7, dtype=np.int32) + 40,
                           max_new_tokens=10))
        finished, poisoned = [], False
        while eng.busy:
            finished.extend(eng._admit())
            if poison and not poisoned and not eng._live[0]:
                eng._cache["layers"]["k"][:, 0] = 1e6
                eng._cache["layers"]["v"][:, 0] = -1e6
                poisoned = True
            if eng._live.any():
                finished.extend(eng._step())
        assert not poison or poisoned
        return {r.uid: r.out_tokens for r in finished}

    assert run(poison=False) == run(poison=True)


def test_bf16_weights_with_f32_cache(served):
    """The port serves bf16 weights over the default f32 cache on every
    STE path, the residual stream staying bf16. The JAX package's dense
    path returns the cache dtype there, so its engines fail to trace (the
    layer scan's carry turns f32); the port's dense path returns the
    query's dtype, as the JAX blockwise path and kernels do."""
    cfg, _, pcfg, _ = served(dtype="bfloat16")
    jparams = JM.init_params(jax.random.PRNGKey(0), cfg)
    with pytest.raises(TypeError, match="carry"):
        _serve(JWave(jparams, cfg, max_batch=2, max_len=64),
               _requests(8, n=1), JRequest)
    pparams = M.params_from_jax(jax.tree.map(np.asarray, jparams), pcfg,
                                device="cpu")
    reqs = _requests(8, n=3)
    for engine in ENGINES:
        _, pcls, ekw = ENGINES[engine]
        eng = pcls(pparams, pcfg, max_batch=4, max_len=64, device="cpu",
                   **ekw)
        out = _serve(eng, reqs)
        assert sorted(out) == [0, 1, 2]
        assert all(len(t) == 6 and all(0 <= x < 256 for x in t)
                   for t in out.values())
    x, cache, _ = M.forward(pparams["weights"], pparams["hccs"],
                            {"tokens": torch.zeros((1, 5), dtype=torch.int32)},
                            pcfg, M.init_cache(pcfg, 1, 16, device="cpu"))
    assert x.dtype == torch.bfloat16
    assert cache["layers"]["k"].dtype == torch.float32


@pytest.mark.parametrize("engine", list(ENGINES))
def test_blocked_kernel_warns_and_serves_ste(served, engine):
    """decode_kernel='fused' with an i8 mode cannot take effect: every
    engine warns at construction and serves the STE path, as the JAX
    engines do."""
    _, _, pcfg, pparams = served(decode_kernel="fused")
    _, pcls, ekw = ENGINES[engine]
    with pytest.warns(RuntimeWarning, match="no effect"):
        eng = pcls(pparams, pcfg.replace(hccs_mode="i8_div"), max_batch=4,
                   max_len=64, device="cpu", **ekw)
    assert sorted(_serve(eng, _requests(9, n=2))) == [0, 1]
