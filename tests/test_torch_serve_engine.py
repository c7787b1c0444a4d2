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
import torch_threads  # noqa: F401  (first: one torch thread a worker)
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
        cfg = tiny_cfg(**{"attention_prob": "hccs", "hccs_mode": "i16_div",
                          **kw})
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


# ---------------------------------- (c) sharing, sessions, the packed grid --
# Twins of tests/test_serve_engine.py:306-485, :631, :665-733: prefix and
# decode sharing with copy-on-write and eviction, multi-turn sessions, and
# the packed step's per-slot STE grid, each against the JAX engine on the
# same weights and requests (greedy tokens, and where the JAX test reads
# them, prefix_stats and block tables) and as on/off identities within the
# port. Every gate is token identity.

def _prefix_stats_equal(peng, jeng):
    ps = peng.prefix_stats()
    js = {k: v for k, v in jeng.prefix_stats().items() if k in ps}
    assert ps == js


def test_prefix_sharing_cow_and_shared_kv_immutable(served):
    """Requests sharing a 2-block prefix, then diverging, one a full-prompt
    hit that must copy-on-write: tokens equal to sharing off and to the JAX
    engine, the shared blocks' KV bit-unchanged, the pool drained after
    clear_prefix_cache."""
    cfg, params, pcfg, pparams = served()
    rng = np.random.default_rng(20)
    shared = rng.integers(0, 256, 32).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 256, n).astype(
        np.int32)]) for n in (7, 11)] + [shared.copy()]

    def serve(sharing, jax_engine=False):
        kw = dict(max_batch=1, max_len=64, block_size=16,
                  prefix_sharing=sharing)
        eng = (JPaged(params, cfg, **kw) if jax_engine
               else PagedEngine(pparams, pcfg, device="cpu", **kw))
        rcls = JRequest if jax_engine else Request
        outs, snap, blocks, stats = {}, None, None, None
        for i, p in enumerate(prompts):
            eng.submit(rcls(uid=i, prompt=p.copy(), max_new_tokens=5))
            (done,) = eng.run()
            outs[i] = list(done.out_tokens)
            if sharing and not jax_engine and i == 0:
                blocks = [blk for _, blk in eng._match_prefix(shared)]
                assert len(blocks) == 2
                snap = (eng._cache["layers"]["k"][:, blocks].clone(),
                        eng._cache["layers"]["v"][:, blocks].clone())
        if sharing:
            stats = eng.prefix_stats()
        if sharing and not jax_engine:
            s = stats
            assert s["hits"] == 2 and s["lookups"] == 3
            assert s["cow_copies"] == 1 and s["prefill_tokens_skipped"] == 63
            assert torch.equal(eng._cache["layers"]["k"][:, blocks], snap[0])
            assert torch.equal(eng._cache["layers"]["v"][:, blocks], snap[1])
            eng.clear_prefix_cache()
            assert eng.alloc.num_free == eng.num_blocks - 1
        return outs, stats

    (on, pstats), (off, _) = serve(True), serve(False)
    jon, jstats = serve(True, jax_engine=True)
    assert on == off == jon
    assert pstats == {k: v for k, v in jstats.items() if k in pstats}


def test_prefix_sharing_skip_rate_and_parity(served):
    """A shared 48-token system prompt: >= 30% of prefill tokens skipped,
    tokens equal to sharing off and to the JAX engine, equal stats."""
    cfg, params, pcfg, pparams = served()
    rng = np.random.default_rng(21)
    system = rng.integers(0, 256, 48).astype(np.int32)
    reqs = [(i, np.concatenate([system, rng.integers(
        0, 256, int(rng.integers(3, 12))).astype(np.int32)]), 4)
        for i in range(8)]
    kw = dict(max_batch=2, max_len=96, block_size=16)
    off = _serve(PagedEngine(pparams, pcfg, device="cpu", **kw), reqs)
    peng = PagedEngine(pparams, pcfg, device="cpu", prefix_sharing=True,
                       **kw)
    jeng = JPaged(params, cfg, prefix_sharing=True, **kw)
    assert _serve(peng, reqs) == off == _serve(jeng, reqs, JRequest)
    s = peng.prefix_stats()
    assert s["skip_rate"] >= 0.30 and s["hits"] >= 6
    assert s["prefill_tokens_skipped"] >= 6 * 48
    _prefix_stats_equal(peng, jeng)


def test_prefix_sharing_eviction_under_pool_pressure(served):
    """Distinct prompts churning a tiny pool force LRU eviction: the run
    completes, the trie never points at a freed block, and tokens, tables
    and counters equal the JAX engine's step by step."""
    cfg, params, pcfg, pparams = served()
    rng = np.random.default_rng(22)
    reqs = [(i, rng.integers(0, 256, 35).astype(np.int32), 4)
            for i in range(6)]
    kw = dict(max_batch=2, max_len=64, block_size=16, num_blocks=6,
              prefix_sharing=True)
    peng = PagedEngine(pparams, pcfg, device="cpu", **kw)
    jeng = JPaged(params, cfg, **kw)
    for uid, p, m in reqs:
        peng.submit(Request(uid=uid, prompt=p.copy(), max_new_tokens=m))
        jeng.submit(JRequest(uid=uid, prompt=p.copy(), max_new_tokens=m))
    done, jdone = [], []
    while peng.busy or jeng.busy:
        done.extend(peng.step())
        jdone.extend(jeng.step())
        np.testing.assert_array_equal(peng._tables, jeng._tables)
    assert ({r.uid: r.out_tokens for r in done}
            == {r.uid: r.out_tokens for r in jdone})
    assert len(done) == 6 and peng.prefix_stats()["evictions"] > 0
    _prefix_stats_equal(peng, jeng)
    for blk in peng.trie.blocks():
        assert peng.alloc.ref(blk) >= 1


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("sharing", [False, True])
def test_multi_turn_session_parity(served, sharing, packed, kv_quant):
    """Session-continued tokens equal re-feeding the concatenated history
    from scratch, sharing on and off, packed and lockstep, f32 and int8
    pools; the stored history equals the manual concatenation; with sharing
    the JAX session engine gives the same tokens and counters."""
    cfg, params, pcfg, pparams = served(kv_quant=kv_quant)
    rng = np.random.default_rng(23)
    n_sessions, turns = 2, 3
    # turn 1 crosses a block boundary during decode (25 + 7 = 32), so a
    # generated block is cached and later turns get decode-block hits
    msgs = [[rng.integers(0, 256, n).astype(np.int32) for n in (25, 7, 22)]
            for _ in range(n_sessions)]
    kw = dict(max_batch=2, max_len=128, block_size=16, packed=packed)
    share = dict(prefix_sharing=sharing, decode_sharing=sharing)
    sess = PagedEngine(pparams, pcfg, device="cpu", **share, **kw)
    ref = PagedEngine(pparams, pcfg, device="cpu", **kw)
    jsess = JPaged(params, cfg, **share, **kw) if sharing else None
    hist = [np.zeros(0, np.int32)] * n_sessions
    for turn in range(turns):
        srun, rrun, jrun = [], [], []
        for s in range(n_sessions):
            srun.append(Request(uid=s, prompt=msgs[s][turn].copy(),
                                max_new_tokens=8))
            sess.submit(srun[-1], session=f"chat{s}")
            rrun.append(Request(uid=s, prompt=np.concatenate(
                [hist[s], msgs[s][turn]]), max_new_tokens=8))
            ref.submit(rrun[-1])
            if jsess is not None:
                jrun.append(JRequest(uid=s, prompt=msgs[s][turn].copy(),
                                     max_new_tokens=8))
                jsess.submit(jrun[-1], session=f"chat{s}")
        sess.run()
        ref.run()
        if jsess is not None:
            jsess.run()
        for s in range(n_sessions):
            assert srun[s].out_tokens == rrun[s].out_tokens, (turn, s)
            if jsess is not None:
                assert srun[s].out_tokens == jrun[s].out_tokens, (turn, s)
            hist[s] = np.concatenate([hist[s], msgs[s][turn], np.asarray(
                rrun[s].out_tokens, np.int32)])
            np.testing.assert_array_equal(sess.session_history(f"chat{s}"),
                                          hist[s])
    if sharing:
        s = sess.prefix_stats()
        assert s["decode_hits"] > 0 and s["cached_decode_blocks"] > 0
        assert s["followup_tokens_skipped"] > 0
        assert (s["prompt_tokens_skipped"] + s["decode_tokens_skipped"]
                == s["prefill_tokens_skipped"])
        _prefix_stats_equal(sess, jsess)
    for s in range(n_sessions):
        sess.end_session(f"chat{s}")
    sess.clear_prefix_cache()
    assert sess.alloc.num_free == sess.num_blocks - 1


def test_session_bookkeeping_guards(served):
    _, _, pcfg, pparams = served()
    rng = np.random.default_rng(24)
    eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=16,
                      decode_sharing=True, device="cpu")
    assert eng.prefix_sharing            # decode sharing implies the trie
    r0 = Request(uid=0, prompt=rng.integers(0, 256, 9).astype(np.int32),
                 max_new_tokens=4)
    eng.submit(r0, session="a")
    with pytest.raises(ValueError):      # turn 2 before turn 1 finished
        eng.submit(Request(uid=1, prompt=r0.prompt.copy()), session="a")
    eng.run()
    assert len(eng.session_history("a")) == len(r0.prompt) + 4
    assert eng.session_history("missing") is None
    eng.end_session("a")
    assert eng.session_history("a") is None
    r1 = Request(uid=2, prompt=rng.integers(0, 256, 9).astype(np.int32),
                 max_new_tokens=4)
    eng.submit(r1, session="a")
    eng.run()
    assert len(eng.session_history("a")) == len(r1.prompt) + 4


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_decode_block_churn_refcounts_and_drain(served, kv_quant):
    """Multi-turn sessions on a tiny pool: eviction and decode-frontier
    registration churn together. After every step the allocator is
    conserved, the trie never points at a freed block, every live table
    block is referenced; afterwards the pool drains completely."""
    _, _, pcfg, pparams = served(kv_quant=kv_quant)
    rng = np.random.default_rng(25)
    eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=8,
                      num_blocks=12, prefix_sharing=True, decode_sharing=True,
                      device="cpu")
    for i in range(4):
        for turn in range(2):
            eng.submit(Request(uid=10 * i + turn, prompt=rng.integers(
                0, 256, 21).astype(np.int32), max_new_tokens=8),
                session=f"s{i}")
            while eng._queue or eng._live.any():
                eng._admit()
                eng._step_packed_sync()
                assert (eng.alloc.num_free + eng.alloc.num_live
                        == eng.num_blocks - 1)
                for blk in eng.trie.blocks():
                    assert eng.alloc.ref(blk) >= 1
                for slot in np.flatnonzero(eng._live):
                    row = eng._tables[slot]
                    assert all(eng.alloc.ref(int(b)) >= 1
                               for b in row[row >= 0])
    s = eng.prefix_stats()
    assert s["evictions"] > 0
    assert s["cached_decode_blocks"] > 0 or s["decode_hits"] > 0
    eng.clear_prefix_cache()
    assert eng.alloc.num_free == eng.num_blocks - 1
    assert eng.alloc.num_live == 0 and (eng._tables == -1).all()


def test_end_session_cancels_in_flight_turn(served):
    """end_session on a mid-decode turn cancels it (failed, "cancelled",
    no history), the session is reusable at once, and its next turn equals
    a first turn on a fresh engine."""
    _, _, pcfg, pparams = served()
    rng = np.random.default_rng(26)
    kw = dict(max_batch=2, max_len=64, block_size=8, prefix_sharing=True,
              device="cpu")
    eng = PagedEngine(pparams, pcfg, num_blocks=12, **kw)
    p1 = rng.integers(0, 256, 11).astype(np.int32)
    p2 = rng.integers(0, 256, 9).astype(np.int32)
    r1 = Request(uid=1, prompt=p1, max_new_tokens=16)
    eng.submit(r1, session="s")
    eng.step()
    assert eng.busy and not r1.done
    eng.end_session("s")
    assert r1.failed and r1.fail_reason == "cancelled" and not r1.done
    assert not eng.busy
    assert not eng.cancel(12345)         # unknown uid
    r2 = Request(uid=2, prompt=p2.copy(), max_new_tokens=6)
    eng.submit(r2, session="s")
    assert [r.uid for r in eng.run()] == [2] and r2.done
    fresh = PagedEngine(pparams, pcfg, **kw)
    rf = Request(uid=3, prompt=p2.copy(), max_new_tokens=6)
    fresh.submit(rf, session="x")
    fresh.run()
    assert r2.out_tokens == rf.out_tokens
    eng.clear_prefix_cache()
    assert eng.alloc.num_free == eng.num_blocks - 1


def test_watermark_parent_survives_eviction_and_cache_clear(served):
    """Under first-writer-wins a live slot's watermark parent may be another
    chain's block it holds no reference to: eviction must refuse it, and
    clear_prefix_cache mid-flight resets the watermark."""
    _, _, pcfg, pparams = served()
    rng = np.random.default_rng(27)
    prompt = rng.integers(0, 256, 9).astype(np.int32)
    eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=8,
                      decode_sharing=True, device="cpu")
    eng.submit(Request(uid=0, prompt=prompt.copy(), max_new_tokens=8))
    eng.submit(Request(uid=1, prompt=prompt.copy(), max_new_tokens=20))
    saw_foreign_parent = cleared = False
    while eng._queue or eng._live.any():
        eng._admit()
        eng._step_packed_sync()
        live = np.flatnonzero(eng._live)
        if len(live) == 1:
            slot = int(live[0])
            parent = int(eng._reg_parent[slot])
            row = eng._tables[slot]
            if parent >= 0 and parent not in set(map(int, row[row >= 0])):
                saw_foreign_parent = True
                while eng._evict_one():
                    pass
                assert parent in set(map(int, eng.trie.blocks()))
                if not cleared:
                    eng.clear_prefix_cache()
                    cleared = True
                    assert int(eng._reg_parent[slot]) == -1
                    assert int(eng._reg_level[slot]) == 0
        for (par, _), blk in eng.trie._index.items():
            assert par == -1 or par in eng.trie._block_key
    assert saw_foreign_parent and cleared
    eng.clear_prefix_cache()
    assert eng.alloc.num_free == eng.num_blocks - 1


def test_multi_turn_followup_skip_acceptance(served):
    """A chat workload with decode sharing skips >= 30% of follow-up-turn
    prefill tokens, with decode-block hits (the JAX package's slow-job
    acceptance; the port's CPU engine runs it in seconds)."""
    _, _, pcfg, pparams = served()
    rng = np.random.default_rng(28)
    eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=256,
                      block_size=16, decode_sharing=True, device="cpu")
    for i in range(3):
        for turn in range(4):
            eng.submit(Request(uid=10 * i + turn, prompt=rng.integers(
                0, 256, 25).astype(np.int32), max_new_tokens=8),
                session=f"s{i}")
            eng.run()
    s = eng.prefix_stats()
    assert s["followup_skip_rate"] >= 0.30 and s["decode_hits"] > 0, s


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("sharing", [False, True])
def test_packed_step_parity_with_lockstep_and_sharing(served, sharing,
                                                      kv_quant):
    """Packed == lockstep with prefix sharing off and on (a full-prompt hit
    exercises COW), equal prefix telemetry, fewer padded lanes packed."""
    _, _, pcfg, pparams = served(kv_quant=kv_quant)
    rng = np.random.default_rng(29)
    shared = rng.integers(0, 256, 32).astype(np.int32)
    prompts = ([rng.integers(0, 256, n).astype(np.int32) for n in (5, 13, 21)]
               + [np.concatenate([shared, rng.integers(0, 256, n).astype(
                   np.int32)]) for n in (7, 3)] + [shared.copy()])
    reqs = [(i, p, 1 if i == 1 else 5) for i, p in enumerate(prompts)]
    outs, engines = {}, {}
    for packed in (False, True):
        eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=64,
                          block_size=16, packed=packed,
                          prefix_sharing=sharing, device="cpu")
        outs[packed] = _serve(eng, reqs)
        engines[packed] = eng
    assert outs[False] == outs[True]
    assert (engines[False].prefix_stats()["prefill_tokens_skipped"]
            == engines[True].prefix_stats()["prefill_tokens_skipped"])
    pf, pt = engines[False].padding_stats(), engines[True].padding_stats()
    assert pt["efficiency"] > pf["efficiency"]
    if sharing:
        assert engines[True].prefix_stats()["cow_copies"] >= 1


@pytest.mark.parametrize("cfg_kw", [dict(decode_kernel="none"),
                                    dict(hccs_mode="i8_div"),
                                    dict(hccs_mode="i8_clb"),
                                    dict(attention_prob="softmax")],
                         ids=["kernel-off", "i8_div", "i8_clb", "softmax"])
def test_packed_grid_engine_matches_jax(served, cfg_kw):
    """The packed engine without the kernel runs the per-slot STE grid:
    tokens, step counts and tables equal the JAX packed engine's, with a
    prompt longer than one chunk cap (grid rung 64) and a decode-only tail
    (grid rung 1)."""
    cfg, params, pcfg, pparams = served(**cfg_kw)
    pparams.setdefault("hccs", {})      # softmax: the bridge drops {} leaves
    reqs = _requests(30, n=6, lens=(5, 21, 70), max_new=6)
    kw = dict(max_batch=4, max_len=96, block_size=16)
    jeng = JPaged(params, cfg, **kw)
    peng = PagedEngine(pparams, pcfg, device="cpu", **kw)
    assert peng._use_grid
    assert _serve(peng, reqs) == _serve(jeng, reqs, JRequest)
    assert peng.occupancy_steps == jeng.occupancy_steps


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
@pytest.mark.parametrize("mode", ["i16_div", "wide"])
def test_packed_kernel_on_equals_grid_within_port(served, mode, kv_quant):
    """The packed step through hccs_packed_prefill == the per-slot STE
    grid, token for token."""
    _, _, pcfg, pparams = served(hccs_mode=mode, kv_quant=kv_quant)
    reqs = _requests(31, n=4, lens=(5, 9, 19), max_new=4)
    outs = []
    for kernel in ("none", "fused"):
        eng = PagedEngine(pparams, pcfg.replace(decode_kernel=kernel),
                          max_batch=4, max_len=64, block_size=16,
                          device="cpu")
        assert eng._use_grid == (kernel == "none")
        outs.append(_serve(eng, reqs))
    assert outs[0] == outs[1]
