"""The port's pipelined async loop (repro_torch/serve/paged.py, "PIPELINED
ASYNC LOOP"), twin of tests/test_async_loop.py: greedy token parity
async-on vs async-off across the packed x sharing x int8 x speculative
matrix, hot sampling, EOS one step late (f32 and int8 pools) and multi-turn
sessions. Chaos invariants at commit boundaries, profiler coverage under
overlap and sync-point hygiene are in test_torch_async_chaos.py; the shared
substrate in torch_async.py.

Each engine run is held to the JAX engine on the same weights (the numpy
bridge): the same tokens, the same step count, the same overlapped and
fallback counts."""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest

import torch_async as A
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro_torch.kernels.decode import SPLIT_SWEEP_TOKENS
from repro_torch.serve import PagedEngine, Request
from repro_torch.serve.paged import TILE_STATS


@pytest.fixture
def served(tiny_cfg):
    return A.models(tiny_cfg)


@pytest.fixture
def served_int8(tiny_cfg):
    return A.models(tiny_cfg, "int8")


def _serve(models, async_loop, *, eos_id=5, temps=None, **kw):
    _, _, pcfg, pparams = models
    eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=128, block_size=16,
                      packed=True, async_loop=async_loop, eos_id=eos_id,
                      device="cpu", **kw)
    return A.run(eng, A.requests(temps=temps))


def _serve_jax(models, async_loop, *, eos_id=5, temps=None, **kw):
    cfg, params, _, _ = models
    eng = JPaged(params, cfg, max_batch=4, max_len=128, block_size=16,
                 packed=True, async_loop=async_loop, eos_id=eos_id, **kw)
    return A.run(eng, A.requests(temps=temps, cls=JRequest))


def _same_run(eng, jeng):
    assert (eng.occupancy_steps, eng.async_overlapped_steps,
            eng.async_sync_fallbacks) == \
        (jeng.occupancy_steps, jeng.async_overlapped_steps,
         jeng.async_sync_fallbacks)
    assert eng.prefix_stats() == jeng.prefix_stats()
    pad = eng.padding_stats()
    assert {k: v for k, v in pad.items() if k not in TILE_STATS} == \
        jeng.padding_stats()
    # no tiles: every step is narrow enough for the split sweep
    assert max(eng._widths) <= SPLIT_SWEEP_TOKENS
    assert pad["tile_rows_valid"] == pad["tile_rows_total"] == 0


LEGS = {
    "packed": {},
    "prefix": dict(prefix_sharing=True),
    "decode_sharing": dict(prefix_sharing=True, decode_sharing=True),
    "speculative": dict(speculative=True, prefix_sharing=True),
}


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_async_greedy_parity(served, leg):
    """Greedy outputs are token-identical with the async loop on or off and
    equal to the JAX async engine's; non-speculative legs genuinely
    overlap, speculative degrades to the sync fallback."""
    sync_out, _ = _serve(served, False, **LEGS[leg])
    async_out, eng = _serve(served, True, **LEGS[leg])
    assert async_out == sync_out
    jax_out, jeng = _serve_jax(served, True, **LEGS[leg])
    assert async_out == jax_out
    _same_run(eng, jeng)
    if LEGS[leg].get("speculative"):
        assert eng.async_overlapped_steps == 0
        assert eng.async_sync_fallbacks > 0
    else:
        assert eng.async_overlapped_steps > 0
        assert eng.async_sync_fallbacks == 0


@pytest.mark.parametrize("leg", ["packed", "prefix", "speculative"])
def test_async_greedy_parity_int8(served_int8, leg):
    """The same parity on the int8-quantized block pool: per-block scale
    growth (and the speculative restore-then-replay) commute with the
    one-step-late commit."""
    sync_out, _ = _serve(served_int8, False, **LEGS[leg])
    async_out, eng = _serve(served_int8, True, **LEGS[leg])
    assert async_out == sync_out
    jax_out, jeng = _serve_jax(served_int8, True, **LEGS[leg])
    assert async_out == jax_out
    _same_run(eng, jeng)
    if not LEGS[leg].get("speculative"):
        assert eng.async_overlapped_steps > 0


def test_async_hot_sampling_falls_back(served):
    """Sampled (temperature > 0) slots need landed logits on the host —
    those steps degrade to commit-then-sync-step, and outputs equal the
    synchronous loop's and the JAX async engine's (the keys fold (uid,
    generation index))."""
    sync_out, _ = _serve(served, False, temps=(0.7, 1.0))
    async_out, eng = _serve(served, True, temps=(0.7, 1.0))
    assert async_out == sync_out
    assert eng.async_overlapped_steps == 0
    assert eng.async_sync_fallbacks > 0
    jax_out, jeng = _serve_jax(served, True, temps=(0.7, 1.0))
    assert async_out == jax_out
    _same_run(eng, jeng)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_async_eos_one_step_late(tiny_cfg, quant):
    """EOS cannot be predicted at dispatch: the async loop runs one extra
    in-flight step for an EOS slot and discards its writes at commit; on
    the int8 pool the reallocated blocks' scales are zeroed before their
    next fold. Parity with an eos_id picked from the middle of a sync
    run's output, so the late-EOS path fires."""
    models = A.models(tiny_cfg, quant)
    sync_out, _ = _serve(models, False, eos_id=None)
    # a token some request emits mid-output: stopping there exercises the
    # discard-the-extra-step path on every request that emits it
    eos = next(toks[len(toks) // 2] for toks in sync_out.values()
               if len(toks) >= 3)
    sync_eos, _ = _serve(models, False, eos_id=eos)
    async_eos, eng = _serve(models, True, eos_id=eos)
    assert async_eos == sync_eos
    assert eng.async_overlapped_steps > 0
    assert any(len(t) < len(sync_out[u]) for u, t in sync_eos.items()), \
        "chosen eos_id never cut a request short — test is vacuous"
    jax_out, jeng = _serve_jax(models, True, eos_id=eos)
    assert async_eos == jax_out
    _same_run(eng, jeng)


def test_async_multi_turn_sessions(served):
    """Session follow-up turns (decode-block sharing) are token-identical
    under the pipelined loop — commit-time trie registration with the
    record's own coverage indexes exactly the blocks the sync loop
    registers — and equal the JAX async engine's."""
    cfg, params, pcfg, pparams = served

    def serve_turns(make, cls):
        eng = make()
        rng = np.random.default_rng(11)
        out = {}
        for turn in range(3):
            for s in range(3):
                msg = rng.integers(0, 256, 12).astype(np.int32)
                eng.submit(cls(uid=10 * turn + s, prompt=msg,
                               max_new_tokens=6), session=f"chat-{s}")
            for r in eng.run():
                out[r.uid] = [int(t) for t in r.out_tokens]
        return out, eng

    kw = dict(max_batch=3, max_len=192, block_size=16, packed=True,
              prefix_sharing=True, decode_sharing=True)
    sync_out, _ = serve_turns(
        lambda: PagedEngine(pparams, pcfg, async_loop=False, device="cpu",
                            **kw), Request)
    async_out, eng = serve_turns(
        lambda: PagedEngine(pparams, pcfg, async_loop=True, device="cpu",
                            **kw), Request)
    assert async_out == sync_out
    assert eng.async_overlapped_steps > 0
    jax_out, jeng = serve_turns(
        lambda: JPaged(params, cfg, async_loop=True, **kw), JRequest)
    assert async_out == jax_out
    _same_run(eng, jeng)


def test_async_requires_packed(served):
    _, _, pcfg, pparams = served
    with pytest.raises(ValueError, match="packed"):
        PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=16,
                    packed=False, async_loop=True, device="cpu")


def test_cfg_async_loop_requires_paged(served):
    _, _, pcfg, _ = served
    with pytest.raises(ValueError, match="paged"):
        pcfg.replace(async_loop=True)      # default cache_layout is slot
    cfg = pcfg.replace(async_loop=True, cache_layout="paged")
    assert cfg.async_loop


def test_async_engine_reads_cfg_flag(served):
    _, _, pcfg, pparams = served
    eng = PagedEngine(pparams, pcfg.replace(cache_layout="paged",
                                            async_loop=True),
                      max_batch=2, max_len=64, block_size=16, device="cpu")
    assert eng.async_loop
