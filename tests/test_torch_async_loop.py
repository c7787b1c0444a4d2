"""The port's pipelined async loop (repro_torch/serve/paged.py, "PIPELINED
ASYNC LOOP"), twin of tests/test_async_loop.py: greedy token parity
async-on vs async-off across the packed x sharing x int8 x speculative
matrix, EOS one step late (f32 and int8 pools), chaos invariants at commit
boundaries, profiler coverage under overlap, and sync-point hygiene — an
unprofiled step of any paged or continuous path makes no device fence.

Each engine run is held to the JAX engine on the same weights (the numpy
bridge): the same tokens, the same step count, the same overlapped and
fallback counts, and under chaos the same fault schedule and outcomes."""
import dataclasses

import jax
import numpy as np
import pytest

from repro.models import model as JM
from repro.serve import AdmissionConfig as JAdmission
from repro.serve import ChaosMonkey as JChaosMonkey
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import (AdmissionConfig, ChaosMonkey, ContinuousEngine,
                               PagedEngine, Request, ServeEngine, Telemetry)
from repro_torch.serve import telemetry as T

_MODELS: dict = {}


def _models(tiny_cfg, quant="none"):
    if quant not in _MODELS:
        cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div",
                       kv_quant=quant)
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device="cpu")
        _MODELS[quant] = (cfg, params, pcfg, pparams)
    return _MODELS[quant]


@pytest.fixture
def served(tiny_cfg):
    return _models(tiny_cfg)


@pytest.fixture
def served_int8(tiny_cfg):
    return _models(tiny_cfg, "int8")


def _requests(seed=7, n=10, shared_len=32, temps=None, cls=Request):
    """Mixed traffic: odd uids share a 2-block prompt prefix (so the
    sharing legs actually hit the trie), prompt/budget lengths seeded."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, shared_len).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, 256, int(rng.integers(3, 24))).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 else tail
        reqs.append(cls(uid=i, prompt=prompt,
                        max_new_tokens=int(rng.integers(2, 12)),
                        temperature=(0.0 if temps is None
                                     else float(temps[i % len(temps)]))))
    return reqs


def _run(eng, reqs):
    for req in reqs:
        eng.submit(req)
    done = eng.run()
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}, eng


def _serve(models, async_loop, *, eos_id=5, temps=None, **kw):
    _, _, pcfg, pparams = models
    eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=128, block_size=16,
                      packed=True, async_loop=async_loop, eos_id=eos_id,
                      device="cpu", **kw)
    return _run(eng, _requests(temps=temps))


def _serve_jax(models, async_loop, *, eos_id=5, temps=None, **kw):
    cfg, params, _, _ = models
    eng = JPaged(params, cfg, max_batch=4, max_len=128, block_size=16,
                 packed=True, async_loop=async_loop, eos_id=eos_id, **kw)
    return _run(eng, _requests(temps=temps, cls=JRequest))


def _same_run(eng, jeng):
    assert (eng.occupancy_steps, eng.async_overlapped_steps,
            eng.async_sync_fallbacks) == \
        (jeng.occupancy_steps, jeng.async_overlapped_steps,
         jeng.async_sync_fallbacks)
    assert eng.prefix_stats() == jeng.prefix_stats()
    assert eng.padding_stats() == jeng.padding_stats()


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
    models = _models(tiny_cfg, quant)
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


# ------------------------------------------------------- chaos harness --


def _chaos_maker(seed=5, cls=Request):
    rng = np.random.default_rng(seed)

    def mk(i):
        plen = int(rng.integers(4, 24))
        return cls(uid=i,
                   prompt=rng.integers(0, 256, plen).astype(np.int32),
                   max_new_tokens=int(rng.integers(2, 8)),
                   priority=int(rng.integers(0, 3)),
                   deadline_e2e=30.0)

    return mk


def _outcome(rep):
    return (rep["steps"], rep["submitted"], rep["faults"],
            sorted((r.uid, tuple(int(t) for t in r.out_tokens))
                   for r in rep["finished"]),
            sorted((r.uid, r.fail_reason) for r in rep["failed"]))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_async_chaos_invariants(tiny_cfg, quant):
    """The block-accounting invariants hold at every commit boundary under
    fault injection with the pipeline on: preemption, cancellation and
    device faults mid-pipeline dead-mark the in-flight record and drain
    cleanly to a fully reclaimed pool. The monkey wraps the async seam;
    the JAX monkey on the JAX async engine reports the same run."""
    cfg, params, pcfg, pparams = _models(tiny_cfg, quant)
    kw = dict(max_batch=3, max_len=64, block_size=8, num_blocks=14,
              packed=True, async_loop=True, eos_id=5)
    adm = dict(max_queue=8, backpressure="shed-lowest-priority",
               preemption=True)
    eng = PagedEngine(pparams, pcfg, admission=AdmissionConfig(**adm),
                      device="cpu", **kw)
    monkey = ChaosMonkey(eng, seed=0, make_request=_chaos_maker(),
                         n_requests=12, max_steps=1500)
    assert eng._packed_async_fn is not eng._packed_async_forward
    report = monkey.run()
    assert report["submitted"] == 12
    assert sum(report["faults"].values()) > 0, "no fault ever injected"
    assert report["finished"], "chaos killed every single request"
    assert eng.async_overlapped_steps > 0, "pipeline never engaged"
    jeng = JPaged(params, cfg, admission=JAdmission(**adm), **kw)
    jreport = JChaosMonkey(jeng, seed=0,
                           make_request=_chaos_maker(cls=JRequest),
                           n_requests=12, max_steps=1500).run()
    assert _outcome(report) == _outcome(jreport)
    assert eng.async_overlapped_steps == jeng.async_overlapped_steps


# ----------------------------------------------------------- telemetry --


def test_async_profiler_coverage(served):
    """The phase taxonomy still covers >= 90% of wall-clock inside steps
    when the loop pipelines — the fence moved to the commit, it must not
    open an unattributed gap; the phases and their counts are the JAX
    async engine's."""
    cfg, params, pcfg, pparams = served
    tel = Telemetry(enabled=True)
    eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=128,
                      block_size=16, packed=True, async_loop=True,
                      telemetry=tel, device="cpu")
    _run(eng, _requests())
    assert eng.async_overlapped_steps > 0
    snap = eng.snapshot()
    assert snap["phases"]["coverage"] >= 0.9
    from repro.serve import Telemetry as JTelemetry
    jeng = JPaged(params, cfg, max_batch=4, max_len=128, block_size=16,
                  packed=True, async_loop=True,
                  telemetry=JTelemetry(enabled=True))
    _run(jeng, _requests(cls=JRequest))
    jph = jeng.snapshot()["phases"]
    assert {n: p["count"] for n, p in snap["phases"]["phases"].items()} == \
        {n: p["count"] for n, p in jph["phases"].items()}
    assert snap["phases"]["steps"] == jph["steps"]


def _count_fences(monkeypatch):
    fences = []
    real = T.device_fence

    def counting(device):
        fences.append(1)
        return real(device)

    monkeypatch.setattr(T, "device_fence", counting)
    return fences


PAGED_PATHS = {
    "packed": dict(packed=True),
    "lockstep": dict(packed=False),
    "async": dict(packed=True, async_loop=True),
    "speculative": dict(packed=True, speculative=True, prefix_sharing=True),
    "robust": dict(packed=True, admission=AdmissionConfig(preemption=True)),
    "hot": dict(packed=True, async_loop=True),
}


@pytest.mark.parametrize("path", sorted(PAGED_PATHS))
def test_paged_unprofiled_steps_issue_no_fence(tiny_cfg, monkeypatch,
                                               path):
    """With telemetry off, no paged step path calls the profiler's device
    fence — it is gated on prof.enabled (host syncs happen only through
    the data dependency on sampled tokens); with telemetry on, the same
    path fences every step. Every path, the int8 pool on the packed
    one, hot sampling on the async one."""
    quant = "int8" if path == "packed" else "none"
    _, _, pcfg, pparams = _models(tiny_cfg, quant)
    temps = (0.9, 0.0) if path == "hot" else None
    for enabled in (False, True):
        eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=128,
                          block_size=16, device="cpu",
                          telemetry=Telemetry(enabled=enabled),
                          **PAGED_PATHS[path])
        for req in _requests(n=6, temps=temps):
            eng.submit(req)
        fences = _count_fences(monkeypatch)
        eng.run()
        if enabled:
            assert len(fences) >= eng.occupancy_steps > 0
        else:
            assert not fences, \
                f"unprofiled path fenced the device {len(fences)} times"


@pytest.mark.parametrize("name", ["continuous", "wave"])
def test_continuous_unprofiled_steps_issue_no_fence(served, monkeypatch,
                                                    name):
    _, _, pcfg, pparams = served
    cls = ContinuousEngine if name == "continuous" else ServeEngine
    for enabled in (False, True):
        eng = cls(pparams, pcfg, max_batch=4, max_len=64, device="cpu",
                  telemetry=Telemetry(enabled=enabled))
        for req in _requests(n=6):
            eng.submit(req)
        fences = _count_fences(monkeypatch)
        eng.run()
        assert bool(fences) == enabled, \
            f"telemetry {enabled}: {len(fences)} device fences"
