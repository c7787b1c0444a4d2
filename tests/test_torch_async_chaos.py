"""The port's pipelined async loop under chaos and telemetry, twin of
tests/test_async_loop.py (the parity legs are in test_torch_async_loop.py;
the shared substrate in torch_async.py): chaos invariants at commit
boundaries, profiler coverage under overlap, and sync-point hygiene — an
unprofiled step of any paged or continuous path makes no device fence, nor
does a profiled one under the fence-free StepProfiler.

Each engine run is held to the JAX engine on the same weights: under chaos
the same fault schedule and outcomes, under telemetry the same phases and
counts."""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import numpy as np
import pytest

import torch_async as A
from repro.serve import AdmissionConfig as JAdmission
from repro.serve import ChaosMonkey as JChaosMonkey
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro_torch.serve import (AdmissionConfig, ChaosMonkey, ContinuousEngine,
                               PagedEngine, Request, ServeEngine, Telemetry)
from repro_torch.serve import telemetry as T


@pytest.fixture
def served(tiny_cfg):
    return A.models(tiny_cfg)


@pytest.fixture
def served_int8(tiny_cfg):
    return A.models(tiny_cfg, "int8")


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
    cfg, params, pcfg, pparams = A.models(tiny_cfg, quant)
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
    A.run(eng, A.requests())
    assert eng.async_overlapped_steps > 0
    snap = eng.snapshot()
    assert snap["phases"]["coverage"] >= 0.9
    from repro.serve import Telemetry as JTelemetry
    jeng = JPaged(params, cfg, max_batch=4, max_len=128, block_size=16,
                  packed=True, async_loop=True,
                  telemetry=JTelemetry(enabled=True))
    A.run(jeng, A.requests(cls=JRequest))
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
    _, _, pcfg, pparams = A.models(tiny_cfg, quant)
    temps = (0.9, 0.0) if path == "hot" else None
    for enabled in (False, True):
        eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=128,
                          block_size=16, device="cpu",
                          telemetry=Telemetry(enabled=enabled),
                          **PAGED_PATHS[path])
        for req in A.requests(n=6, temps=temps):
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
        for req in A.requests(n=6):
            eng.submit(req)
        fences = _count_fences(monkeypatch)
        eng.run()
        assert bool(fences) == enabled, \
            f"telemetry {enabled}: {len(fences)} device fences"


@pytest.mark.parametrize("path", sorted(PAGED_PATHS) + ["continuous",
                                                        "wave"])
def test_fence_free_profiler_issues_no_fence(tiny_cfg, monkeypatch, path):
    """StepProfiler(fence=False) times every phase of every path with
    telemetry on and never fences the device."""
    quant = "int8" if path == "packed" else "none"
    _, _, pcfg, pparams = A.models(tiny_cfg, quant)
    tel = Telemetry(enabled=True, fence=False)
    if path in PAGED_PATHS:
        eng = PagedEngine(pparams, pcfg, max_batch=4, max_len=128,
                          block_size=16, device="cpu", telemetry=tel,
                          **PAGED_PATHS[path])
    else:
        cls = ContinuousEngine if path == "continuous" else ServeEngine
        eng = cls(pparams, pcfg, max_batch=4, max_len=64, device="cpu",
                  telemetry=tel)
    temps = (0.9, 0.0) if path == "hot" else None
    for req in A.requests(n=6, temps=temps):
        eng.submit(req)
    fences = _count_fences(monkeypatch)
    eng.run()
    assert not fences, f"fence-free profiler fenced {len(fences)} times"
    phases = eng.snapshot()["phases"]
    assert phases["steps"] > 0 and "device" in phases["phases"]
