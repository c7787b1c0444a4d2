"""The port's chaos harness (repro_torch/serve/chaos.py), twin of
tests/test_chaos.py: the seeded fault injector drives a robust paged engine
through arrival bursts, hand-driven allocator exhaustion, mid-flight
cancels, preemption storms, device-step failures and NaN logits, with the
block-accounting invariants after every step and a fully reclaimed pool at
the end; on the fixed packed x sharing x int8 legs (lockstep included), and
with speculative decoding.

The port's monkey and the JAX monkey, on the same seed, weights and
request maker, must report the same step count, the same faults by kind,
and the same finished and failed uids (with the same tokens and reasons):
the fault schedule is a pure function of the seed and the engine's host
state, which the port copies.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import dataclasses

import jax
import numpy as np
import pytest

from repro.models import model as JM
from repro.serve import AdmissionConfig as JAdmissionConfig
from repro.serve import ChaosMonkey as JChaosMonkey
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import (AdmissionConfig, ChaosMonkey, PagedEngine,
                               Request, assert_drained, check_invariants)

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


def _maker(seed=7, vocab=256, cls=Request):
    rng = np.random.default_rng(seed)

    def mk(i):
        plen = int(rng.integers(4, 24))
        return cls(uid=i,
                   prompt=rng.integers(0, vocab, plen).astype(np.int32),
                   max_new_tokens=int(rng.integers(2, 10)),
                   priority=int(rng.integers(0, 3)))

    return mk


LEG_KW = dict(max_batch=3, max_len=64, block_size=8, num_blocks=14)


def _admission(mod_cfg=AdmissionConfig):
    return mod_cfg(max_queue=8, backpressure="shed-lowest-priority",
                   preemption=True)


@pytest.mark.parametrize("packed,sharing,quant", [
    (True, True, "none"),            # the default serving leg
    (False, False, "none"),          # lockstep, no trie
    (True, False, "int8"),           # quantized pool, packed
    (True, True, "int8"),            # quantized + sharing (COW on int8)
])
def test_chaos_smoke_fixed_legs(tiny_cfg, packed, sharing, quant):
    """Every seeded chaos run passes the invariant checker at every step
    and drains the pool to empty."""
    _, _, pcfg, pparams = _models(tiny_cfg, quant)
    eng = PagedEngine(pparams, pcfg, prefix_sharing=sharing, packed=packed,
                      admission=_admission(), device="cpu", **LEG_KW)
    report = ChaosMonkey(eng, seed=0, make_request=_maker(),
                         n_requests=12, max_steps=1500).run()
    assert report["submitted"] == 12
    assert sum(report["faults"].values()) > 0, "no fault ever injected"
    assert report["finished"], "chaos killed every single request"
    rb = report["robustness"]
    assert rb["cancelled"] == len(
        [r for r in report["failed"] if r.fail_reason == "cancelled"])


def _outcome(rep):
    return (rep["steps"], rep["submitted"], rep["faults"],
            sorted((r.uid, tuple(int(t) for t in r.out_tokens))
                   for r in rep["finished"]),
            sorted((r.uid, r.fail_reason) for r in rep["failed"]),
            rep["robustness"])


def test_chaos_seed_reproducible(tiny_cfg):
    """Same (seed, engine config) => same fault schedule and the same
    terminal outcome for every request."""
    _, _, pcfg, pparams = _models(tiny_cfg)
    outcomes = []
    for _ in range(2):
        eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64,
                          block_size=8, num_blocks=12, prefix_sharing=True,
                          packed=True, device="cpu",
                          admission=AdmissionConfig(preemption=True))
        rep = ChaosMonkey(eng, seed=3, make_request=_maker(),
                          n_requests=10, max_steps=1500).run()
        outcomes.append(_outcome(rep))
    assert outcomes[0] == outcomes[1]


def test_chaos_requires_robust_engine(tiny_cfg):
    _, _, pcfg, pparams = _models(tiny_cfg)
    eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=8,
                      device="cpu")
    with pytest.raises(ValueError, match="robust"):
        ChaosMonkey(eng, seed=0, make_request=_maker())


def test_chaos_restores_step_fns(tiny_cfg):
    """After run() the engine's device seams are unwrapped: a later clean
    run sees no injected faults."""
    _, _, pcfg, pparams = _models(tiny_cfg)
    eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=8,
                      num_blocks=12, prefix_sharing=True, packed=True,
                      device="cpu",
                      admission=AdmissionConfig(preemption=True))
    seams = {n: getattr(eng, n)
             for n in ("_step_fn", "_packed_fn", "_packed_spec_fn")}
    monkey = ChaosMonkey(eng, seed=1, make_request=_maker(), n_requests=6,
                         max_steps=1500)
    wrapped = eng._packed_fn
    assert all(getattr(eng, n) is not f for n, f in seams.items())
    monkey.run()
    assert eng._packed_fn is not wrapped
    assert all(getattr(eng, n) == f for n, f in seams.items())
    rng = np.random.default_rng(9)
    req = Request(uid=99, prompt=rng.integers(0, 256, 9).astype(np.int32),
                  max_new_tokens=4)
    eng.submit(req)
    done = eng.run()
    assert len(done) == 1 and done[0].done and not done[0].failed
    assert_drained(eng)


@pytest.mark.parametrize("packed,sharing,quant,spec", [
    (True, True, "none", False),
    (False, False, "none", False),
    (True, True, "int8", True),
], ids=["packed-sharing", "lockstep", "int8-sharing-speculative"])
def test_chaos_report_matches_jax_monkey(tiny_cfg, packed, sharing, quant,
                                         spec):
    """The port's monkey and the JAX monkey on seed 0, the same weights and
    requests: the same steps, faults by kind, finished uids with their
    tokens, failed uids with their reasons, and robustness counters."""
    cfg, params, pcfg, pparams = _models(tiny_cfg, quant)
    kw = dict(LEG_KW, prefix_sharing=sharing, decode_sharing=sharing,
              packed=packed, speculative=spec)
    jeng = JPaged(params, cfg, admission=_admission(JAdmissionConfig), **kw)
    peng = PagedEngine(pparams, pcfg, admission=_admission(), device="cpu",
                       **kw)
    want = JChaosMonkey(jeng, seed=0, make_request=_maker(cls=JRequest),
                        n_requests=12, max_steps=1500).run()
    got = ChaosMonkey(peng, seed=0, make_request=_maker(), n_requests=12,
                      max_steps=1500).run()
    assert _outcome(got) == _outcome(want)
    assert sum(got["faults"].values()) > 0 and got["finished"]
    if spec:
        assert peng.spec_steps == jeng.spec_steps > 0
    check_invariants(peng)


@pytest.mark.parametrize("where", ["before-seam", "inside-seam"])
def test_device_fault_retried_only_before_the_seam(tiny_cfg, monkeypatch,
                                                   where):
    """A fault raised before a device seam runs leaves the in-place pools
    untouched: the robust engine retries it, and past max_device_retries
    fails every live slot with "device_error". A fault raised inside the
    seam's forward may have written the pools part way: it is neither
    retried nor absorbed, and propagates out of step()."""
    _, _, pcfg, pparams = _models(tiny_cfg)
    eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=8,
                      num_blocks=12, packed=True, device="cpu",
                      admission=AdmissionConfig(preemption=True))
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, 6).astype(np.int32),
                    max_new_tokens=6) for i in range(2)]
    for r in reqs:
        eng.submit(r)
    eng.step()
    rc, budget = eng.robust_counters, eng._adm.max_device_retries
    n_tokens = [len(r.out_tokens) for r in reqs]
    if where == "inside-seam":
        def broken(*args, **kw):
            raise RuntimeError("inside the forward")
        monkeypatch.setattr(M, "forward", broken)
        with pytest.raises(RuntimeError, match="inside the forward"):
            eng.step()
        assert rc.device_retries == 0
        assert not any(r.failed for r in reqs)
        return
    seam, fails = eng._packed_fn, [budget]

    def flaky(*args):
        if fails[0] > 0:
            fails[0] -= 1
            raise RuntimeError("transient")
        return seam(*args)
    eng._packed_fn = flaky
    eng.step()                       # budget failures, then the real call
    assert rc.device_retries == budget
    assert [len(r.out_tokens) for r in reqs] == [n + 1 for n in n_tokens]
    fails[0] = budget + 1
    failed = eng.step()
    assert rc.device_retries == 2 * budget + 1
    assert sorted(r.uid for r in failed) == [0, 1]
    assert all(r.fail_reason == "device_error" for r in failed)
    assert_drained(eng)
