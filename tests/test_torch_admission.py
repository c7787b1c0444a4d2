"""The port's overload-robustness layer (repro_torch/serve/admission.py and
the robust paths of the paged and continuous engines) against the JAX
package's.

(a) AdmissionQueue, choose_victim, RobustnessCounters and AdmissionConfig
    against the JAX module on the same seeded operation sequences: the same
    heads, sheds, expiries, victims and snapshots.
(b) Twins of tests/test_serve_engine.py's robustness cases (:530, :581):
    random interleavings of preemption, cancellation, clock jumps and late
    submissions, with the chaos invariants after every step, run in step
    with the JAX engine (the same tables and free lists after every step);
    and a hand-driven BlockPoolExhausted rolled back byte-identically.
(c) Preempted requests finish with the tokens of a never-preempted run, and
    robust_counters.snapshot() equals the JAX engine's under a fake clock,
    for the paged and the continuous engine.

Every gate is exact: tokens, counters, tables and free lists.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import copy
import dataclasses

import jax
import numpy as np
import pytest

from repro.models import model as JM
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import admission as jadm
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import (AdmissionConfig, AdmissionQueue,
                               ContinuousEngine, PagedEngine, QueueFull,
                               Request, RobustnessCounters, assert_drained,
                               check_invariants, choose_victim)
from repro_torch.serve import admission as padm
from repro_torch.serve.paged import BlockPoolExhausted

_MODELS: dict = {}


@pytest.fixture
def served(tiny_cfg):
    """The JAX config and params and the port's twins (f32, tiny)."""
    if not _MODELS:
        cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div")
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device="cpu")
        _MODELS.update(cfg=cfg, params=params, pcfg=pcfg, pparams=pparams)
    return (_MODELS["cfg"], _MODELS["params"], _MODELS["pcfg"],
            _MODELS["pparams"])


def _pair(served, **kw):
    """The same engine in both packages."""
    cfg, params, pcfg, pparams = served
    return JPaged(params, cfg, **kw), PagedEngine(pparams, pcfg,
                                                  device="cpu", **kw)


def _twins(make, n):
    """n requests as (JAX, port) pairs with equal fields."""
    out = []
    for i in range(n):
        kw = make(i)
        out.append((JRequest(**copy.deepcopy(kw)), Request(**kw)))
    return out


def _assert_same_state(jeng, peng):
    np.testing.assert_array_equal(peng._tables, jeng._tables)
    assert list(peng.alloc._free) == list(jeng.alloc._free)
    assert peng.alloc._ref == jeng.alloc._ref
    np.testing.assert_array_equal(peng._resv, jeng._resv)
    np.testing.assert_array_equal(peng._lengths, jeng._lengths)
    assert [r.uid for r in peng._queue] == [r.uid for r in jeng._queue]


# ------------------------------------------------------------------- (a) --

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("backpressure", ["reject", "shed-lowest-priority"])
def test_admission_queue_matches_jax(seed, backpressure):
    """Seeded pushes, requeues, pops, removals and expiries on a bounded
    queue: every return value and the queue order equal the JAX queue's."""
    rng = np.random.default_rng(seed)
    cap = int(rng.integers(0, 6))
    queues = [mod.AdmissionQueue(mod.AdmissionConfig(
        max_queue=cap or None, backpressure=backpressure))
        for mod in (jadm, padm)]
    reqs = {}
    for step in range(120):
        op = rng.random()
        now = float(step)
        outs = [[], []]
        for q, cls, out in zip(queues, (JRequest, Request), outs):
            r = np.random.default_rng([seed, step])     # same draws for both
            if op < 0.45:
                uid = step
                req = cls(uid=uid, prompt=np.zeros(2, np.int32),
                          priority=int(r.integers(0, 3)),
                          deadline_ttft=(float(r.integers(3, 30))
                                         if r.random() < 0.3 else None),
                          deadline_e2e=(float(r.integers(5, 40))
                                        if r.random() < 0.3 else None))
                reqs.setdefault(uid, []).append(req)
                try:
                    out.append(("shed", [v.uid for v in
                                          q.push(req, now=now)]))
                except (jadm.QueueFull, padm.QueueFull) as e:
                    out.append(("full", type(e).__name__))
            elif op < 0.6 and q:
                e = q.pop_head()
                out.append(("pop", e.req.uid, e.seq, e.submit_ts))
                if r.random() < 0.5:
                    q.requeue(e.req, seq=e.seq, submit_ts=e.submit_ts)
            elif op < 0.75:
                uid = int(r.integers(0, step + 1))
                got = q.remove(uid)
                out.append(("remove", None if got is None else got.uid))
            elif op < 0.9:
                out.append(("expire", [(x.uid, why)
                                        for x, why in q.expire(now)]))
            out.append(("order", [x.uid for x in q], len(q), bool(q)))
        assert outs[0] == outs[1], step


@pytest.mark.parametrize("seed", range(4))
def test_choose_victim_matches_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(200):
        b = int(rng.integers(1, 9))
        live = np.flatnonzero(rng.random(b) < 0.6)
        prio = rng.integers(0, 4, b)
        seq = rng.permutation(b * 3)[:b]
        below = None if rng.random() < 0.3 else int(rng.integers(0, 5))
        assert choose_victim(live, prio, seq, below=below) == \
            jadm.choose_victim(live, prio, seq, below=below)


def test_robustness_counters_snapshot_matches_jax():
    rng = np.random.default_rng(0)
    counters = [jadm.RobustnessCounters(), RobustnessCounters()]
    fields = ("preemptions", "exhaustion_events", "device_retries",
              "cancelled", "shed", "rejected", "deadline_miss_ttft",
              "deadline_miss_e2e", "reprefill_tokens", "reprefill_skipped")
    for _ in range(300):
        name = fields[int(rng.integers(len(fields)))]
        klass = int(rng.integers(0, 3))
        key = jadm._CLASS_KEYS[int(rng.integers(len(jadm._CLASS_KEYS)))]
        n = int(rng.integers(1, 5))
        for c in counters:
            setattr(c, name, getattr(c, name) + n)
            c.klass(klass)[key] += 1
    assert counters[1].snapshot() == counters[0].snapshot()
    assert padm._CLASS_KEYS == jadm._CLASS_KEYS


@pytest.mark.parametrize("kw", [
    dict(backpressure="x"), dict(max_queue=-1), dict(max_queue=3),
    dict(backpressure="shed-lowest-priority", preemption=False)])
def test_admission_config_and_as_admission_match_jax(kw, tiny_cfg):
    errs = []
    for mod in (jadm, padm):
        try:
            errs.append(dataclasses.asdict(mod.AdmissionConfig(**kw)))
        except ValueError as e:
            errs.append(str(e))
    assert errs[0] == errs[1]
    cfg = tiny_cfg(cache_layout="paged", queue_limit=4, preemption=True,
                   backpressure="shed-lowest-priority")
    pcfg = ModelConfig(**dataclasses.asdict(cfg))
    want, got = jadm.as_admission(None, cfg), padm.as_admission(None, pcfg)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert padm.as_admission(None, pcfg.replace(
        queue_limit=0, preemption=False)) is None
    assert padm.as_admission(True) == AdmissionConfig()


def test_reject_backpressure_raises_before_touching_state(served):
    """QueueFull leaves the engine (and the session) untouched."""
    _, peng = _pair(served, max_batch=2, max_len=64, block_size=8,
                    admission=AdmissionConfig(max_queue=1))
    peng.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32)),
                session="a")
    with pytest.raises(QueueFull):
        peng.submit(Request(uid=1, prompt=np.arange(5, dtype=np.int32)),
                    session="b")
    assert len(peng._queue) == 1 and "b" not in peng._session_busy
    snap = peng.robust_counters.snapshot()
    assert snap["rejected"] == 1 and snap["per_class"]["0"]["submitted"] == 2
    assert isinstance(peng._queue, AdmissionQueue)


# ------------------------------------------------------------------- (b) --

def test_robust_block_churn_random_interleavings(served):
    """A robust engine (priorities, deadlines on a fake clock, preemption,
    decode sharing) stepped while a seeded adversary interleaves
    preemptions, cancels, clock jumps and late submissions; the JAX engine
    takes the same actions in step. After every step: the chaos
    invariants, and the same tables, free list, refcounts and queue. At the
    end every request is terminal with the same outcome, and the pool
    drains."""
    fake = [0.0]
    kw = dict(max_batch=2, max_len=64, block_size=8, num_blocks=12,
              prefix_sharing=True, decode_sharing=True,
              admission=AdmissionConfig(preemption=True,
                                        clock=lambda: fake[0]))
    cfg, params, pcfg, pparams = served
    jeng = JPaged(params, cfg, **dict(kw, admission=jadm.AdmissionConfig(
        preemption=True, clock=lambda: fake[0])))
    peng = PagedEngine(pparams, pcfg, device="cpu", **kw)
    rng = np.random.default_rng(0)

    def make(i):
        r = dict(uid=i, prompt=rng.integers(
            0, 256, int(rng.choice([9, 13, 21]))).astype(np.int32),
            max_new_tokens=int(rng.choice([4, 8])),
            priority=int(rng.integers(0, 3)))
        if i % 4 == 0:
            r["deadline_e2e"] = 4.0
        if i % 4 == 2:
            r["deadline_ttft"] = 30.0
        return r

    reqs = _twins(make, 12)
    i = steps = 0
    while i < len(reqs) or peng.busy:
        if i < len(reqs) and rng.random() < 0.6:
            jeng.submit(reqs[i][0])
            peng.submit(reqs[i][1])
            i += 1
        act = rng.random()
        if act < 0.15:
            live = np.flatnonzero(peng._live)
            if len(live):
                s = int(rng.choice(live))
                jeng._preempt_slot(s)
                peng._preempt_slot(s)
        elif act < 0.30:
            uid = int(rng.integers(0, len(reqs)))
            assert peng.cancel(uid) == jeng.cancel(uid)
        elif act < 0.40:
            fake[0] += 3.0
        jeng.step()
        peng.step()
        fake[0] += 0.1
        check_invariants(peng)
        _assert_same_state(jeng, peng)
        steps += 1
        assert steps < 2000, "churn run did not converge"
    assert not jeng.busy
    for jr, pr in reqs:
        assert pr.done or pr.failed
        assert (pr.done, pr.failed, pr.fail_reason, pr.out_tokens,
                pr.preemptions) == (jr.done, jr.failed, jr.fail_reason,
                                    [int(t) for t in jr.out_tokens],
                                    jr.preemptions)
    assert peng.robust_counters.preemptions > 0
    assert peng.robust_counters.snapshot() == \
        jeng.robust_counters.snapshot()
    assert_drained(peng)


@pytest.mark.parametrize("packed", [False, True])
def test_exhaustion_rollback_byte_identical(served, packed):
    """Blocks stolen straight from the pool make a non-robust engine's next
    frontier-crossing growth raise out of step(): the journal rolls the
    step back to a byte-identical engine (free list ORDER, refcounts,
    tables, reservations, lengths, queue, trie); after the blocks come back
    the run finishes with the tokens of an uncontended run."""
    rng = np.random.default_rng(0)
    reqs = [(i, rng.integers(0, 256, 13).astype(np.int32)) for i in range(2)]
    _, ref_eng = _pair(served, max_batch=2, max_len=64, block_size=8,
                       packed=packed)
    for uid, p in reqs:
        ref_eng.submit(Request(uid=uid, prompt=p.copy(), max_new_tokens=12))
    ref_out = {r.uid: r.out_tokens for r in ref_eng.run()}
    _, eng = _pair(served, max_batch=2, max_len=64, block_size=8,
                   num_blocks=9, packed=packed)

    def snap(e):
        return (list(e.alloc._free), dict(e.alloc._ref),
                e._tables.tolist(), e._resv.tolist(), e._lengths.tolist(),
                [r.uid for r in e._queue],
                sorted(int(b) for b in e.trie.blocks()))

    work = [Request(uid=uid, prompt=p.copy(), max_new_tokens=12)
            for uid, p in reqs]
    for r in work:
        eng.submit(r)
    while not eng._live.any():
        eng.step()
    for _ in range(2):
        eng.step()
    stolen = [eng.alloc.alloc() for _ in range(eng.alloc.num_free)]
    raised = False
    done = []
    while eng.busy and not raised:
        before = snap(eng)
        try:
            done.extend(eng.step())
        except BlockPoolExhausted:
            raised = True
            assert snap(eng) == before   # the rollback contract
    assert raised, "steal never forced a boundary crossing"
    assert all(not r.failed for r in work)
    eng.alloc.free(stolen)
    done.extend(eng.run())
    assert {r.uid: r.out_tokens for r in done} == ref_out


# ------------------------------------------------------------------- (c) --

def _overload_requests(seed, n=10, deadline=6.0, every=5):
    rng = np.random.default_rng(seed)

    def make(i):
        return dict(uid=i, prompt=rng.integers(
            0, 256, int(rng.integers(9, 30))).astype(np.int32),
            max_new_tokens=int(rng.integers(6, 14)),
            priority=int(rng.integers(0, 3)),
            deadline_e2e=(deadline if i % every == 3 % every else None))
    return make, n


@pytest.mark.parametrize("sharing", [False, True])
def test_paged_preemption_matches_jax_and_never_preempted(served, sharing):
    """A pool small enough that higher classes preempt lower ones, arrivals
    spread over the run, deadlines on a fake clock: the port and the JAX
    engine in step give the same tokens, failures, tables, free lists and
    robust_counters.snapshot(); every preempted request that finishes has
    the tokens of a never-preempted run."""
    fake = [0.0]
    kw = dict(max_batch=3, max_len=64, block_size=8, num_blocks=11,
              prefix_sharing=sharing, decode_sharing=sharing)
    cfg, params, pcfg, pparams = served
    jeng = JPaged(params, cfg, admission=jadm.AdmissionConfig(
        preemption=True, clock=lambda: fake[0]), **kw)
    peng = PagedEngine(pparams, pcfg, device="cpu",
                       admission=AdmissionConfig(preemption=True,
                                                 clock=lambda: fake[0]),
                       **kw)
    make, n = _overload_requests(1)
    reqs = _twins(make, n)
    i = 0
    while i < n or peng.busy:
        if i < n and (i < 3 or fake[0] >= 0.5 * i):
            jeng.submit(reqs[i][0])
            peng.submit(reqs[i][1])
            i += 1
        jeng.step()
        peng.step()
        fake[0] += 0.25
        check_invariants(peng)
        _assert_same_state(jeng, peng)
    snap = peng.robust_counters.snapshot()
    assert snap == jeng.robust_counters.snapshot()
    assert snap["preemptions"] > 0 and snap["deadline_misses"]["total"] > 0
    for jr, pr in reqs:
        assert (pr.done, pr.failed, pr.fail_reason, pr.out_tokens) == (
            jr.done, jr.failed, jr.fail_reason,
            [int(t) for t in jr.out_tokens])
    plain = PagedEngine(pparams, pcfg, device="cpu", max_batch=3, max_len=64,
                        block_size=8)
    for _, pr in reqs:
        plain.submit(Request(uid=pr.uid, prompt=pr.prompt.copy(),
                             max_new_tokens=pr.max_new_tokens))
    alone = {r.uid: r.out_tokens for r in plain.run()}
    preempted = [pr for _, pr in reqs if pr.preemptions and pr.done]
    assert preempted
    for pr in (pr for _, pr in reqs if pr.done):
        assert pr.out_tokens == alone[pr.uid]
    assert_drained(peng)


@pytest.mark.parametrize("backpressure", ["reject", "shed-lowest-priority"])
def test_continuous_robust_matches_jax(served, backpressure):
    """The continuous engine's bounded queue, backpressure and deadlines on
    a fake clock: the same tokens, failures and robust_counters.snapshot()
    as the JAX engine, and finished requests equal a plain run's."""
    fake = [0.0]
    cfg, params, pcfg, pparams = served
    jeng = JContinuous(params, cfg, max_batch=2, max_len=64,
                       admission=jadm.AdmissionConfig(
                           max_queue=3, backpressure=backpressure,
                           clock=lambda: fake[0]))
    peng = ContinuousEngine(pparams, pcfg, max_batch=2, max_len=64,
                            device="cpu", admission=AdmissionConfig(
                                max_queue=3, backpressure=backpressure,
                                clock=lambda: fake[0]))
    make, n = _overload_requests(2, n=12, deadline=3.0, every=2)
    reqs = _twins(make, n)
    i = 0
    while i < n or peng.busy:
        while i < n and (i < 4 or fake[0] >= 0.3 * i):
            outcome = []
            for eng, r in zip((jeng, peng), reqs[i]):
                try:
                    eng.submit(r)
                    outcome.append("queued")
                except (jadm.QueueFull, QueueFull):
                    outcome.append("rejected")
            assert outcome[0] == outcome[1]
            i += 1
        jeng.step()
        peng.step()
        fake[0] += 0.5
        assert [r.uid for r in peng._queue] == [r.uid for r in jeng._queue]
    assert not jeng.busy
    snap = peng.robust_counters.snapshot()
    assert snap == jeng.robust_counters.snapshot()
    assert snap["shed"] + snap["rejected"] > 0
    assert snap["deadline_misses"]["total"] > 0
    for jr, pr in reqs:
        assert (pr.done, pr.failed, pr.fail_reason, pr.out_tokens) == (
            jr.done, jr.failed, jr.fail_reason,
            [int(t) for t in jr.out_tokens])
    plain = ContinuousEngine(pparams, pcfg, max_batch=2, max_len=64,
                             device="cpu")
    for _, pr in reqs:
        plain.submit(Request(uid=pr.uid, prompt=pr.prompt.copy(),
                             max_new_tokens=pr.max_new_tokens))
    alone = {r.uid: r.out_tokens for r in plain.run()}
    for pr in (pr for _, pr in reqs if pr.done):
        assert pr.out_tokens == alone[pr.uid]
