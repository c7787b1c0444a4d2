"""The program's spans (`repro_torch/spans.py`, re-exported by
serve/telemetry.py) and the paged engine's per-request step stamps.

With no profiler recording a packed step opens no range and takes no
fence; under a CPU torch.profiler one packed step nests repro.forward >
repro.layer (one a layer) > repro.attn and repro.mlp (repro.moe >
repro.moe.route), then repro.sample.wait; greedy tokens do not depend on
the profiler; admit_step and first_token_step follow a hand count of a
budget-bound packed schedule. The fence-free StepProfiler takes no fence
and marks its phases as `phase.<name>` ranges. About 10 s in one
process."""
import torch_threads  # noqa: F401  (first: one torch thread a worker)

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import PagedEngine, Request
from repro_torch.serve import telemetry as T

FAMILIES = {
    "dense": dict(family="dense"),
    "moe": dict(family="moe", num_experts=4, experts_per_token=2,
                moe_capacity_factor=2.0),
}


def _engine(family="dense", **kw):
    cfg = ModelConfig(name="t", num_layers=2, d_model=64, num_heads=4,
                      num_kv_heads=2, d_ff=128, vocab_size=256,
                      vocab_pad_multiple=1, attention_prob="hccs",
                      hccs_mode="wide", decode_kernel="fused",
                      **FAMILIES[family])
    params = M.init_params(cfg, seed=0, device="cpu")
    opts = dict(max_batch=2, max_len=64, block_size=8, device="cpu")
    opts.update(kw)
    return PagedEngine(params, cfg, packed=True, **opts)


def _requests(lengths=(11, 5), new=3):
    rng = np.random.default_rng(3)
    return [Request(uid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=new) for i, n in enumerate(lengths)]


def _ranges(prof):
    """The repro.* ranges of a profile as (start, end, name), by start."""
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.name().startswith("repro."))


def _children(ranges, parent):
    """The ranges directly inside `parent`, in order."""
    s0, e0, _ = parent
    inside = [r for r in ranges if s0 <= r[0] and r[1] <= e0
              and r != parent]
    return [r for r in inside
            if not any(o != r and o[0] <= r[0] and r[1] <= o[1]
                       for o in inside)]


def test_span_is_the_null_context_when_no_profiler_records():
    assert T.span is spans.span
    assert spans.span("repro.forward") is spans.NULL is T._NULL
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        assert spans.span("repro.forward") is not spans.NULL
    assert spans.span("repro.forward") is spans.NULL


def test_unprofiled_packed_step_opens_no_range_and_takes_no_fence(
        monkeypatch):
    opened, fences = [], []
    real = torch.profiler.record_function

    def counting(name, *a, **kw):
        opened.append(name)
        return real(name, *a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(T, "device_fence", lambda device: fences.append(1))
    eng = _engine()
    for req in _requests():
        eng.submit(req)
    eng.run()
    assert eng.occupancy_steps > 0
    assert opened == [] and fences == []


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_profiled_packed_step_nests_the_spans(family):
    eng = _engine(family)
    for req in _requests():
        eng.submit(req)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.step()
    ranges = _ranges(prof)
    top = [r for r in ranges if not any(
        o != r and o[0] <= r[0] and r[1] <= o[1] for o in ranges)]
    assert [r[2] for r in top] == ["repro.forward", "repro.sample.wait"]
    forward = _children(ranges, top[0])
    assert [r[2] for r in forward] == ["repro.layer"] * 2 + ["repro.lm_head"]
    ffn = "repro.moe" if family == "moe" else "repro.mlp"
    for layer in forward[:2]:
        parts = _children(ranges, layer)
        assert [r[2] for r in parts] == ["repro.attn", ffn]
        inner = [r[2] for r in _children(ranges, parts[1])]
        assert inner == (["repro.moe.route"] if family == "moe" else [])


def test_greedy_tokens_identical_with_the_profiler_on_and_off():
    outs = []
    for profiled in (False, True):
        eng = _engine()
        reqs = _requests(lengths=(11, 5, 17, 3), new=4)
        for req in reqs:
            eng.submit(req)
        if profiled:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]):
                eng.run()
        else:
            eng.run()
        outs.append({r.uid: list(r.out_tokens) for r in reqs})
    assert outs[0] == outs[1]
    assert all(len(t) == 4 for t in outs[0].values())


@pytest.mark.parametrize("async_loop,third", [(False, (4, 4)),
                                              (True, (5, 5))])
def test_step_stamps_follow_a_hand_count(async_loop, third):
    """Two slots and an 8-lane budget: slot 0 (20 prompt tokens) takes 7
    lanes a step, slot 1 (5 tokens) trickles at one lane a step until slot
    0's prompt is done. Steps 0-based from the engine's first:
      step 0: uid 0 7 lanes, uid 1 1         (both admitted before it)
      step 1: uid 0 7, uid 1 1
      step 2: uid 0 6 (its last: first token), uid 1 2
      step 3: uid 0 decodes (its 2nd token: finished), uid 1 1 (first)
      step 4: uid 2 admitted into slot 0, its 3-token prompt whole (first)
    so prefill steps (first - admit + 1) are 3, 4 and 1. The async loop
    commits step 3 while step 4 runs, so it frees slot 0 a step later and
    uid 2 is admitted before step 5."""
    eng = _engine(token_budget=8, async_loop=async_loop)
    rng = np.random.default_rng(5)
    reqs = [Request(uid=i, prompt=rng.integers(0, 256, n).astype(np.int32),
                    max_new_tokens=new)
            for i, (n, new) in enumerate([(20, 2), (5, 6), (3, 2)])]
    for req in reqs:
        eng.submit(req)
    eng.run()
    assert [(r.admit_step, r.first_token_step) for r in reqs] == \
        [(0, 2), (0, 3), third]
    assert all(r.done for r in reqs)


def test_fence_free_profiler_takes_no_fence_and_marks_phases(monkeypatch):
    fences = []
    monkeypatch.setattr(T, "device_fence", lambda device: fences.append(1))
    eng = _engine(telemetry=T.Telemetry(enabled=True, fence=False))
    for req in _requests():
        eng.submit(req)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.run()
    assert fences == []
    summary = eng.snapshot()["phases"]
    assert summary["steps"] > 0 and summary["coverage"] >= 0.9
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"phase." + n for n in summary["phases"]} <= names
    assert "phase.device" in names
