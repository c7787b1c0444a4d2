"""A run with the timed path broken underneath comes out not correct: the
harness's look for a chip skipped, each cell driven at a small size on the
CPU, with the limits of its cell file. The faults a served cell can have:
a step that leaves its state (the KV pool) unchanged, half of the lanes'
attention left out, and tokens altered where they are produced. (A one-chip
cell has no exchange between chips to leave out.)"""
import time

import pytest

from bench import harness, spec
from bench.tests import tiny

from repro_torch.models import attention
from repro_torch.serve import paged

BENCH = spec.Bench()
CELLS = [c["name"] for c in BENCH.spec["workloads"]]


def state_unchanged(monkeypatch):
    monkeypatch.setattr(attention, "_paged_scatter",
                        lambda pool, new_kv, write_pos: pool)


def half_left_out(monkeypatch):
    packed = attention.hccs_packed_prefill

    def half(*a, **kw):
        out = packed(*a, **kw)
        out[1::2] = 0.0
        return out
    monkeypatch.setattr(attention, "hccs_packed_prefill", half)


def tokens_altered(monkeypatch):
    """Every slot's token of every third step is the next id."""
    sample = paged.sample_tokens
    calls = []

    def altered(*a, **kw):
        out = sample(*a, **kw)
        calls.append(1)
        if len(calls) % 3 == 0:
            out = (out + 1) % 300
        return out
    monkeypatch.setattr(paged, "sample_tokens", altered)


@pytest.mark.parametrize("fault", [state_unchanged, half_left_out,
                                   tokens_altered])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res, lines = harness.run(BENCH, cell, 17, 1.0, False, "cpu",
                             time.perf_counter(), tiny.sizes(BENCH, cell))
    assert res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    assert len(lines) == len(res["checks"])
