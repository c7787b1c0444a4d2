"""A hybrid run with its Mamba-2 scan broken underneath comes out not
correct: the cell granite-4.0-h-micro.short-chat driven at a small size on
the CPU, with the limits of its cell file. Its main state is each slot's
SSD and conv state in the Mamba-2 layers, beside the attention layers' KV
pool that bench/tests/test_bench_faults.py breaks. The faults: a scan that
writes no slot's state back (every step starts from the state the slot had
before it), and half of the lanes' scan output left out."""
import time

import pytest

from bench import harness, spec
from bench.tests import tiny

from repro_torch.models import ssm

BENCH = spec.Bench()
CELL = "granite-4.0-h-micro.short-chat"


def state_unwritten(monkeypatch):
    scan = ssm.ssd_packed_scan

    def unwritten(zxbcdt, conv_w, conv_b, conv_state, ssm_state, *a, **kw):
        return scan(zxbcdt, conv_w, conv_b, conv_state.clone(),
                    ssm_state.clone(), *a, **kw)
    monkeypatch.setattr(ssm, "ssd_packed_scan", unwritten)


def half_left_out(monkeypatch):
    scan = ssm.ssd_packed_scan

    def half(*a, **kw):
        y = scan(*a, **kw)
        y[1::2] = 0.0
        return y
    monkeypatch.setattr(ssm, "ssd_packed_scan", half)


@pytest.mark.parametrize("fault", [state_unwritten, half_left_out])
def test_scan_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    res, lines = harness.run(BENCH, CELL, 17, 1.0, False, "cpu",
                             time.perf_counter(), tiny.sizes(BENCH, CELL))
    assert res["correct"] is False, res["checks"]
    assert any(c["value"] > c["limit"] for c in res["checks"].values())
    assert len(lines) == len(res["checks"])
