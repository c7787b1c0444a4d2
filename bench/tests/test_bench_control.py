"""The precision control: the reference in e4m3 (one step below the
configurations' bf16) put in the program's place. On the CPU, at a small
size, its readings exceed the sound program's threefold; on the card, at
each cell's own size, the program reads within every limit of the cell and
the control over at least one."""
import time

import pytest

from bench import harness, spec
from bench.tests import tiny

BENCH = spec.Bench()
CELLS = [c["name"] for c in BENCH.spec["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_higher_small(cell):
    res, _ = harness.run(BENCH, cell, 23, 1.0, False, "cpu",
                         time.perf_counter(), tiny.sizes(BENCH, cell),
                         control=True)
    prog, low = res["control"]["program"], res["control"]["fp8"]
    assert low["logit_rms"] >= 3 * prog["logit_rms"], (prog, low)
    assert low["logit_err"] >= 3 * prog["logit_err"], (prog, low)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell, card):
    limits = BENCH.cell_settings(cell)["limits"]
    for seed in (901, 902, 903):
        res, _ = harness.run(BENCH, cell, seed, 10.0, False, str(card),
                             time.perf_counter(), control=True)
        prog, low = res["control"]["program"], res["control"]["fp8"]
        assert all(prog[k] <= v for k, v in limits.items()), (prog, limits)
        assert any(low[k] > v for k, v in limits.items()), (low, limits)
