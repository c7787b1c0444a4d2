"""bench/program_trace.py on synthetic event lists (blocking calls inside
and outside `repro.forward`, nesting put down to the innermost span, idle
gaps split by span, device time launched inside a span, the step stamps
of the requests in the window), and a traced run of a cell on the CPU: it
reports prefill_steps_p95 and leaves forward_wait_ms out (no device
events)."""
import time
from types import SimpleNamespace

import pytest

from bench import harness, program_trace, spec
from bench import tracing as tr
from bench.tests import tiny

# (name, start, end) host ranges and calls of one packed step, in ns
HOST = [
    ("bench.stretch", 0, 1000),
    ("repro.forward", 100, 600),
    ("repro.layer", 110, 300),
    ("repro.attn", 120, 200),
    ("cudaMalloc", 125, 126),
    ("cudaStreamSynchronize", 130, 150),
    ("cudaMemcpyAsync", 140, 141),
    ("repro.mlp", 210, 290),
    ("repro.layer", 310, 500),
    ("repro.attn", 320, 400),
    ("cudaStreamSynchronize", 330, 360),
    ("cudaMemcpy", 505, 508),
    ("repro.lm_head", 510, 590),
    ("repro.sample.wait", 650, 700),
    ("cudaStreamSynchronize", 660, 690),
    ("cudaDeviceSynchronize", 800, 810),
]
# device busy [0, 100], [200, 310], [700, 1000]
KERNELS = [(0, 100), (200, 250), (240, 310), (700, 1000)]


class Event:
    """One raw profiler event, with the accessors the readers call."""

    def __init__(self, name, dev, s, e, corr=0, annotation=False):
        self._v = (name, dev, s, e, corr, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[1] else "DeviceType.CPU"

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def program(host=HOST, kernels=KERNELS, launches=()):
    """A Program read from a profiler holding these events: the host's,
    the device's (with a device-side copy of each range, which is left
    out) and kernels launched at (launch time, start, end)."""
    ev = [Event(n, False, s, e) for n, s, e in host]
    ev += [Event(n, True, s, e, annotation=True) for n, s, e in host
           if n.startswith("repro.")]
    ev += [Event("k", True, s, e) for s, e in kernels]
    for corr, (t, s, e) in enumerate(launches, 1):
        ev.append(Event("cudaLaunchKernel", False, t, t + 1, corr))
        ev.append(Event("k", True, s, e, corr))
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: ev)))
    return program_trace.Program(program_trace.host_events(prof),
                                 tr.Profile(prof))


def test_segments_name_each_piece_by_its_innermost_range():
    ranges = [(s, e, n) for n, s, e in HOST if n.startswith("repro.")]
    assert program_trace.segments(ranges) == [
        (100, 110, "repro.forward"), (110, 120, "repro.layer"),
        (120, 200, "repro.attn"), (200, 210, "repro.layer"),
        (210, 290, "repro.mlp"), (290, 300, "repro.layer"),
        (300, 310, "repro.forward"), (310, 320, "repro.layer"),
        (320, 400, "repro.attn"), (400, 500, "repro.layer"),
        (500, 510, "repro.forward"), (510, 590, "repro.lm_head"),
        (590, 600, "repro.forward"), (650, 700, "repro.sample.wait")]


def test_blocking_calls_inside_and_outside_the_forward():
    p = program()
    assert p.steps == 1
    # 20 + 30 ns in repro.attn, 3 ns of a synchronous copy in the forward
    assert p.forward_wait_ms == pytest.approx(53e-6)
    info = p.info()
    assert info["forward_waits_per_step"] == 3
    assert info["forward_waits_by_span"] == {
        "repro.attn": dict(per_step=2.0, ms_per_step=pytest.approx(50e-6)),
        "repro.forward": dict(per_step=1.0, ms_per_step=pytest.approx(3e-6))}
    assert info["other_waits_by_span"] == {
        "outside": dict(per_step=1.0, ms_per_step=pytest.approx(10e-6)),
        "repro.sample.wait": dict(per_step=1.0,
                                  ms_per_step=pytest.approx(30e-6))}
    assert info["forward_mallocs_per_step"] == 1
    assert set(info["forward_mallocs_by_span"]) == {"repro.attn"}


def test_idle_gaps_split_by_span():
    idle = program().idle_by_span()
    want = {"repro.attn": 160, "repro.layer": 120, "repro.lm_head": 80,
            "outside": 50, "repro.sample.wait": 50, "repro.forward": 30}
    assert idle == {k: pytest.approx(v * 1e-9) for k, v in want.items()}
    assert sum(idle.values()) == pytest.approx(490e-9)


def test_no_device_events_no_wait_and_no_idle():
    p = program(kernels=[])
    assert p.steps == 1
    assert p.forward_wait_ms is None
    assert p.idle_by_span() == {}
    # a program without spans: nothing to read
    bare = [h for h in HOST if not h[0].startswith("repro.")]
    assert program(bare).forward_wait_ms is None


def test_moe_route_share_from_launches():
    host = [("repro.moe", 100, 200), ("repro.moe.route", 110, 130)]
    p = program(host, [], launches=[
        (115, 300, 340), (150, 340, 400), (250, 400, 500)])
    assert p.launched_s("repro.moe") == pytest.approx(100e-9)
    assert p.launched_s("repro.moe.route") == pytest.approx(40e-9)
    assert p.info()["moe_route_share"] == pytest.approx(40.0)


def test_prefill_steps_of_the_requests_in_the_window():
    def req(admit, first, failed=False):
        return SimpleNamespace(admit_step=admit, first_token_step=first,
                               failed=failed)
    reqs = [(1.0, req(0, 2)), (2.0, req(3, 3)), (2.5, req(4, 9)),
            (0.5, req(0, 30)), (3.5, req(0, 40)), (None, req(5, None)),
            (2.0, req(1, 50, failed=True))]
    p = program_trace.Program(requests=reqs, window=(1.0, 3.0))
    assert sorted(p.prefill) == [1, 3, 6]
    assert p.prefill_steps_p95 == pytest.approx(5.7)
    # a program that stamps no steps
    bare = [(1.0, SimpleNamespace(failed=False))]
    assert program_trace.Program(requests=bare,
                                 window=(0, 2)).prefill_steps_p95 is None


def test_outside_a_run_there_is_nothing_to_read():
    ctx = SimpleNamespace(host=dict(steps=0), stretch_steps=[])
    assert program_trace.of(ctx) is None


def test_traced_run_reports_prefill_steps_not_forward_wait(monkeypatch):
    monkeypatch.setattr(harness, "STRETCH_S", 0.3)
    bench = spec.Bench()
    cell = bench.spec["workloads"][0]["name"]
    res, _ = harness.run(bench, cell, 2 ** 31 + 7, 1.5, True, "cpu",
                         time.perf_counter(), tiny.sizes(bench, cell))
    assert res["correct"] is True
    metrics = res["metrics"]
    assert metrics["prefill_steps_p95"]["value"] >= 1
    assert metrics["prefill_steps_p95"]["unit"] == "steps"
    assert "forward_wait_ms" not in metrics
