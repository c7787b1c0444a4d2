"""The port's serving telemetry (repro_torch/serve/telemetry.py), twin of
tests/test_telemetry.py: percentile math against numpy, the registry's
lifecycle hooks, Chrome-trace JSONL validity, telemetry on/off greedy
parity on all three engines, snapshot schema stability, phase coverage,
drive_open_loop and the one serving clock.

Each engine test also runs the JAX engine on the same weights (the numpy
bridge) and holds the port to it: the same tokens, the same step count,
the same phases entered the same number of times, the same snapshot keys
and the same counters (everything but wall-clock times); the registry and
profiler, fed one fake clock, give the JAX package's numbers exactly."""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import copy
import dataclasses
import json

import jax
import numpy as np
import pytest

from repro.models import model as JM
from repro.serve import AdmissionConfig as JAdmission
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import MetricsRegistry as JRegistry
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServe
from repro.serve import StepProfiler as JProfiler
from repro.serve import Telemetry as JTelemetry
from repro.serve import drive_open_loop as jax_drive_open_loop
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import (AdmissionConfig, ContinuousEngine,
                               MetricsRegistry, PagedEngine, Request,
                               ServeEngine, StepProfiler, Telemetry,
                               drive_open_loop, format_snapshot, percentile)
from repro_torch.serve import telemetry as T

SNAPSHOT_KEYS = {"schema_version", "engine", "latency", "phases", "kv_cache",
                 "occupancy", "prefix", "padding", "robustness"}
ROBUSTNESS_KEYS = {"preemptions", "exhaustion_events", "device_retries",
                   "cancelled", "shed", "rejected", "deadline_misses",
                   "reprefill", "per_class"}
LATENCY_KEYS = {"requests", "ttft", "tpot", "e2e", "queue_wait",
                "queue_wait_hist", "queue_depth_peak", "queue_depth_mean"}
DIST_KEYS = {"count", "mean", "p50", "p95", "p99"}
PHASES_KEYS = {"steps", "step_seconds", "coverage", "phases"}

_MODELS: dict = {}


@pytest.fixture
def served(tiny_cfg):
    """(jax cfg, jax params, port cfg, port params) on the same weights."""
    if not _MODELS:
        cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div")
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device="cpu")
        _MODELS["m"] = (cfg, params, pcfg, pparams)
    return _MODELS["m"]


def _requests(rng, n, lens=(5, 9, 13), max_new=6, cls=Request):
    return [cls(uid=i,
                prompt=rng.integers(0, 256, int(rng.choice(lens))).astype(
                    np.int32),
                max_new_tokens=max_new)
            for i in range(n)]


def _jax_twin(reqs):
    return [JRequest(uid=r.uid, prompt=np.asarray(r.prompt).copy(),
                     max_new_tokens=r.max_new_tokens,
                     temperature=r.temperature) for r in reqs]


def _engines(params, cfg, telemetry):
    paged_cfg = cfg.replace(cache_layout="paged", prefix_sharing=True)
    kw = dict(device="cpu")
    return {
        "wave": ServeEngine(params, cfg, max_batch=4, max_len=64,
                            telemetry=telemetry, **kw),
        "continuous": ContinuousEngine(params, cfg, max_batch=4, max_len=64,
                                       telemetry=telemetry, **kw),
        "paged": PagedEngine(params, paged_cfg, max_batch=4, max_len=64,
                             block_size=8, packed=True, telemetry=telemetry,
                             **kw),
    }


def _jax_engines(params, cfg, telemetry):
    paged_cfg = cfg.replace(cache_layout="paged", prefix_sharing=True)
    return {
        "wave": JServe(params, cfg, max_batch=4, max_len=64,
                       telemetry=telemetry),
        "continuous": JContinuous(params, cfg, max_batch=4, max_len=64,
                                  telemetry=telemetry),
        "paged": JPaged(params, paged_cfg, max_batch=4, max_len=64,
                        block_size=8, packed=True, telemetry=telemetry),
    }


def _serve(eng, reqs):
    for r in reqs:
        eng.submit(r)
    return {r.uid: [int(t) for t in r.out_tokens] for r in eng.run()}


def _counters(snap):
    """A snapshot without its wall-clock numbers: what two engines on the
    same weights and traffic must agree on."""
    out = {k: snap[k] for k in ("schema_version", "engine", "occupancy",
                                "prefix", "padding", "robustness")}
    out["kv_logical"] = (snap["kv_cache"] or {}).get("cache_bytes_logical")
    lat = snap["latency"]
    if lat is not None:
        out["latency"] = dict(
            requests=lat["requests"], peak=lat["queue_depth_peak"],
            mean=lat["queue_depth_mean"],
            counts={m: lat[m]["count"]
                    for m in ("ttft", "tpot", "e2e", "queue_wait")})
    ph = snap["phases"]
    if ph is not None:
        out["phases"] = dict(steps=ph["steps"],
                             counts={n: p["count"]
                                     for n, p in ph["phases"].items()})
    return out


def _keys(node):
    """The nested key structure of a snapshot."""
    if isinstance(node, dict):
        return {k: _keys(v) for k, v in node.items()}
    return None


# ------------------------------------------------------------ percentile --


def test_percentile_matches_numpy(rng):
    for n in (1, 2, 3, 7, 50, 101):
        xs = rng.normal(size=n).tolist()
        for q in (0, 1, 25, 50, 75, 95, 99, 100):
            assert percentile(xs, q) == pytest.approx(
                float(np.percentile(xs, q)), abs=1e-12)


def test_percentile_empty_is_none():
    assert percentile([], 50) is None


# ------------------------------------------------- lifecycle invariants --


class FakeClock:
    """Deterministic monotonic clock for registry/profiler unit tests."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        self.t += 0.25
        return self.t


def test_registry_lifecycle_and_summary():
    regs = (MetricsRegistry(clock=FakeClock()),
            JRegistry(clock=FakeClock()))
    for reg in regs:
        for uid in range(3):
            reg.on_submit(uid, prompt_len=10 + uid)
        assert reg.queue_depth == 3 and reg.queue_depth_peak == 3
        for uid in range(3):
            reg.on_admit(uid)
            reg.on_first_token(uid)
            reg.on_finish(uid, n_tokens=4)
        assert reg.queue_depth == 0
    s = regs[0].latency_summary()
    assert s == regs[1].latency_summary()      # the JAX registry's numbers
    assert s["requests"] == 3
    assert set(s) == LATENCY_KEYS
    for m in ("ttft", "tpot", "e2e", "queue_wait"):
        assert set(s[m]) == DIST_KEYS
        assert s[m]["count"] == 3
        assert s[m]["p50"] >= 0 and s[m]["p99"] >= s[m]["p50"]
    h = s["queue_wait_hist"]
    assert sum(h["counts"]) == 3
    assert len(h["counts"]) == len(h["edges_ms"]) + 1


def test_registry_hooks_are_idempotent_and_order_safe():
    reg = MetricsRegistry(clock=FakeClock())
    reg.on_submit(0, 5)
    reg.on_admit(0)
    t_admit = reg.traces[0].admit_ts
    reg.on_admit(0)                       # duplicate admit: no double count
    assert reg.traces[0].admit_ts == t_admit and reg.queue_depth == 0
    reg.on_first_token(0)
    reg.on_finish(0, 3)
    reg.on_finish(0, 99)                  # duplicate finish: first wins
    assert len(reg.finished) == 1 and reg.finished[0].n_tokens == 3
    reg.on_admit(42)                      # unknown uid: ignored, no crash
    reg.on_finish(42, 1)
    assert len(reg.finished) == 1
    reg.on_submit(7, 4)
    reg.on_drop(7)                        # dropped before admission
    reg.on_drop(7)
    assert reg.traces[7].dropped and reg.queue_depth == 0


def test_single_token_request_has_no_tpot():
    reg = MetricsRegistry(clock=FakeClock())
    reg.on_submit(0, 5)
    reg.on_admit(0)
    reg.on_first_token(0)
    reg.on_finish(0, n_tokens=1)
    t = reg.finished[0]
    assert t.tpot is None
    assert reg.latency_summary()["tpot"]["count"] == 0


def test_profiler_matches_jax_on_one_clock():
    """The same spans on the same fake clock: the same summary and the same
    Chrome-trace events as the JAX profiler."""
    profs = (StepProfiler(clock=FakeClock()), JProfiler(clock=FakeClock()))
    for prof in profs:
        for _ in range(3):
            with prof.step():
                for name in ("admit", "schedule", "device", "schedule"):
                    with prof.phase(name):
                        pass
        with prof.phase("outside"):        # not inside a step
            pass
    assert profs[0].summary() == profs[1].summary()
    assert profs[0].events == profs[1].events
    assert profs[0].coverage == pytest.approx(4 / 9)   # 4 of 9 ticks


@pytest.mark.parametrize("name", ["wave", "continuous", "paged"])
def test_engine_trace_ordering_invariants(served, rng, name):
    """submit <= admit <= first_token <= finish on every finished trace, and
    every derived latency is non-negative, driven by a real engine; the
    JAX engine's traces agree on uids and token counts."""
    cfg, params, pcfg, pparams = served
    tel = Telemetry(enabled=True)
    eng = _engines(pparams, pcfg, tel)[name]
    reqs = _requests(rng, 6)
    reqs[1].max_new_tokens = 1                    # finishes at first token
    jreqs = _jax_twin(reqs)
    jtel = JTelemetry(enabled=True)
    ref = _serve(_jax_engines(params, cfg, jtel)[name], jreqs)
    done = _serve(eng, reqs)
    assert done == ref
    assert len(done) == len(reqs)
    traces = tel.metrics.finished
    assert sorted(t.uid for t in traces) == sorted(r.uid for r in reqs)
    for t in traces:
        assert t.submit_ts <= t.admit_ts <= t.first_token_ts <= t.finish_ts
        assert t.queue_wait >= 0 and t.ttft >= 0 and t.e2e >= 0
        assert t.e2e >= t.ttft
        assert t.tpot is None or t.tpot >= 0
        assert t.n_tokens == len(done[t.uid])
    assert sorted((t.uid, t.n_tokens) for t in traces) == \
        sorted((t.uid, t.n_tokens) for t in jtel.metrics.finished)


# ----------------------------------------------------------- chrome trace --


def test_chrome_trace_jsonl_validity(served, rng, tmp_path):
    """Every line is a complete JSON event with the Chrome-trace keys;
    phase events fall inside [min step ts, max step end]; step events carry
    their step index; the events are the JAX engine's, by name and
    order."""
    cfg, params, pcfg, pparams = served
    tel = Telemetry(enabled=True)
    eng = _engines(pparams, pcfg, tel)["paged"]
    reqs = _requests(rng, 4)
    jtel = JTelemetry(enabled=True)
    _serve(_jax_engines(params, cfg, jtel)["paged"], _jax_twin(reqs))
    _serve(eng, reqs)
    path = tmp_path / "trace.jsonl"
    n = tel.profiler.write_chrome_trace(str(path))
    lines = path.read_text().splitlines()
    assert n == len(lines) > 0
    events = [json.loads(ln) for ln in lines]
    for ev in events:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid"} <= set(ev)
        assert ev["ph"] == "X" and ev["cat"] in ("step", "phase")
        assert ev["ts"] >= 0 and ev["dur"] >= 0
    assert [ev["ts"] for ev in events] == sorted(ev["ts"] for ev in events)
    steps = [ev for ev in events if ev["cat"] == "step"]
    phases = [ev for ev in events if ev["cat"] == "phase"]
    assert steps and phases
    assert [ev["args"]["step"] for ev in steps] == list(range(len(steps)))
    lo = min(ev["ts"] for ev in steps)
    hi = max(ev["ts"] + ev["dur"] for ev in steps)
    # tolerate the timestamp rounding (0.1 us) at the boundaries
    assert all(lo - 1 <= ev["ts"] and ev["ts"] + ev["dur"] <= hi + 1
               for ev in phases)
    assert {ev["name"] for ev in phases} >= {"admit", "device", "sample"}
    # recording order (a span is appended when it closes) is the JAX one
    assert [(e["cat"], e["name"]) for e in tel.profiler.events] == \
        [(e["cat"], e["name"]) for e in jtel.profiler.events]


def test_disabled_profiler_records_nothing():
    prof = StepProfiler(enabled=False)
    with prof.step():
        with prof.phase("device"):
            pass
    assert prof.events == [] and prof.step_count == 0
    assert prof.coverage is None


# ------------------------------------------------------- parity & schema --


def test_greedy_parity_telemetry_on_vs_off(served, rng):
    """Telemetry is purely observational: token-identical greedy outputs
    with it on and off, for all three engines, equal to the JAX
    engines'."""
    cfg, params, pcfg, pparams = served
    reqs = _requests(rng, 6)
    outs = {}
    for enabled in (False, True):
        engines = _engines(pparams, pcfg, Telemetry(enabled=enabled))
        outs[enabled] = {name: _serve(eng, copy.deepcopy(reqs))
                         for name, eng in engines.items()}
    assert outs[True] == outs[False]
    ref = {name: _serve(eng, _jax_twin(reqs))
           for name, eng in _jax_engines(params, cfg, None).items()}
    assert outs[True] == ref


@pytest.mark.parametrize("enabled", [False, True])
def test_snapshot_schema_stability(served, rng, enabled):
    """The snapshot key set is STABLE across engines and telemetry
    settings: sections an engine lacks are None, never absent. The keys,
    nested, and the counters equal the JAX engines'."""
    cfg, params, pcfg, pparams = served
    engines = _engines(pparams, pcfg, Telemetry(enabled=enabled))
    jengines = _jax_engines(params, cfg, JTelemetry(enabled=enabled))
    reqs = _requests(rng, 4)
    _serve(engines["paged"], reqs)
    _serve(jengines["paged"], _jax_twin(reqs))
    for name, eng in engines.items():
        snap = eng.snapshot()
        jsnap = jengines[name].snapshot()
        assert set(snap) == SNAPSHOT_KEYS
        assert snap["schema_version"] == 2
        assert snap["engine"] == name
        assert snap["robustness"] is None    # none of these are robust
        assert set(snap["kv_cache"]) == {"cache_bytes_logical",
                                         "cache_bytes_padded"}
        if enabled:
            assert set(snap["latency"]) == LATENCY_KEYS
            assert set(snap["phases"]) == PHASES_KEYS
        else:
            assert snap["latency"] is None and snap["phases"] is None
        if name == "paged":
            assert snap["prefix"] is not None and snap["padding"] is not None
        else:
            assert snap["prefix"] is None and snap["padding"] is None
        assert json.dumps(snap)           # JSON-serializable as-is
        assert format_snapshot(snap).startswith("telemetry snapshot")
        assert _keys(snap) == _keys(jsnap)
        assert _counters(snap) == _counters(jsnap)


def test_snapshot_robustness_section(served, rng):
    """A robust engine's snapshot carries the v2 `robustness` section with a
    stable key set (JSON-serializable, str per-class keys), populated from
    the run's admission/preemption counters as the JAX engine's is."""
    cfg, params, pcfg, pparams = served
    eng = PagedEngine(pparams, pcfg, max_batch=2, max_len=64, block_size=8,
                      admission=AdmissionConfig(preemption=True),
                      telemetry=Telemetry(enabled=True), device="cpu")
    jeng = JPaged(params, cfg, max_batch=2, max_len=64, block_size=8,
                  admission=JAdmission(preemption=True),
                  telemetry=JTelemetry(enabled=True))
    reqs = _requests(rng, 4)
    for i, r in enumerate(reqs):
        r.priority = i % 2
    jreqs = _jax_twin(reqs)
    for i, r in enumerate(jreqs):
        r.priority = i % 2
    assert _serve(eng, reqs) == _serve(jeng, jreqs)
    snap = eng.snapshot()
    rb = snap["robustness"]
    assert set(rb) == ROBUSTNESS_KEYS
    assert set(rb["deadline_misses"]) == {"ttft", "e2e", "total"}
    assert set(rb["reprefill"]) == {"tokens", "skipped", "skip_rate"}
    assert all(isinstance(k, str) for k in rb["per_class"])
    assert sum(pc["finished"] for pc in rb["per_class"].values()) == 4
    assert json.dumps(snap)
    assert _counters(snap) == _counters(jeng.snapshot())


def _assert_no_nan(node, path="snap"):
    if isinstance(node, dict):
        for k, v in node.items():
            _assert_no_nan(v, f"{path}.{k}")
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _assert_no_nan(v, f"{path}[{i}]")
    elif isinstance(node, float):
        assert node == node, f"NaN at {path}"


def test_snapshot_mid_run_never_crashes(served, rng):
    """A snapshot taken MID-FLIGHT (unfinished requests, zero finished, a
    speculative engine that has not drafted yet) renders and serializes:
    every empty distribution reports None, the draft acceptance_rate is
    None until something was drafted, and nothing is NaN; each snapshot's
    counters equal the JAX engine's at the same point."""
    cfg, params, pcfg, pparams = served
    kw = dict(max_batch=4, max_len=64, block_size=8, packed=True,
              prefix_sharing=True, decode_sharing=True)
    eng = PagedEngine(pparams, pcfg.replace(cache_layout="paged",
                                            speculative=True),
                      telemetry=Telemetry(enabled=True), device="cpu", **kw)
    jeng = JPaged(params, cfg.replace(cache_layout="paged",
                                      speculative=True),
                  telemetry=JTelemetry(enabled=True), **kw)
    # before ANY work: no steps, no finished requests, empty trie
    for snap_point in range(3):
        snap = eng.snapshot()
        assert set(snap) == SNAPSHOT_KEYS
        for dist in ("ttft", "tpot", "e2e", "queue_wait"):
            if snap["latency"]["requests"] == 0:
                assert snap["latency"][dist]["count"] == 0
                assert snap["latency"][dist]["p50"] is None
        if snap["prefix"]["tokens_drafted"] == 0:
            assert snap["prefix"]["acceptance_rate"] is None
        _assert_no_nan(snap)
        assert json.dumps(snap)
        assert format_snapshot(snap).startswith("telemetry snapshot")
        assert _counters(snap) == _counters(jeng.snapshot())
        if snap_point == 0:               # go mid-flight: some steps, no
            reqs = _requests(rng, 3, max_new=24)   # finishes yet
            for e, rs in ((eng, reqs), (jeng, _jax_twin(reqs))):
                for r in rs:
                    e.submit(r)
                e.step()
                e.step()
        elif snap_point == 1:
            eng.run()                     # drained: finished requests exist
            jeng.run()


@pytest.mark.parametrize("name", ["wave", "continuous", "paged"])
def test_phase_coverage_gate(served, rng, name):
    """>= 90% of measured step wall time must be attributed to named phases
    — the gate that keeps new per-step host work from hiding outside the
    breakdown. The phases entered, and how often, are the JAX engine's."""
    cfg, params, pcfg, pparams = served
    tel = Telemetry(enabled=True)
    eng = _engines(pparams, pcfg, tel)[name]
    jeng = _jax_engines(params, cfg, JTelemetry(enabled=True))[name]
    reqs = _requests(rng, 6)
    _serve(jeng, _jax_twin(reqs))
    _serve(eng, reqs)
    snap = eng.snapshot()
    assert snap["phases"]["steps"] > 0
    assert snap["phases"]["coverage"] >= 0.9
    assert _counters(snap)["phases"] == _counters(jeng.snapshot())["phases"]


# -------------------------------------------------------------- open loop --


def test_drive_open_loop_validates_inputs(served):
    _, _, pcfg, pparams = served
    eng = _engines(pparams, pcfg, None)["continuous"]
    reqs = _requests(np.random.default_rng(0), 3)
    with pytest.raises(ValueError, match="arrivals"):
        drive_open_loop(eng, reqs, [0.0, 0.1])
    with pytest.raises(ValueError, match="sorted"):
        drive_open_loop(eng, reqs, [0.2, 0.1, 0.3])


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_drive_open_loop_serves_everything(served, rng, name):
    """Arrival-driven serving finishes every request, matches batch-drain
    greedy outputs (arrival timing must not change what is generated), and
    records non-negative queue waits in the traces."""
    _, _, pcfg, pparams = served
    reqs = _requests(rng, 6)
    ref = _serve(_engines(pparams, pcfg, None)[name], copy.deepcopy(reqs))
    tel = Telemetry(enabled=True)
    eng = _engines(pparams, pcfg, tel)[name]
    arrivals = np.cumsum(rng.exponential(0.005, len(reqs)))
    done = drive_open_loop(eng, copy.deepcopy(reqs), arrivals)
    assert {r.uid: r.out_tokens for r in done} == ref
    assert not eng.busy
    s = tel.metrics.latency_summary()
    assert s["requests"] == len(reqs)
    assert s["ttft"]["count"] == len(reqs)
    assert s["queue_wait"]["p50"] >= 0


# -------------------------------------------------- serving-clock unity --


def _noop_sleep(_):
    pass


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_deadline_and_telemetry_share_one_clock(served, name):
    """A fake clock injected into Telemetry alone drives BOTH the deadline
    and the traces: the deadline expires on the fake timebase (it never
    would on a real one here), the miss counter bumps, and the dropped
    request's trace agrees with the miss on the same clock, at the same
    step as in the JAX engine."""
    cfg, params, pcfg, pparams = served
    steps = {}
    for pkg in ("jax", "port"):
        clock = FakeClock()
        if pkg == "jax":
            tel = JTelemetry(enabled=True, clock=clock)
            kw = dict(max_batch=2, max_len=64, telemetry=tel,
                      admission=JAdmission())
            eng = (JPaged(params, cfg.replace(cache_layout="paged"),
                          block_size=8, packed=True, **kw)
                   if name == "paged" else JContinuous(params, cfg, **kw))
            cls = JRequest
        else:
            tel = Telemetry(enabled=True, clock=clock)
            kw = dict(max_batch=2, max_len=64, telemetry=tel,
                      admission=AdmissionConfig(), device="cpu")
            eng = (PagedEngine(pparams, pcfg.replace(cache_layout="paged"),
                               block_size=8, packed=True, **kw)
                   if name == "paged" else ContinuousEngine(pparams, pcfg,
                                                            **kw))
            cls = Request
        rng = np.random.default_rng(0)
        req = cls(uid=0, prompt=rng.integers(0, 256, 6).astype(np.int32),
                  max_new_tokens=32, deadline_e2e=1.5)
        eng.submit(req)
        guard = 0
        while eng.busy and guard < 200:
            eng.step()
            guard += 1
        assert req.failed and req.fail_reason == "deadline_e2e"
        assert eng.robust_counters.deadline_miss_e2e == 1
        trace = tel.metrics.traces[0]
        assert trace.dropped
        assert clock.t - trace.submit_ts > 1.5
        steps[pkg] = (guard, len(req.out_tokens), clock.t)
    assert steps["port"] == steps["jax"]


def test_explicit_admission_clock_still_wins(served):
    """An explicitly injected AdmissionConfig.clock overrides the engine's
    serving clock: a frozen admission clock means deadlines never expire
    while telemetry time races ahead."""
    _, _, pcfg, pparams = served
    tel = Telemetry(enabled=True, clock=FakeClock())
    eng = ContinuousEngine(pparams, pcfg, max_batch=2, max_len=64,
                           telemetry=tel, device="cpu",
                           admission=AdmissionConfig(clock=lambda: 0.0))
    rng = np.random.default_rng(0)
    req = Request(uid=0, prompt=rng.integers(0, 256, 6).astype(np.int32),
                  max_new_tokens=4, deadline_e2e=0.5)
    eng.submit(req)
    eng.run()
    assert req.done and not req.failed
    assert eng.robust_counters.deadline_miss_e2e == 0


def test_serving_clock_is_the_jax_one():
    from repro.serve import telemetry as jax_telemetry
    assert T.SERVING_CLOCK is jax_telemetry.SERVING_CLOCK
    assert Telemetry().clock is T.SERVING_CLOCK


@pytest.mark.parametrize("name", ["continuous", "paged"])
def test_drive_open_loop_stamps_intended_arrivals(served, name):
    """drive_open_loop stamps each request's INTENDED arrival (t0 +
    offset) and the engines anchor the trace there, so consecutive submit
    timestamps reproduce the arrival offsets exactly; the JAX
    drive_open_loop on the JAX engine stamps the same times on the same
    fake clock."""
    cfg, params, pcfg, pparams = served
    arrivals = np.array([0.0, 2.0, 7.0, 9.0])
    subs = {}
    for pkg in ("jax", "port"):
        clock = FakeClock()
        rng = np.random.default_rng(1)
        if pkg == "jax":
            tel = JTelemetry(enabled=True, clock=clock)
            eng = _jax_engines(params, cfg, tel)[name]
            reqs = _requests(rng, 4, max_new=3, cls=JRequest)
            drive = jax_drive_open_loop
        else:
            tel = Telemetry(enabled=True, clock=clock)
            eng = _engines(pparams, pcfg, tel)[name]
            reqs = _requests(rng, 4, max_new=3)
            drive = drive_open_loop
        done = drive(eng, reqs, arrivals, clock=clock, sleep=_noop_sleep)
        assert len(done) == len(reqs)
        subs[pkg] = [tel.metrics.traces[r.uid].submit_ts for r in reqs]
        gaps = np.diff(subs[pkg])
        assert np.allclose(gaps, np.diff(arrivals)), (
            f"submit timestamps {subs[pkg]} do not reproduce arrival "
            f"offsets {list(arrivals)}")
        # queue wait can only begin at arrival: no admit precedes its submit
        for r in reqs:
            t = tel.metrics.traces[r.uid]
            assert t.admit_ts is None or t.admit_ts >= t.submit_ts
    assert subs["port"] == subs["jax"]
