"""Serving telemetry — the port of `repro/serve/telemetry.py`: request-
lifecycle tracing, latency percentiles, and a step-phase profiler shared by
the three engines.

* **RequestTrace / MetricsRegistry** — one trace per request with the
  lifecycle timestamps submit -> admit -> first_token -> finish, and the
  serving metrics derived from finished traces:

      TTFT       = first_token - submit
      TPOT       = (finish - first_token) / (n_tokens - 1)   (n_tokens >= 2)
      E2E        = finish - submit
      queue_wait = admit - submit

  as p50/p95/p99/mean (linear-interpolation percentiles, numpy's default).

* **StepProfiler** — wraps each engine step and attributes its wall time
  to the named phases of the step body (flat, re-enterable):

      admit      queue -> slot admission (continuous: with its prefill)
      schedule   host scheduling and token packing, the step's uploads
      alloc_cow  block growth and copy-on-write copies
      device     the model step; fenced with torch.cuda.synchronize ONLY
                 while profiling (`device_fence`), so an unprofiled run
                 keeps the host running ahead of the card
      sample     logits -> next tokens (argmax / categorical, the landing
                 of the tokens on the host)
      register   prefix-trie registration of newly filled blocks
      rollback   a speculative verify step's rollback (and int8 replay)

  `summary()` gives per-phase totals, shares of step time and `coverage`
  (attributed / step wall time; the acceptance gate keeps it >= 0.9);
  `write_chrome_trace` writes one complete event per line (Perfetto,
  chrome://tracing). `StepProfiler(fence=False)` times the same phases on
  the host with no device fence, each phase then also a `phase.<name>`
  range while a torch.profiler records, so the profiler's device trace
  places the card's work against the phases instead.

* **span** — the program's named ranges on the device trace's clock
  (`repro_torch/spans.py`, re-exported here): a `record_function` range
  while a torch.profiler records, the shared null context otherwise.

* **Telemetry** — one registry and one profiler behind one `enabled` flag.
  Engines hold a disabled instance by default: every hook is then one
  attribute test, and `phase()` returns a shared null context.

`make_snapshot` merges the lifecycle and phase metrics with an engine's
counters (prefix, padding, KV bytes, occupancy, robustness) into one
schema-versioned dict, the JAX package's schema; `drive_open_loop` is the
arrival-driven serving loop behind `launch/serve.py --arrival-rate`.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time

import numpy as np
import torch

from repro_torch.spans import NULL as _NULL
from repro_torch.spans import span

# v2 added the `robustness` section and RequestTrace.dropped
SNAPSHOT_SCHEMA_VERSION = 2

# admission-wait histogram bucket edges (ms, log-spaced); the last bucket
# is open-ended
QUEUE_WAIT_EDGES_MS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0,
                       500.0, 1000.0, 2000.0, 5000.0)

# THE serving clock: deadlines (serve/admission.py), lifecycle latencies,
# the step profiler and drive_open_loop all default to it, so a
# request cannot miss its SLA on one clock while telemetry reports it in
# SLO on another. Inject a replacement with Telemetry(clock=...).
SERVING_CLOCK = time.perf_counter


def device_fence(device: torch.device):
    """The profiler's `device` phase fence: wait for the card to finish
    the work queued so far, so device time lands in the phase that queued
    it. Nothing on the CPU. Engines call it only while a fencing profiler
    is on (`StepProfiler.fence`), through this module, so a test can count
    the fences."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def percentile(values, q: float):
    """q-th percentile (0..100) with linear interpolation, numpy's default
    method."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def _dist(values) -> dict:
    """p50/p95/p99/mean/count of a latency sample (seconds)."""
    vals = [v for v in values if v is not None]
    return dict(
        count=len(vals),
        mean=float(np.mean(vals)) if vals else None,
        p50=percentile(vals, 50), p95=percentile(vals, 95),
        p99=percentile(vals, 99))


@dataclasses.dataclass
class RequestTrace:
    """Lifecycle timestamps of one request (seconds on the registry clock):
    submit_ts <= admit_ts <= first_token_ts <= finish_ts when finished."""
    uid: int
    prompt_len: int
    submit_ts: float
    admit_ts: float | None = None
    first_token_ts: float | None = None
    finish_ts: float | None = None
    n_tokens: int = 0
    dropped: bool = False         # ended in failure (shed/cancel/deadline)

    @property
    def queue_wait(self):
        if self.admit_ts is None:
            return None
        return self.admit_ts - self.submit_ts

    @property
    def ttft(self):
        if self.first_token_ts is None:
            return None
        return self.first_token_ts - self.submit_ts

    @property
    def tpot(self):
        """Per-token latency after the first token; None for single-token
        requests."""
        if self.finish_ts is None or self.first_token_ts is None \
                or self.n_tokens < 2:
            return None
        return (self.finish_ts - self.first_token_ts) / (self.n_tokens - 1)

    @property
    def e2e(self):
        if self.finish_ts is None:
            return None
        return self.finish_ts - self.submit_ts


class MetricsRegistry:
    """Collects RequestTraces by uid and derives the latency summary. The
    engines call on_submit at queue entry, on_admit at slot assignment,
    on_first_token when out_tokens goes 0 -> 1, on_finish at completion and
    on_drop at a failure; re-submitting a uid starts a fresh trace."""

    def __init__(self, clock=None):
        self.clock = clock if clock is not None else SERVING_CLOCK
        self.traces: dict[int, RequestTrace] = {}
        self.finished: list[RequestTrace] = []
        self.queue_depth = 0          # submitted, not yet admitted
        self.queue_depth_peak = 0
        self._depth_sum = 0           # sampled per step for the mean
        self._depth_samples = 0

    def on_submit(self, uid: int, prompt_len: int, ts=None):
        """`ts`: an explicit submit time on the registry clock;
        drive_open_loop passes the request's intended arrival, so a wait
        that began during a device step is charged to queueing."""
        self.traces[uid] = RequestTrace(
            uid, int(prompt_len), self.clock() if ts is None else float(ts))
        self.queue_depth += 1
        self.queue_depth_peak = max(self.queue_depth_peak, self.queue_depth)

    def on_admit(self, uid: int):
        t = self.traces.get(uid)
        if t is not None and t.admit_ts is None:
            t.admit_ts = self.clock()
            self.queue_depth -= 1

    def on_first_token(self, uid: int):
        t = self.traces.get(uid)
        if t is not None and t.first_token_ts is None:
            t.first_token_ts = self.clock()

    def on_finish(self, uid: int, n_tokens: int):
        t = self.traces.get(uid)
        if t is None or t.finish_ts is not None:
            return
        t.finish_ts = self.clock()
        t.n_tokens = int(n_tokens)
        self.finished.append(t)

    def on_drop(self, uid: int):
        """A request ended in failure: mark its trace dropped (it never
        joins the finished list) and rebalance queue_depth if it was never
        admitted."""
        t = self.traces.get(uid)
        if t is None or t.dropped or t.finish_ts is not None:
            return
        t.dropped = True
        if t.admit_ts is None:
            self.queue_depth -= 1

    def sample_queue_depth(self):
        """Per-step queue-depth sample (the mean in the summary)."""
        self._depth_sum += self.queue_depth
        self._depth_samples += 1

    def latency_summary(self) -> dict:
        """TTFT/TPOT/E2E/queue-wait distributions and queue telemetry over
        finished requests."""
        done = self.finished
        waits = [t.queue_wait for t in done if t.queue_wait is not None]
        edges = QUEUE_WAIT_EDGES_MS
        counts = [0] * (len(edges) + 1)
        for w in waits:
            counts[int(np.searchsorted(edges, w * 1e3, side="right"))] += 1
        return dict(
            requests=len(done),
            ttft=_dist(t.ttft for t in done),
            tpot=_dist(t.tpot for t in done),
            e2e=_dist(t.e2e for t in done),
            queue_wait=_dist(waits),
            queue_wait_hist=dict(edges_ms=list(edges), counts=counts),
            queue_depth_peak=self.queue_depth_peak,
            queue_depth_mean=(self._depth_sum / self._depth_samples
                              if self._depth_samples else None))


class _Span:
    """Timing context of StepProfiler, one per __enter__ (re-entrant
    phases in one step are safe)."""

    def __init__(self, prof, name: str, is_step: bool):
        self.prof = prof
        self.name = name
        self.is_step = is_step

    def __enter__(self):
        prof = self.prof
        if self.is_step:
            prof._step_depth += 1
            self.idx = prof.step_count
        self.range = (_NULL if prof.fence or self.is_step
                      else span("phase." + self.name))
        self.range.__enter__()
        self.t0 = prof.clock()
        return self

    def __exit__(self, *exc):
        prof = self.prof
        t1 = prof.clock()
        self.range.__exit__(*exc)
        dur = t1 - self.t0
        ev = dict(name=self.name, cat="step" if self.is_step else "phase",
                  ph="X", ts=round((self.t0 - prof.epoch) * 1e6, 1),
                  dur=round(dur * 1e6, 1), pid=0, tid=0)
        if self.is_step:
            prof._step_depth -= 1
            prof.step_total += dur
            prof.step_count += 1
            ev["args"] = {"step": self.idx}
        else:
            prof.phase_seconds[self.name] = (
                prof.phase_seconds.get(self.name, 0.0) + dur)
            prof.phase_counts[self.name] = (
                prof.phase_counts.get(self.name, 0) + 1)
            if prof._step_depth > 0:
                prof.in_step_seconds += dur
        prof.events.append(ev)
        return False


class StepProfiler:
    """Wall-time attribution of engine steps to named phases: `step(name)`
    wraps one engine step, `phase(name)` a region of its body. When
    disabled both return a shared null context. `fence` (the default) has
    the engines wait for the card at the end of the device phase, so its
    host time holds the device time; with fence False nothing waits, and
    each phase is also a `phase.<name>` range while a torch.profiler
    records."""

    def __init__(self, enabled: bool = True, clock=None, fence: bool = True):
        self.enabled = enabled
        self.fence = fence
        self.clock = clock if clock is not None else SERVING_CLOCK
        self.reset()

    def reset(self):
        self.epoch = self.clock()
        self.events: list[dict] = []
        self.phase_seconds: dict[str, float] = {}
        self.phase_counts: dict[str, int] = {}
        self.in_step_seconds = 0.0
        self.step_total = 0.0
        self.step_count = 0
        self._step_depth = 0

    def step(self, name: str = "step"):
        if not self.enabled:
            return _NULL
        return _Span(self, name, is_step=True)

    def phase(self, name: str):
        if not self.enabled:
            return _NULL
        return _Span(self, name, is_step=False)

    @property
    def coverage(self):
        """Fraction of step wall time attributed to in-step phases."""
        if not self.step_total:
            return None
        return self.in_step_seconds / self.step_total

    def summary(self) -> dict:
        return dict(
            steps=self.step_count,
            step_seconds=self.step_total,
            coverage=self.coverage,
            phases={name: dict(count=self.phase_counts[name],
                               seconds=secs,
                               share_of_step=(secs / self.step_total
                                              if self.step_total else None))
                    for name, secs in sorted(self.phase_seconds.items())})

    def write_chrome_trace(self, path: str) -> int:
        """Chrome-trace JSONL, one complete ('ph': 'X') event per line, ts
        and dur in microseconds since the profiler epoch. Returns the event
        count."""
        with open(path, "w") as f:
            for ev in sorted(self.events, key=lambda e: e["ts"]):
                f.write(json.dumps(ev) + "\n")
        return len(self.events)


class Telemetry:
    """One MetricsRegistry and one StepProfiler behind one `enabled`
    flag; `fence` is the profiler's (StepProfiler)."""

    def __init__(self, enabled: bool = True, clock=None, fence: bool = True):
        self.enabled = enabled
        self.clock = clock if clock is not None else SERVING_CLOCK
        self.metrics = MetricsRegistry(self.clock)
        self.profiler = StepProfiler(enabled, self.clock, fence)

    def reset(self):
        """Drop traces and profile data (after a warm-up, so a timed
        segment reports only its own requests)."""
        self.metrics = MetricsRegistry(self.clock)
        self.profiler.reset()


def as_telemetry(telemetry) -> Telemetry:
    """An engine's `telemetry=` argument: a Telemetry passes through,
    truthy builds an enabled one, falsy or None the disabled default."""
    if isinstance(telemetry, Telemetry):
        return telemetry
    return Telemetry(enabled=bool(telemetry))


def make_snapshot(engine: str, telemetry: Telemetry, *, kv_cache=None,
                  occupancy=None, prefix=None, padding=None,
                  robustness=None) -> dict:
    """The schema-versioned snapshot every engine's `snapshot()` returns.
    Sections an engine lacks (and latency/phases with telemetry off) are
    None, never absent, so the key set is the same everywhere."""
    enabled = telemetry.enabled
    return dict(
        schema_version=SNAPSHOT_SCHEMA_VERSION,
        engine=engine,
        latency=telemetry.metrics.latency_summary() if enabled else None,
        phases=telemetry.profiler.summary() if enabled else None,
        kv_cache=kv_cache,
        occupancy=occupancy,
        prefix=prefix,
        padding=padding,
        robustness=robustness)


def format_snapshot(snap: dict) -> str:
    """Human-readable latency and phase sections of a snapshot."""
    lines = [f"telemetry snapshot (schema v{snap['schema_version']}, "
             f"engine={snap['engine']})"]
    lat = snap.get("latency")
    if lat:
        for name in ("ttft", "tpot", "e2e", "queue_wait"):
            d = lat[name]
            if not d["count"]:
                continue
            lines.append(
                "  %-10s p50 %7.2f ms  p95 %7.2f ms  p99 %7.2f ms  "
                "(n=%d)" % (name, d["p50"] * 1e3, d["p95"] * 1e3,
                            d["p99"] * 1e3, d["count"]))
        lines.append(f"  queue depth: peak {lat['queue_depth_peak']}")
    prof = snap.get("phases")
    if prof and prof["steps"]:
        lines.append(
            "  %d steps, %.3f s total, %.0f%% attributed to phases:"
            % (prof["steps"], prof["step_seconds"],
               100 * (prof["coverage"] or 0)))
        for name, p in sorted(prof["phases"].items(),
                              key=lambda kv: -kv[1]["seconds"]):
            share = p["share_of_step"]
            lines.append("    %-10s %8.3f s  %5.1f%%  (n=%d)" % (
                name, p["seconds"],
                100 * share if share is not None else 0.0, p["count"]))
    return "\n".join(lines)


def drive_open_loop(eng, reqs, arrivals, *, clock=None, sleep=time.sleep):
    """Open-loop serving: submit reqs[i] once `arrivals[i]` seconds (sorted
    ascending) have elapsed and step the engine while it has work; idle
    gaps sleep until the next arrival. Arrivals do not wait for the system,
    so queueing lands in TTFT. Needs the step-at-a-time API (`step()`,
    `busy`): the paged or continuous engine. Returns what the engine
    returned (finished or failed); a request rejected by backpressure is
    marked failed in place on `reqs`.

    Each request is stamped with its intended arrival (`req.arrival_ts =
    t0 + arrivals[i]` on `clock`) before submit; the engines anchor the
    telemetry submit time and the deadline clock there. `clock` defaults
    to SERVING_CLOCK: inject the same clock into the engine's Telemetry."""
    from repro_torch.serve.admission import QueueFull
    clock = clock if clock is not None else SERVING_CLOCK
    arrivals = np.asarray(arrivals, float)
    if len(arrivals) != len(reqs):
        raise ValueError(f"{len(reqs)} requests but {len(arrivals)} arrivals")
    if (np.diff(arrivals) < 0).any():
        raise ValueError("arrival offsets must be sorted ascending")
    done = []
    i = 0
    t0 = clock()
    while i < len(reqs) or eng.busy:
        now = clock() - t0
        while i < len(reqs) and arrivals[i] <= now:
            reqs[i].arrival_ts = t0 + float(arrivals[i])
            try:
                eng.submit(reqs[i])
            except QueueFull:
                # backpressure="reject": the request never entered the
                # engine, so it is marked here
                reqs[i].failed = True
                reqs[i].fail_reason = "rejected"
            i += 1
        if eng.busy:
            done.extend(eng.step())
        elif i < len(reqs):
            sleep(max(arrivals[i] - (clock() - t0), 0.0))
    return done
