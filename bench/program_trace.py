"""What the program itself marks in a traced run: the `repro.*` ranges that
repro_torch opens while a torch.profiler records (repro_torch/spans.py),
read against the CUDA runtime calls and kernels of the same device trace,
and the step stamps the paged engine puts on each request
(`Request.admit_step`, `first_token_step`).

    program = program_trace.of(ctx)    # in a per-layer metric's read(ctx)

`Program` takes the stretch's host events (`host_events`) beside the
harness's reading of its kernels (`tracing.Profile`). It nests the
program's ranges, and puts each host call that blocks until the card has
drained (`BLOCKING`), each `cudaMalloc`, and each idle gap of the card down
to the innermost program range the host was in, or to `outside`. The
readers' numbers are None where the program marked nothing: a program
without these spans or stamps, or a stretch with no device events (the
CPU).

harness.run hands readers no program trace yet. Until it does (as
`ctx.program`), `of` builds one from the run's own frame, the caller that
holds `ctx`: its profiled `stretch`, its client `loop` and the window
`t_open`..`t_close`; the diagnostics go to standard error."""
from __future__ import annotations

import bisect
import collections
import json
import sys

from bench import harness

PREFIX = "repro."
FORWARD = "repro.forward"
OUTSIDE = "outside"
# host calls that return only once the card has run the work queued before
# them (runtime and driver API names as CUPTI records them)
BLOCKING = frozenset((
    "cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize",
    "cudaMemcpy", "cudaMemset", "cuStreamSynchronize", "cuCtxSynchronize",
    "cuEventSynchronize"))
MALLOC = frozenset(("cudaMalloc",))


def host_events(prof) -> list[tuple]:
    """A torch.profiler's host events that `Program` reads, as (name,
    start_ns, end_ns): the program's ranges, blocking calls and mallocs."""
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if ((name.startswith(PREFIX) or name in BLOCKING or name in MALLOC)
                and not str(e.device_type()).endswith("CUDA")):
            out.append((name, e.start_ns(), e.end_ns()))
    return out


def segments(ranges) -> list[tuple]:
    """Properly nested (start, end, name) ranges flattened into disjoint
    (start, end, name) pieces, each named by its innermost range."""
    out, stack, t = [], [], None
    for s, e, name in sorted(ranges, key=lambda r: (r[0], -r[1])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            out.append((t, end, top))
            t = end
        if stack:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        out.append((t, end, top))
        t = end
    return [p for p in out if p[1] > p[0]]


def _inside(spans, t) -> bool:
    """t lies in one of the disjoint, sorted (start, end) spans."""
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and t <= spans[i][1]


class Program:
    """The program's spans in one profiled stretch (`events` as host_events
    gives them, `profile` the harness's tracing.Profile of the same
    profiler, or None) and its step stamps over the run's window
    (`requests`: (first-token time, Request) of each client request)."""

    def __init__(self, events=(), profile=None, requests=(),
                 window=(0.0, 0.0)):
        self.profile = profile
        ranges = [(s, e, n) for n, s, e in events if n.startswith(PREFIX)]
        self.blocking = [(s, e) for n, s, e in events if n in BLOCKING]
        self.mallocs = [(s, e) for n, s, e in events if n in MALLOC]
        self.segments = segments(ranges)
        self._starts = [p[0] for p in self.segments]
        self.by_name = collections.defaultdict(list)
        for s, e, n in sorted(ranges):
            self.by_name[n].append((s, e))
        self.forward = self.by_name[FORWARD]
        t_open, t_close = window
        self.prefill = [r.first_token_step - r.admit_step + 1
                        for t, r in requests
                        if t is not None and t_open <= t <= t_close
                        and not r.failed
                        and getattr(r, "first_token_step", None) is not None
                        and getattr(r, "admit_step", None) is not None]

    @property
    def steps(self) -> int:
        """Packed steps in the stretch: one `repro.forward` range each."""
        return len(self.forward)

    @property
    def on_device(self) -> bool:
        return self.profile is not None and bool(self.profile.kernels)

    def span_at(self, t) -> str:
        """The innermost program range around host time t."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return OUTSIDE

    def _by_span(self, calls, in_forward: bool) -> dict:
        """Count and host ns of `calls`, by the innermost range at each
        call's start, over the calls inside (or outside) the forward."""
        by = collections.defaultdict(lambda: [0, 0])
        for s, e in calls:
            if _inside(self.forward, s) == in_forward:
                c = by[self.span_at(s)]
                c[0] += 1
                c[1] += e - s
        return dict(by)

    @property
    def forward_wait_ms(self) -> float | None:
        """Host ms a packed step spends in blocking calls inside
        `repro.forward`; None without device events or forward ranges."""
        if not self.on_device or not self.steps:
            return None
        ns = sum(v[1] for v in self._by_span(self.blocking, True).values())
        return ns / self.steps / 1e6

    @property
    def prefill_steps_p95(self) -> float | None:
        """p95 of first_token_step - admit_step + 1 over the requests whose
        first token lands in the window."""
        return harness.percentile(self.prefill, 95)

    def idle_by_span(self) -> dict:
        """The stretch's idle device seconds, by the innermost program
        range the host was in."""
        if not self.on_device:
            return {}
        p = self.profile
        gaps, end = [], p.t0
        for s, e in p.busy:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if p.t1 > end:
            gaps.append((end, p.t1))
        by = collections.Counter()
        for g0, g1 in gaps:
            covered = 0
            i = max(bisect.bisect_right(self._starts, g0) - 1, 0)
            while i < len(self.segments) and self.segments[i][0] < g1:
                s, e, name = self.segments[i]
                ov = min(g1, e) - max(g0, s)
                if ov > 0:
                    by[name] += ov / 1e9
                    covered += ov
                i += 1
            by[OUTSIDE] += max(g1 - g0 - covered, 0) / 1e9
        return {k: v for k, v in by.most_common() if v > 0}

    def launched_s(self, name: str) -> float:
        """Device seconds of the kernels launched inside `name` ranges."""
        if not self.on_device:
            return 0.0
        spans, launch = self.by_name.get(name, []), self.profile.launch
        return sum(e - s for _, s, e, corr in self.profile.kernels
                   if corr in launch and _inside(spans, launch[corr])) / 1e9

    def info(self) -> dict:
        """The traced run's diagnostics of the program's spans, per packed
        step of the stretch (totals where it has no forward span)."""
        steps = self.steps or 1

        def per_step(by):
            return {k: dict(per_step=v[0] / steps, ms_per_step=v[1] / steps
                            / 1e6) for k, v in sorted(by.items())}
        waits = self._by_span(self.blocking, True)
        mallocs = self._by_span(self.mallocs, True)
        moe = self.launched_s("repro.moe")
        return dict(
            steps=self.steps,
            forward_wait_ms=self.forward_wait_ms,
            forward_waits_per_step=sum(v[0] for v in waits.values()) / steps,
            forward_waits_by_span=per_step(waits),
            other_waits_by_span=per_step(self._by_span(self.blocking,
                                                       False)),
            forward_idle_by_span=self.idle_by_span(),
            forward_mallocs_per_step=sum(v[0] for v in mallocs.values())
            / steps,
            forward_mallocs_by_span=per_step(mallocs),
            moe_route_share=(100.0 * self.launched_s("repro.moe.route") / moe
                             if moe else None),
            prefill_requests=len(self.prefill),
            prefill_steps_p50=harness.percentile(self.prefill, 50),
            prefill_steps_p95=self.prefill_steps_p95,
            prefill_steps_max=max(self.prefill, default=None))


def _run_locals(ctx) -> dict | None:
    """The locals of harness.run: the caller that holds this `ctx` beside
    its client loop and window."""
    f = sys._getframe(1)
    while f is not None:
        names = f.f_locals
        if names.get("ctx") is ctx and {"loop", "t_open",
                                         "t_close"} <= names.keys():
            return names
        f = f.f_back
    return None


def of(ctx) -> Program | None:
    """The run's Program: `ctx.program` where the harness hands one, else
    built once from the run's frame, kept on ctx, and its diagnostics
    logged."""
    prog = getattr(ctx, "program", None)
    if prog is not None:
        return prog
    run = _run_locals(ctx)
    if run is None:
        return None
    stretch, loop = run.get("stretch"), run["loop"]
    recs = loop.done + list(loop.inflight.values())
    prog = Program(host_events(stretch.prof) if stretch is not None else (),
                   ctx.profile, [(r["t_first"], r["req"]) for r in recs],
                   (run["t_open"], run["t_close"]))
    ctx.program = prog
    info = prog.info()
    steps = ctx.host["steps"] + len(ctx.stretch_steps)
    if steps:
        info.update(window_steps=steps, mean_step_ms=(
            run["t_close"] - run["t_open"]) / steps * 1e3)
    harness.log("program trace: " + json.dumps(info))
    return prog
