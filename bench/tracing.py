"""What a traced run reads: host spans and counters taken around the
program's calls from the benchmark's side, and the device trace of a
steady stretch of the window (torch.profiler, CUPTI).

Spans and counters (`Probe`), all installed only on a traced run:
  dispatch     host clock around the engine's device seam (`_packed_fn`),
               no fence: enqueueing the forward
  phases       host seconds of the engine's phases (admit, schedule,
               alloc_cow, device, sample, register), each also a
               `phase.<name>` record_function range in the device trace.
               `PhaseClock` stands in for the engine's StepProfiler with
               `enabled` off, so the engine takes no fence after its device
               phase: the traced program waits on the card only where the
               timed one does
  wait         host seconds inside serve/paged.py sample_tokens, which holds
               the step's wait for the card (the copy of the sampled tokens)
  pool         the KV blocks live at each counted step (the engine's
               allocator), against the usable pool
  schedule     each packed step's (frontier, tokens) per slot, read where
               the engine packs its lanes (serve/paged.py pack_slot_ids)
  moe          a `moe` record_function range around models/moe.py apply_moe
  stretch      a `bench.stretch` range around the profiled stretch

`Profile` reads the profiler's raw events once: the kernels, the ranges,
the runtime calls that launched each kernel (by correlation id), and from
them device busy time, time by kernel, time launched inside a range, and
the idle gaps named by the host phase they fell in."""
from __future__ import annotations

import bisect
import collections
import contextlib
import time

import torch

STRETCH = "bench.stretch"
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset")


class Probe:
    """Host spans and counters around one engine's calls; `counting`
    switches their accumulation on and off (the window outside the
    profiled stretch), `in_stretch` collects the stretch's schedule."""

    def __init__(self, eng):
        from repro_torch.models import moe as moe_mod
        from repro_torch.serve import paged

        self.eng = eng
        self.counting = False
        self.in_stretch = False
        self.steps = 0
        self.dispatch_s = 0.0
        self.stretch_steps: list[list[tuple[int, int]]] = []
        self.phase_s: dict[str, float] = {}
        self.wait_s = 0.0
        self.live_blocks = 0
        self.lanes_valid = self.lanes_total = 0
        self._phase0: dict[str, float] = {}
        self._restore = []

        seam = eng._packed_fn

        def timed_seam(*args):
            t0 = time.perf_counter()
            out = seam(*args)
            if self.counting:
                self.dispatch_s += time.perf_counter() - t0
                self.steps += 1
                self.live_blocks += eng.alloc.num_live
            return out
        eng._packed_fn = timed_seam

        self.clock = PhaseClock()
        self._restore.append((eng.telemetry, "profiler",
                              eng.telemetry.profiler))
        eng.telemetry.profiler = self.clock

        sample = paged.sample_tokens

        def waited(*a, **kw):
            t0 = time.perf_counter()
            out = sample(*a, **kw)
            if self.counting:
                self.wait_s += time.perf_counter() - t0
            return out
        paged.sample_tokens = waited
        self._restore.append((paged, "sample_tokens", sample))

        pack = paged.pack_slot_ids

        def packed(t_valid, width):
            if self.in_stretch:
                self.stretch_steps.append(
                    [(int(eng._lengths[s]), int(t_valid[s]))
                     for s in range(len(t_valid)) if t_valid[s] > 0])
            return pack(t_valid, width)
        paged.pack_slot_ids = packed
        self._restore.append((paged, "pack_slot_ids", pack))

        moe = moe_mod.apply_moe

        def tagged(*a, **kw):
            with torch.profiler.record_function("moe"):
                return moe(*a, **kw)
        moe_mod.apply_moe = tagged
        self._restore.append((moe_mod, "apply_moe", moe))

    def start_counting(self):
        self._phase0 = dict(self.clock.phase_seconds)
        self._lanes0 = (self.eng.lanes_valid, self.eng.lanes_total)
        self.counting = True

    def stop_counting(self):
        self.counting = False
        for k, v in self.clock.phase_seconds.items():
            self.phase_s[k] = (self.phase_s.get(k, 0.0) + v
                               - self._phase0.get(k, 0.0))
        self.lanes_valid += self.eng.lanes_valid - self._lanes0[0]
        self.lanes_total += self.eng.lanes_total - self._lanes0[1]

    def host(self) -> dict:
        """Host numbers of the counted steps: steps, dispatch seconds, the
        phases' seconds, the wait for the card, the lanes scheduled and the
        KV blocks live, summed over the steps."""
        return dict(steps=self.steps, dispatch_s=self.dispatch_s,
                    phase_s=dict(self.phase_s), wait_s=self.wait_s,
                    lanes_valid=self.lanes_valid,
                    lanes_total=self.lanes_total,
                    live_blocks=self.live_blocks,
                    pool_blocks=self.eng.alloc.num_blocks - 1)

    def close(self):
        for mod, name, fn in self._restore:
            setattr(mod, name, fn)


class PhaseClock:
    """In the engine's StepProfiler's place on a traced run: each phase
    timed on the host clock and marked as a `phase.<name>` range. `enabled`
    is False, as the timed run's profiler is, so the engine adds no fence."""

    enabled = False

    def __init__(self):
        self.phase_seconds: dict[str, float] = {}

    def step(self, name: str = "step"):
        return contextlib.nullcontext()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("phase." + name):
                yield
        finally:
            self.phase_seconds[name] = (self.phase_seconds.get(name, 0.0)
                                        + time.perf_counter() - t0)


@contextlib.contextmanager
def profiled(device):
    """torch.profiler over the body, fenced at both ends, inside a
    `bench.stretch` range; yields a holder whose `.prof` is the profiler
    once the body is done."""
    holder = type("Holder", (), {})()
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(STRETCH):
            yield holder
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    holder.prof = prof


def _merge(spans):
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Profile:
    """The raw events of one profiled stretch, read once. Times in ns on
    the profiler's clock; the properties in seconds."""

    def __init__(self, prof):
        self.kernels = []                  # (name, start, end, corr)
        self.ranges = collections.defaultdict(list)
        launch = {}
        # host calls that wait for the device (a diagnostic for the log)
        self.waits = collections.Counter()
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            if str(e.device_type()).endswith("CUDA"):
                if not e.is_user_annotation():
                    self.kernels.append((name, e.start_ns(), e.end_ns(),
                                         e.correlation_id()))
                continue
            if "Synchronize" in name or name == "cudaMemcpyAsync":
                self.waits[name] += 1
            if name.startswith(LAUNCH_CALLS):
                launch[e.correlation_id()] = e.start_ns()
            elif name == STRETCH or name == "moe" or name.startswith(
                    "phase."):
                self.ranges[name].append((e.start_ns(), e.end_ns()))
        self.launch = launch
        (a, b), = self.ranges[STRETCH] or [(0, 0)]
        if not self.ranges[STRETCH] and self.kernels:
            a = min(k[1] for k in self.kernels)
            b = max(k[2] for k in self.kernels)
        self.t0, self.t1 = a, b
        self.busy = _merge([(max(s, a), min(e, b)) for _, s, e, _ in
                            self.kernels if e > a and s < b])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def kernel_s(self, part: str) -> float:
        """Device seconds of the kernels whose name holds `part`."""
        return sum(e - s for n, s, e, _ in self.kernels if part in n) / 1e9

    def inside_s(self, tag: str) -> float | None:
        """Device seconds of the kernels launched inside the `tag` ranges,
        None where the stretch holds no such range."""
        ranges = sorted(self.ranges.get(tag, []))
        if not ranges:
            return None
        starts = [r[0] for r in ranges]
        total = 0
        for _, s, e, corr in self.kernels:
            t = self.launch.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= ranges[i][1]:
                total += e - s
        return total / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = collections.Counter()
        for name, s, e, _ in self.kernels:
            by[name[:160]] += (e - s) / 1e9
        return [[k, v] for k, v in by.most_common(n)]

    def idle_by_phase(self, n: int = 10) -> list:
        """Idle device time of the stretch, summed by the host phase it
        overlapped (`outside phases`: the host between steps or in the
        client loop)."""
        gaps, end = [], self.t0
        for s, e in self.busy:
            if s > end:
                gaps.append((end, s))
            end = max(end, e)
        if self.t1 > end:
            gaps.append((end, self.t1))
        phases = sorted((s, e, name[len("phase."):])
                        for name, rs in self.ranges.items()
                        if name.startswith("phase.") for s, e in rs)
        starts = [p[0] for p in phases]
        by = collections.Counter()
        for a, b in gaps:
            covered = 0
            i = max(bisect.bisect_right(starts, a) - 1, 0)
            while i < len(phases) and phases[i][0] < b:
                s, e, name = phases[i]
                ov = min(b, e) - max(a, s)
                if ov > 0:
                    by[name] += ov / 1e9
                    covered += ov
                i += 1
            by["outside phases"] += max(b - a - covered, 0) / 1e9
        return [[k, v] for k, v in by.most_common(n) if v > 0]
