"""One run of one cell: make the inputs from the seed, build the program's
engine, warm it, drive the closed loop through the window, then decide
`correct` against the plain reference and read the metrics.

    run(bench, cell, seed, seconds, trace, device) -> (result, check lines)

The program under test is `repro_torch`'s packed PagedEngine. The
harness drives it through submit and step; it reaches into the engine
only to warm the width ladder (one device step a rung) and, from outside,
to wrap its device seam and a few functions for spans, counters and the
logits it sampled from. Whatever is model-specific (the program's config,
the weights, the reference's logits, the work counts) comes from the
module that the configuration file names (spec.Bench.model)."""
from __future__ import annotations

import gc
import math
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from bench import check, spec
from bench import tracing as tr
from bench.reference.precision import Fp8

# top-level module names that may not be loaded when the result is printed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
STRETCH_S = 3.0             # length of a traced run's profiled stretch
CLOCK = time.perf_counter


def log(msg: str):
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def percentile(values, q: float):
    """q-th percentile with linear interpolation between ranks."""
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo, hi = math.floor(pos), math.ceil(pos)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class ClosedLoop:
    """The clients of a closed loop around one engine: each client has one
    request in flight, and sends its next as the engine returns the last.
    Every request's send, first-token and last-token times are stamped on
    the client side, after the step that produced them returned."""

    def __init__(self, eng, traffic):
        from repro_torch.serve.engine import Request
        self.Request = Request
        self.eng = eng
        self.traffic = traffic
        self.sent = 0
        self.inflight: dict[int, dict] = {}
        self.done: list[dict] = []
        self.generated = 0          # tokens generated since the count began
        for _ in range(traffic.clients):
            self.send()

    def send(self):
        prompt, new = self.traffic.request(self.sent)
        req = self.Request(uid=self.sent, prompt=prompt,
                           max_new_tokens=new)
        rec = dict(uid=self.sent, req=req, prompt=prompt, n=0,
                   t_send=CLOCK(), t_first=None, t_last=None, failed=False)
        self.sent += 1
        self.inflight[rec["uid"]] = rec
        self.eng.submit(req)

    def step(self):
        finished = self.eng.step()
        t = CLOCK()
        for rec in self.inflight.values():
            n = len(rec["req"].out_tokens)
            if n != rec["n"]:
                if rec["n"] == 0:
                    rec["t_first"] = t
                self.generated += n - rec["n"]
                rec["n"] = n
        for req in finished:
            rec = self.inflight.pop(req.uid)
            rec["t_last"] = t
            rec["failed"] = bool(req.failed)
            if rec["failed"] and rec["t_first"] is None:
                rec["t_first"] = math.inf
            rec["out"] = list(req.out_tokens)
            self.done.append(rec)
            self.send()
        return t


def warm_rungs(eng):
    """One device step at each width of the engine's ladder, every lane a
    pad lane writing the trash block."""
    for w in eng._widths:
        z = np.zeros(w, np.int32)
        cache, _ = eng._step_cache(
            block_table=eng._device_tables(), write_pos=eng._dev(z[None]),
            kv_len=eng._dev(z), slot_ids=eng._dev(np.full(w, -1, np.int32)))
        eng._packed_fn(eng._dev(z[None]), eng._dev(z[None]), cache,
                       eng._dev(np.zeros(eng.max_batch, np.int64)))


def window_metrics(loop, t_open, t_close, gen):
    """The end-to-end metrics of the window [t_open, t_close], from the
    clients' stamps."""
    first = [r for r in loop.done + list(loop.inflight.values())
             if r["t_first"] is not None and (
                 t_open <= r["t_first"] <= t_close
                 or (r["failed"] and t_open <= r["t_last"] <= t_close))]
    ttft = [r["t_first"] - r["t_send"] for r in first]
    fin = [r for r in loop.done if t_open <= r["t_last"] <= t_close
           and not r["failed"] and r["n"] > 1]
    tpot = [(r["t_last"] - r["t_first"]) / (r["n"] - 1) for r in fin]
    prompt = sum(len(r["prompt"]) for r in first if not r["failed"])
    span = t_close - t_open
    return dict(
        tok_s=(prompt + gen) / span,
        ttft_p95_ms=percentile([t * 1e3 for t in ttft], 95),
        tpot_p95_ms=percentile([t * 1e3 for t in tpot], 95),
    ), dict(attempted=len(first), failed=sum(r["failed"] for r in first),
            finished=len(fin), first_tokens=len(ttft), window_s=span)


def run(bench: spec.Bench, cell_name: str, seed: int, seconds: float,
        trace: bool, device, t_start: float, sizes=None,
        control: bool = False):
    """One run of a cell. `sizes` (tests only) replaces entries of the
    configuration file, the engine settings and the mix, to run a cell
    small on the CPU. `control` (bench/control.py) also reads the
    precision control on the same requests, into result["control"].
    Returns (result dict, the check lines)."""
    from repro_torch.kernels.decode import hccs_packed_prefill
    from repro_torch.serve.paged import PagedEngine

    device = torch.device(device)
    cell = bench.cell(cell_name)
    sizes = sizes or {}
    conf = dict(bench.config(cell["config"]), **sizes.get("config", {}))
    settings = bench.cell_settings(cell_name)
    engine_kw = dict(conf["engine"], **settings.get("engine", {}),
                     **sizes.get("engine", {}))
    mix = dict(bench.mix(cell["traffic"]), **sizes.get("mix", {}))
    model = bench.model(conf)
    ref_cfg = model.reference_config(conf)
    cfg = model.port_config(conf)
    gen = bench.generator(mix["kind"])
    traffic = gen.Traffic(mix, engine_kw, conf["vocab_size"], seed)

    w = model.make_weights(ref_cfg, seed, device)
    hccs = model.make_hccs(ref_cfg, seed, device)
    eng = PagedEngine({"weights": w, "hccs": hccs}, cfg, packed=True,
                      device=device, **engine_kw)
    warm_rungs(eng)
    log(f"{cell_name} seed {seed}: engine built, ladder {eng._widths} warm")
    probe = None
    if trace:
        probe = tr.Probe(eng)
        with tr.profiled(device):      # the profiler's first start is slow
            warm_rungs(eng)
    tap = check.OwnLogits(eng)
    loop = ClosedLoop(eng, traffic)
    while len(loop.done) < traffic.warm_requests:
        loop.step()
    _sync(device)
    log(f"warm phase done: {loop.sent} sent, {len(loop.done)} finished")

    # the window
    launches0 = hccs_packed_prefill.launches
    t_open = CLOCK()
    setup_s = t_open - t_start
    gen0 = loop.generated
    stretch = None
    if probe:
        probe.start_counting()
    t = t_open
    lo = t_open + seconds * 0.4
    while t - t_open < seconds:
        if (probe and stretch is None and t >= lo
                and t + STRETCH_S < t_open + seconds):
            stretch = _profile_stretch(loop, probe, device)
        t = loop.step()
    t_close = t
    e2e, counts = window_metrics(loop, t_open, t_close,
                                 loop.generated - gen0)
    launches = hccs_packed_prefill.launches - launches0
    _sync(device)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    e2e["setup_s"] = setup_s
    log(f"window closed: {counts}, {e2e}")

    per_layer, breakdown, dev_extra = {}, None, {}
    if probe:
        probe.stop_counting()
        h = probe.host()
        if h["steps"]:
            # how full the pool runs, beside the peak memory (a diagnostic)
            counts.update(
                pool_live_share=100.0 * h["live_blocks"] / h["steps"]
                / h["pool_blocks"],
                lanes_valid_per_step=h["lanes_valid"] / h["steps"])
        prof = tr.Profile(stretch.prof) if stretch is not None else None
        ctx = SimpleNamespace(
            cfg=ref_cfg, model=model, host=h, profile=prof,
            stretch_steps=probe.stretch_steps,
            stretch_sampled=stretch.sampled if stretch else None,
            pool_bytes=eng._cache["layers"]["k"].element_size())
        for m in bench.metrics(cell_name, "per_layer"):
            v = bench.reader(m["name"])(ctx)
            if v is not None:
                per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
        if prof is not None:
            log(f"profiled stretch: {len(prof.kernels)} device events, "
                f"window {prof.window_s:.3f} s, busy {prof.busy_s:.3f} s, "
                f"ranges {dict((k, len(v)) for k, v in prof.ranges.items())}"
                f", {len(probe.stretch_steps)} steps, host waits "
                f"{dict(prof.waits)}")
        if prof is not None and prof.kernels:
            dev_extra = dict(busy_s=prof.busy_s, window_s=prof.window_s)
            breakdown = dict(device_ops=prof.top_ops(),
                             idle_gaps=prof.idle_by_phase())
        probe.close()

    # correctness, after the program's state is freed
    own = tap.own()
    done = [r for r in loop.done if t_open <= r["t_last"] <= t_close
            and not r["failed"]]
    reqs = check.sample(done, seed, traffic.check_requests)
    del loop, eng, tap, probe
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = CLOCK()
    values = {}
    if reqs:
        ref = check.reference_logits(model, w, hccs, ref_cfg, reqs)
        values = check.readings(ref, reqs, own)
    ref_s = CLOCK() - t_ref
    low = None
    if control and reqs:
        low = check.control_readings(ref, check.reference_logits(
            model, w, hccs, ref_cfg, reqs, cast=Fp8()))
    log(f"reference {ref_s:.1f} s over {len(reqs)} requests: {values}")
    ok, checks = check.verdict(values, settings.get("limits", {}))
    ok = ok and counts["failed"] == 0

    if trace:
        metrics = per_layer
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in bench.metrics(cell_name, "end_to_end")
                   if e2e.get(m["name"]) is not None}
    result = dict(
        correct=ok, attempted=counts["attempted"], failed=counts["failed"],
        metrics=metrics,
        device=dict(platform="gpu" if device.type == "cuda" else "cpu",
                    kind=(torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu"),
                    count=1, memory_peak_bytes=int(peak), **dev_extra))
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["info"] = dict(counts, packed_launches=launches,
                          reference_s=ref_s,
                          checked_requests=len(reqs), readings=values,
                          end_to_end=e2e if trace else None)
    if low is not None:
        result["control"] = dict(program=values, fp8=low)
    result["checks"] = checks
    lines = [f"check {k} {c['value']} limit {c['limit']}"
             for k, c in checks.items()]
    return result, lines


def _profile_stretch(loop, probe, device):
    """STRETCH_S seconds of steps under torch.profiler, their host spans
    left out of the probe's counts. Returns the stretch: its profiler (read
    once the window has closed) and the tokens sampled in it."""
    probe.stop_counting()
    probe.in_stretch = True
    gen0 = loop.generated
    with tr.profiled(device) as held:
        end = CLOCK() + STRETCH_S
        while CLOCK() < end:
            loop.step()
    probe.in_stretch = False
    probe.start_counting()
    return SimpleNamespace(prof=held.prof, sampled=loop.generated - gen0)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)
