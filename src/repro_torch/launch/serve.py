"""Serving launcher of the port: greedy requests through one of the three
engines, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 8 --prompt-len 256 --new-tokens 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --scheduler continuous   # the CPU

`--arch` takes every token-input arch of the registry, as the JAX launcher
does: MoE models (granite-moe-1b-a400m, qwen3-moe-235b-a22b) on every
engine; the SSM and hybrid models (mamba2-1.3b, hymba-1.5b) on the wave and
continuous engines (the paged engine refuses them, as JAX's does); the
embedding-input archs (musicgen-large, qwen2-vl-2b) are refused.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-1b-a400m --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-1.3b \
        --reduced --device cpu --scheduler wave

Multi-turn chat (each request is a session; follow-up turns reuse the
prior turns' KV, prompt and generated, through decode-block sharing), on
int8 paged KV:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --decode-sharing --turns 4 --kv-quant int8

Speculative decoding, and the robustness layer under a seeded chaos run:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --decode-sharing --turns 3 --speculative
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --chaos 0 --priority-classes 3

The pipelined async loop with telemetry (latency percentiles, the step
phases, a Chrome trace), and an open-loop Poisson load at 2 requests/s:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --async-loop --telemetry --trace-out t.jsonl
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --arrival-rate 2

`--scheduler`, `--step-layout`, `--token-budget`, `--prefix-sharing`,
`--decode-sharing`, `--turns`, `--kv-quant`, `--speculative`,
`--draft-len`, `--async-loop`, `--priority-classes`, `--deadline-ms`,
`--queue-limit`, `--backpressure`, `--chaos`, `--telemetry`, `--trace-out`
and `--arrival-rate` are the JAX launcher's flags, with its guards:
`paged` (the port's default) is the paged engine, in its packed step
layout unless `--step-layout lockstep`; `continuous` and `wave` are the
slot-arena engines. `--decode-kernel fused|static_max` runs attention
through the CUDA kernels (the port's default); `none` runs the STE
attention path (on packed steps, the per-slot STE grid).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--scheduler", default="paged",
                    choices=["wave", "continuous", "paged"])
    ap.add_argument("--step-layout", default=None,
                    choices=["packed", "lockstep"],
                    help="paged step layout (default packed): 'packed' "
                         "flattens each step to a ragged token batch; "
                         "'lockstep' keeps the (B, block_size)/(B, 1) shapes")
    ap.add_argument("--decode-kernel", default="fused",
                    choices=["none", "fused", "static_max"])
    ap.add_argument("--block-size", type=int, default=0,
                    help="paged KV block size (0 = cfg.block_size)")
    ap.add_argument("--num-blocks", type=int, default=0,
                    help="paged KV pool size (0 = cfg.num_blocks, or "
                         "auto-size to half the dense arena)")
    ap.add_argument("--prefix-sharing", action="store_true",
                    help="reuse full-block prompt-prefix KV across requests "
                         "(refcounted copy-on-write blocks; paged scheduler "
                         "only)")
    ap.add_argument("--decode-sharing", action="store_true",
                    help="additionally cache GENERATED blocks as they fill, "
                         "so multi-turn sessions (--turns) reuse prior "
                         "replies' KV; implies --prefix-sharing (paged "
                         "scheduler only)")
    ap.add_argument("--turns", type=int, default=1,
                    help="serve each request as a session of this many chat "
                         "turns, each a fresh --prompt-len user message on "
                         "top of the stored history (paged scheduler only)")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="store paged KV blocks as int8 with per-block "
                         "per-kv-head scales (paged scheduler only)")
    ap.add_argument("--speculative", action="store_true",
                    help="trie-driven speculative decoding: draft up to "
                         "--draft-len tokens per decode step from the prefix "
                         "trie (n-gram prompt-lookup fallback) and verify "
                         "them all in ONE packed step; greedy outputs are "
                         "token-identical (paged scheduler, packed layout)")
    ap.add_argument("--draft-len", type=int, default=4,
                    help="max draft tokens per decode step (--speculative)")
    ap.add_argument("--async-loop", action="store_true",
                    help="pipeline the paged engine's step loop: dispatch "
                         "step N+1 while step N's sampled tokens are still "
                         "in flight, committing host bookkeeping one step "
                         "behind (greedy outputs stay token-identical; "
                         "paged scheduler, packed layout)")
    ap.add_argument("--token-budget", type=int, default=0,
                    help="packed-step token lanes per chunk step "
                         "(0 = max_batch * block_size, one lockstep chunk "
                         "step's lane count)")
    ap.add_argument("--priority-classes", type=int, default=1, metavar="N",
                    help="assign requests round-robin to N priority classes "
                         "(0 = lowest); admission serves the highest class "
                         "first and the paged engine may PREEMPT a lower "
                         "class's blocks (continuous/paged scheduler)")
    ap.add_argument("--deadline-ms", type=float, default=0.0, metavar="T",
                    help="per-request end-to-end deadline in milliseconds; "
                         "requests past it fail at the next step boundary "
                         "with their blocks freed (continuous/paged)")
    ap.add_argument("--queue-limit", type=int, default=0, metavar="N",
                    help="bound the admission queue (not running slots) to "
                         "N requests; overflow is resolved by "
                         "--backpressure (0 = unbounded; continuous/paged)")
    ap.add_argument("--backpressure", default="reject",
                    choices=["reject", "shed-lowest-priority"],
                    help="bounded-queue overflow policy: 'reject' refuses "
                         "the incoming request (QueueFull); "
                         "'shed-lowest-priority' drops the lowest-class "
                         "newest QUEUED request instead")
    ap.add_argument("--chaos", type=int, default=None, metavar="SEED",
                    help="replace the demo with a seeded fault-injection "
                         "run (serve/chaos.py): bursts, allocator "
                         "exhaustion, cancels, preemption storms, device "
                         "failures, engine invariants asserted after every "
                         "step, the pool drained at the end (paged only)")
    ap.add_argument("--telemetry", action="store_true",
                    help="record request lifecycles (TTFT/TPOT/E2E "
                         "percentiles) and per-step phase timings, and print "
                         "the unified telemetry snapshot after serving")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the step-phase timeline as Chrome-trace "
                         "JSONL to PATH (load in Perfetto or "
                         "chrome://tracing); implies --telemetry")
    ap.add_argument("--arrival-rate", type=float, default=0.0, metavar="R",
                    help="serve OPEN-LOOP: requests arrive on a seeded "
                         "Poisson process at R req/s instead of being "
                         "batch-drained, so latency percentiles include real "
                         "queueing (continuous/paged scheduler, single-turn "
                         "only); implies --telemetry")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu: plain PyTorch kernels)")
    args = ap.parse_args(argv)
    if args.scheduler != "paged" and (args.step_layout is not None
                                      or args.block_size or args.num_blocks
                                      or args.token_budget):
        raise SystemExit("--step-layout/--block-size/--num-blocks/"
                         "--token-budget configure the paged engine; use "
                         "--scheduler paged")
    if args.scheduler != "paged" and (args.prefix_sharing
                                      or args.decode_sharing
                                      or args.turns > 1
                                      or args.kv_quant != "none"
                                      or args.speculative):
        raise SystemExit("--prefix-sharing/--decode-sharing/--turns/"
                         "--kv-quant/--speculative need the block pool; use "
                         "--scheduler paged")
    if args.turns < 1:
        raise SystemExit(f"--turns must be >= 1, got {args.turns}")
    if args.speculative and args.step_layout == "lockstep":
        raise SystemExit("--speculative verifies all drafts in one packed "
                         "step; drop --step-layout lockstep")
    if args.async_loop and args.scheduler != "paged":
        raise SystemExit("--async-loop pipelines the paged engine's packed "
                         "token step; use --scheduler paged")
    if args.async_loop and args.step_layout == "lockstep":
        raise SystemExit("--async-loop pipelines the packed token step; "
                         "drop --step-layout lockstep")
    if args.arrival_rate < 0:
        raise SystemExit(f"--arrival-rate must be >= 0, got "
                         f"{args.arrival_rate}")
    if args.arrival_rate and args.scheduler == "wave":
        raise SystemExit("--arrival-rate drives the step-at-a-time engines; "
                         "the wave scheduler serves whole waves (use "
                         "--scheduler continuous or paged)")
    if args.arrival_rate and args.turns > 1:
        raise SystemExit("--arrival-rate is a single-turn open-loop load "
                         "test; drop --turns")
    if args.priority_classes < 1:
        raise SystemExit(f"--priority-classes must be >= 1, got "
                         f"{args.priority_classes}")
    if args.deadline_ms < 0:
        raise SystemExit(f"--deadline-ms must be >= 0, got "
                         f"{args.deadline_ms}")
    if args.queue_limit < 0:
        raise SystemExit(f"--queue-limit must be >= 0, got "
                         f"{args.queue_limit}")
    robust_on = bool(args.priority_classes > 1 or args.deadline_ms
                     or args.queue_limit or args.chaos is not None)
    if robust_on and args.scheduler == "wave":
        raise SystemExit("--priority-classes/--deadline-ms/--queue-limit/"
                         "--chaos drive the step-at-a-time admission layer; "
                         "use --scheduler continuous or paged")
    if args.chaos is not None and args.scheduler != "paged":
        raise SystemExit("--chaos injects faults into the paged block pool; "
                         "use --scheduler paged")
    if args.chaos is not None and (args.turns > 1 or args.arrival_rate):
        raise SystemExit("--chaos drives its own submission schedule; drop "
                         "--turns/--arrival-rate")
    telemetry_on = bool(args.telemetry or args.trace_out
                        or args.arrival_rate)
    packed = args.scheduler == "paged" and args.step_layout != "lockstep"

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.serve import (AdmissionConfig, ChaosMonkey,
                                   ContinuousEngine, PagedEngine, QueueFull,
                                   Request, ServeEngine, Telemetry,
                                   drive_open_loop, format_snapshot)
    from repro_torch.serve.engine import kv_cache_byte_stats

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(decode_kernel=args.decode_kernel)
    if cfg.input_mode == "embeddings":
        raise SystemExit(f"{args.arch} takes embedding inputs; the serve demo "
                         "targets token models")
    params = M.init_params(cfg, seed=0, device=args.device)
    # a session's history grows every turn: the cache must hold all of them
    max_len = args.turns * (args.prompt_len + args.new_tokens) + 1
    tel = Telemetry(enabled=telemetry_on)
    # the robustness layer is opt-in (preemption needs the block pool)
    admission = None
    if robust_on:
        admission = AdmissionConfig(max_queue=args.queue_limit or None,
                                    backpressure=args.backpressure,
                                    preemption=(args.scheduler == "paged"))
    if args.scheduler == "paged":
        cfg = cfg.replace(cache_layout="paged",
                          prefix_sharing=args.prefix_sharing,
                          decode_sharing=args.decode_sharing,
                          kv_quant=args.kv_quant)
        eng = PagedEngine(params, cfg, max_batch=args.max_batch,
                          max_len=max_len, packed=packed,
                          block_size=args.block_size or None,
                          num_blocks=args.num_blocks or None,
                          token_budget=args.token_budget or None,
                          speculative=args.speculative,
                          draft_len=args.draft_len,
                          async_loop=args.async_loop, telemetry=tel,
                          admission=admission, device=args.device)
    else:
        engine_cls = (ContinuousEngine if args.scheduler == "continuous"
                      else ServeEngine)
        kw = {} if args.scheduler == "wave" else dict(admission=admission)
        eng = engine_cls(params, cfg, max_batch=args.max_batch,
                         max_len=max_len, telemetry=tel, device=args.device,
                         **kw)
    rng = np.random.default_rng(0)
    # single-turn traffic under --prefix-sharing shares a system-prompt-like
    # prefix of ~3/4 of the prompt, rounded down to whole blocks (sharing is
    # block-granular); the --turns demo reuses its session histories instead
    shared_len = 0
    if args.prefix_sharing and args.turns == 1:
        bs = args.block_size or cfg.block_size
        shared_len = 3 * args.prompt_len // 4 // bs * bs
    shared = rng.integers(0, cfg.vocab_size, shared_len).astype(np.int32)

    def robust_kw(i):
        """Request i's robustness fields (none when the layer is off)."""
        kw = {}
        if args.priority_classes > 1:
            kw["priority"] = int(i % args.priority_classes)
        if args.deadline_ms:
            kw["deadline_e2e"] = args.deadline_ms / 1000.0
        return kw

    if args.arrival_rate:
        # the open-loop load test warms the engine with one drained request
        # first, so first-call costs do not head the latency distribution
        warm = rng.integers(0, cfg.vocab_size,
                            args.prompt_len).astype(np.int32)
        eng.submit(Request(uid=-1, prompt=warm, max_new_tokens=2))
        eng.run()
        tel.reset()
    t0 = time.perf_counter()
    if args.chaos is not None:
        crng = np.random.default_rng(args.chaos)

        def mk(i):
            plen = int(crng.integers(4, args.prompt_len + 1))
            return Request(
                uid=i, prompt=crng.integers(0, cfg.vocab_size,
                                            plen).astype(np.int32),
                max_new_tokens=int(crng.integers(2, args.new_tokens + 1)),
                **robust_kw(i))

        report = ChaosMonkey(eng, seed=args.chaos, make_request=mk,
                             n_requests=args.requests).run()
        done = report["finished"] + report["failed"]
        faults = ", ".join(f"{k} x{v}"
                           for k, v in sorted(report["faults"].items()))
        print(f"chaos(seed={args.chaos}): survived {report['steps']} steps "
              f"- {report['submitted']} submitted, "
              f"{len(report['finished'])} finished, "
              f"{len(report['failed'])} failed; "
              f"faults: {faults or 'none injected'}")
        print("invariants held after every step; pool fully reclaimed")
    elif args.arrival_rate:
        # arrivals come from a seeded Poisson process and do not wait for
        # the system, so queueing shows up in TTFT
        reqs = []
        for i in range(args.requests):
            tail = rng.integers(0, cfg.vocab_size,
                                args.prompt_len - shared_len).astype(np.int32)
            reqs.append(Request(uid=i, prompt=np.concatenate([shared, tail]),
                                max_new_tokens=args.new_tokens,
                                **robust_kw(i)))
        arrivals = np.cumsum(rng.exponential(1.0 / args.arrival_rate,
                                             args.requests))
        done = drive_open_loop(eng, reqs, arrivals)
    else:
        done = []
        for turn in range(args.turns):
            for i in range(args.requests):
                msg = rng.integers(
                    0, cfg.vocab_size,
                    args.prompt_len - shared_len).astype(np.int32)
                req = Request(uid=args.requests * turn + i,
                              prompt=np.concatenate([shared, msg]),
                              max_new_tokens=args.new_tokens,
                              **robust_kw(i))
                try:
                    if args.turns > 1:
                        eng.submit(req, session=f"session-{i}")
                    else:
                        eng.submit(req)
                except QueueFull:
                    pass     # counted in robust_counters.rejected below
            done.extend(eng.run())
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    layout = (("packed" if packed else "lockstep")
              if args.scheduler == "paged" else args.scheduler)
    steps = (eng.decode_steps if args.scheduler == "wave"
             else eng.occupancy_steps)
    mode = (f" open-loop at {args.arrival_rate:g} req/s"
            if args.arrival_rate else "")
    print(f"served {len(done)} requests{mode}, {total_new} tokens in "
          f"{dt:.2f}s ({total_new / dt:.1f} tok/s) on {eng.device}: "
          f"{layout}, {steps} "
          f"{'decode ' if args.scheduler != 'paged' else ''}steps")
    if args.async_loop:
        print(f"async loop: {eng.async_overlapped_steps} steps overlapped, "
              f"{eng.async_sync_fallbacks} sync fallbacks")
    if args.scheduler == "paged":
        cb = kv_cache_byte_stats(eng._cache, cfg)
        store = "int8" if args.kv_quant == "int8" else cfg.cache_dtype
        print(f"kv cache: {cb['cache_bytes_logical'] / 2**20:.2f} MB "
              f"({store})")
        pad = eng.padding_stats()
        print(f"step padding: {pad['lanes_valid']}/{pad['lanes_total']} "
              f"token-lanes valid ({100 * pad['efficiency']:.0f}%), "
              f"{pad['pad_lanes_skipped']} lanes skipped by packing")
    if robust_on:
        rb = eng.robust_counters.snapshot()
        dm, rp = rb["deadline_misses"], rb["reprefill"]
        print(f"robustness: {rb['preemptions']} preemptions "
              f"({rb['exhaustion_events']} pool-exhaustion reclaims), "
              f"{rb['shed']} shed, {rb['rejected']} rejected, "
              f"{rb['cancelled']} cancelled, {dm['total']} deadline misses "
              f"(ttft {dm['ttft']}, e2e {dm['e2e']}), re-prefill "
              f"{rp['skipped']}/{rp['tokens']} tokens skipped")
        if args.priority_classes > 1:
            for p, c in sorted(rb["per_class"].items(),
                               key=lambda kv: -int(kv[0])):
                print(f"  class {p}: {c['submitted']} submitted, "
                      f"{c['finished']} finished, {c['preempted']} "
                      f"preempted, {c['deadline_misses']} deadline misses, "
                      f"{c['shed'] + c['rejected']} shed/rejected")
    if args.speculative:
        s = eng.prefix_stats()
        rate = s["acceptance_rate"]
        print(f"speculative: {s['tokens_drafted']} drafted, "
              f"{s['tokens_accepted']} accepted, "
              f"{s['tokens_rejected']} rejected "
              f"({'n/a' if rate is None else f'{100 * rate:.0f}%'} "
              f"acceptance) over {s['spec_steps']} verify steps, "
              f"{s['spec_rollbacks']} rollbacks")
    if args.prefix_sharing or args.decode_sharing:
        s = eng.prefix_stats()
        print(f"prefix sharing: {s['hits']}/{s['lookups']} hits "
              f"({s['prompt_hits']} prompt-block, {s['decode_hits']} "
              f"decode-block), {s['prefill_tokens_skipped']}/"
              f"{s['prefill_tokens']} prefill tokens skipped "
              f"({100 * s['skip_rate']:.0f}%), {s['cow_copies']} COW "
              f"copies, {s['evictions']} evictions, {s['cached_blocks']} "
              f"blocks cached ({s['cached_decode_blocks']} from decode)")
        if args.turns > 1:
            print(f"sessions: {100 * s['followup_skip_rate']:.0f}% of "
                  f"follow-up-turn prefill tokens "
                  f"({s['followup_tokens_skipped']}/"
                  f"{s['followup_prefill_tokens']}) served from cached KV")
    if telemetry_on:
        print(format_snapshot(eng.snapshot()))
    if args.trace_out:
        n = tel.profiler.write_chrome_trace(args.trace_out)
        print(f"wrote {n} trace events to {args.trace_out} "
              f"(load in Perfetto / chrome://tracing)")
    return done


if __name__ == "__main__":
    main()
