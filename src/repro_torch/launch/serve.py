"""Serving launcher of the port: greedy requests through one of the three
engines, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 8 --prompt-len 256 --new-tokens 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --scheduler continuous   # the CPU

Multi-turn chat (each request is a session; follow-up turns reuse the
prior turns' KV, prompt and generated, through decode-block sharing), on
int8 paged KV:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --decode-sharing --turns 4 --kv-quant int8

`--scheduler`, `--step-layout`, `--prefix-sharing`, `--decode-sharing`,
`--turns` and `--kv-quant` are the JAX launcher's flags: `paged` (the
port's default) is the paged engine, in its packed step layout unless
`--step-layout lockstep`; `continuous` and `wave` are the slot-arena
engines. `--decode-kernel fused|static_max` runs attention through the
CUDA kernels (the port's default); `none` runs the STE attention path (on
packed steps, the per-slot STE grid).
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
                    help="trie-driven speculative decoding (not ported yet: "
                         "the paged engine refuses it, ROADMAP.md item A6)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu: plain PyTorch kernels)")
    args = ap.parse_args(argv)
    if args.scheduler != "paged" and (args.step_layout is not None
                                      or args.block_size or args.num_blocks):
        raise SystemExit("--step-layout/--block-size/--num-blocks configure "
                         "the paged engine; use --scheduler paged")
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
    packed = args.scheduler == "paged" and args.step_layout != "lockstep"

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.serve import (ContinuousEngine, PagedEngine, Request,
                                   ServeEngine)
    from repro_torch.serve.engine import kv_cache_byte_stats

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(decode_kernel=args.decode_kernel)
    params = M.init_params(cfg, seed=0, device=args.device)
    # a session's history grows every turn: the cache must hold all of them
    max_len = args.turns * (args.prompt_len + args.new_tokens) + 1
    if args.scheduler == "paged":
        cfg = cfg.replace(cache_layout="paged",
                          prefix_sharing=args.prefix_sharing,
                          decode_sharing=args.decode_sharing,
                          kv_quant=args.kv_quant)
        eng = PagedEngine(params, cfg, max_batch=args.max_batch,
                          max_len=max_len, packed=packed,
                          block_size=args.block_size or None,
                          num_blocks=args.num_blocks or None,
                          speculative=args.speculative,
                          device=args.device)
    else:
        engine_cls = (ContinuousEngine if args.scheduler == "continuous"
                      else ServeEngine)
        eng = engine_cls(params, cfg, max_batch=args.max_batch,
                         max_len=max_len, device=args.device)
    rng = np.random.default_rng(0)
    # single-turn traffic under --prefix-sharing shares a system-prompt-like
    # prefix of ~3/4 of the prompt, rounded down to whole blocks (sharing is
    # block-granular); the --turns demo reuses its session histories instead
    shared_len = 0
    if args.prefix_sharing and args.turns == 1:
        bs = args.block_size or cfg.block_size
        shared_len = 3 * args.prompt_len // 4 // bs * bs
    shared = rng.integers(0, cfg.vocab_size, shared_len).astype(np.int32)
    t0 = time.perf_counter()
    done = []
    for turn in range(args.turns):
        for i in range(args.requests):
            msg = rng.integers(0, cfg.vocab_size,
                               args.prompt_len - shared_len).astype(np.int32)
            req = Request(uid=args.requests * turn + i,
                          prompt=np.concatenate([shared, msg]),
                          max_new_tokens=args.new_tokens)
            if args.turns > 1:
                eng.submit(req, session=f"session-{i}")
            else:
                eng.submit(req)
        done.extend(eng.run())
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    total_new = sum(len(r.out_tokens) for r in done)
    layout = (("packed" if packed else "lockstep")
              if args.scheduler == "paged" else args.scheduler)
    steps = (eng.decode_steps if args.scheduler == "wave"
             else eng.occupancy_steps)
    print(f"served {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {eng.device}: {layout}, "
          f"{steps} {'decode ' if args.scheduler != 'paged' else ''}steps")
    if args.scheduler == "paged":
        cb = kv_cache_byte_stats(eng._cache, cfg)
        store = "int8" if args.kv_quant == "int8" else cfg.cache_dtype
        print(f"kv cache: {cb['cache_bytes_logical'] / 2**20:.2f} MB "
              f"({store})")
        pad = eng.padding_stats()
        print(f"step padding: {pad['lanes_valid']}/{pad['lanes_total']} "
              f"token-lanes valid ({100 * pad['efficiency']:.0f}%), "
              f"{pad['pad_lanes_skipped']} lanes skipped by packing")
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
    return done


if __name__ == "__main__":
    main()
