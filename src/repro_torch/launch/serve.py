"""Serving launcher of the port: greedy requests through one of the three
engines, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 8 --prompt-len 256 --new-tokens 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu --scheduler continuous   # the CPU

`--scheduler` and `--step-layout` are the JAX launcher's flags:
`paged` (the port's default) is the paged engine, in its packed step layout
unless `--step-layout lockstep`; `continuous` and `wave` are the slot-arena
engines. `--decode-kernel fused|static_max` runs attention through the
CUDA kernels (the port's default); `none` runs the STE attention path, which
every layout except packed supports (the packed step without the kernel is
ROADMAP.md item A4).
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
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model runs (cpu: plain PyTorch kernels)")
    args = ap.parse_args(argv)
    if args.scheduler != "paged" and (args.step_layout is not None
                                      or args.block_size or args.num_blocks):
        raise SystemExit("--step-layout/--block-size/--num-blocks configure "
                         "the paged engine; use --scheduler paged")
    packed = args.scheduler == "paged" and args.step_layout != "lockstep"
    if packed and args.decode_kernel == "none":
        raise NotImplementedError(
            "--decode-kernel none with packed steps runs the per-slot STE "
            "grid, not ported yet: ROADMAP.md item A4 (use --step-layout "
            "lockstep or another scheduler)")

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.serve import (ContinuousEngine, PagedEngine, Request,
                                   ServeEngine)

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(decode_kernel=args.decode_kernel)
    params = M.init_params(cfg, seed=0, device=args.device)
    max_len = args.prompt_len + args.new_tokens + 1
    if args.scheduler == "paged":
        cfg = cfg.replace(cache_layout="paged")
        eng = PagedEngine(params, cfg, max_batch=args.max_batch,
                          max_len=max_len, packed=packed,
                          block_size=args.block_size or None,
                          num_blocks=args.num_blocks or None,
                          device=args.device)
    else:
        engine_cls = (ContinuousEngine if args.scheduler == "continuous"
                      else ServeEngine)
        eng = engine_cls(params, cfg, max_batch=args.max_batch,
                         max_len=max_len, device=args.device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        eng.submit(Request(uid=i, prompt=rng.integers(
            0, cfg.vocab_size, args.prompt_len).astype(np.int32),
            max_new_tokens=args.new_tokens))
    t0 = time.perf_counter()
    done = eng.run()
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
        pad = eng.padding_stats()
        print(f"step padding: {pad['lanes_valid']}/{pad['lanes_total']} "
              f"token-lanes valid ({100 * pad['efficiency']:.0f}%), "
              f"{pad['pad_lanes_skipped']} lanes skipped by packing")
    return done


if __name__ == "__main__":
    main()
