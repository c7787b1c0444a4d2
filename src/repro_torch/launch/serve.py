"""Serving launcher of the port: greedy requests through the packed paged
engine, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --requests 8 --prompt-len 256 --new-tokens 32

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \
        --reduced --device cpu                  # the CPU, plain kernels

Only the JAX launcher's `--scheduler paged` path is ported (so there is no
`--scheduler` flag). Attention runs the fused `hccs_packed_prefill` kernel
(`--decode-kernel fused` or `static_max`); `none` selects the STE attention
path, which is not ported yet (ROADMAP.md item A4).
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
    if args.decode_kernel == "none":
        raise NotImplementedError(
            "--decode-kernel none runs the STE attention path, not ported "
            "yet: ROADMAP.md item A4")

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import model as M
    from repro_torch.serve import PagedEngine, Request

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    cfg = cfg.replace(decode_kernel=args.decode_kernel, cache_layout="paged")
    params = M.init_params(cfg, seed=0, device=args.device)
    eng = PagedEngine(params, cfg, max_batch=args.max_batch,
                      max_len=args.prompt_len + args.new_tokens + 1,
                      block_size=args.block_size or None,
                      num_blocks=args.num_blocks or None,
                      device=args.device)
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
    print(f"served {len(done)} requests, {total_new} tokens in {dt:.2f}s "
          f"({total_new / dt:.1f} tok/s) on {eng.device} in "
          f"{eng.occupancy_steps} packed steps")
    pad = eng.padding_stats()
    print(f"step padding: {pad['lanes_valid']}/{pad['lanes_total']} "
          f"token-lanes valid ({100 * pad['efficiency']:.0f}%), "
          f"{pad['pad_lanes_skipped']} lanes skipped by packing")
    return done


if __name__ == "__main__":
    main()
