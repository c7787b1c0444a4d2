"""Per-collective breakdown of a dry-run cell, for hillclimbing a layout;
the port of `repro/launch/inspect_hlo.py`, at the same path.

torch has no HLO. This reads the trace the dry-run takes instead
(`roofline.TraceCounter` around one step on meta DTensors over a fake
process group): every functional collective DTensor runs, grouped by kind
and result dtype+shape, with its bytes and count, then the step's FLOPs,
bytes and peak live temporaries per device.

    PYTHONPATH=src python -m repro_torch.launch.inspect_hlo \
        --arch granite-3-2b --shape prefill_32k --mesh pod [--layers 2]
"""
from __future__ import annotations

import argparse
import collections

import numpy as np

from repro_torch.launch.dryrun import (MESH_DEVICE, build_cell,
                                       init_fake_process_group)
from repro_torch.launch.mesh import (make_production_mesh,
                                     production_mesh_shape)


def breakdown(counter) -> list:
    """[(kind, shape, bytes, count)] of a TraceCounter's collectives,
    largest first."""
    buckets = collections.defaultdict(lambda: [0, 0])
    for kind, nbytes, shape in counter.collectives:
        buckets[(kind, shape)][0] += nbytes
        buckets[(kind, shape)][1] += 1
    return sorted(((k, s, b, c) for (k, s), (b, c) in buckets.items()),
                  key=lambda r: -r[2])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--layers", type=int, default=2,
                    help="trace with N layers (per-layer view)")
    ap.add_argument("--prob", default=None)
    ap.add_argument("--seq-parallel", default="on", choices=["on", "off"])
    ap.add_argument("--hot-buffer", type=int, default=0)
    ap.add_argument("--top", type=int, default=18)
    args = ap.parse_args(argv)

    multi_pod = args.mesh == "multipod"
    init_fake_process_group(int(np.prod(production_mesh_shape(multi_pod)[0])))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=MESH_DEVICE)
    run_fn, _ = build_cell(args.arch, args.shape, mesh, prob=args.prob,
                           num_layers=args.layers,
                           seq_parallel=(args.seq_parallel == "on"),
                           hot_buffer=args.hot_buffer)
    counter, _, _ = run_fn()
    rows = breakdown(counter)
    total = sum(r[2] for r in rows)
    print(f"\n== {args.arch} x {args.shape} x {args.mesh} "
          f"(L={args.layers}, SP={args.seq_parallel}) ==")
    print(f"total collective bytes (result shapes): {total/2**30:.2f} GiB")
    for kind, shape, b, c in rows[:args.top]:
        print(f"  {b/2**30:8.3f} GiB  x{c:<3d} {kind:20s} {shape}")
    print(f"flops {counter.flops:.3e}  bytes {counter.bytes:.3e}")
    print(f"temp {counter.peak_temp_bytes/2**30:.2f} GiB")
    return rows


if __name__ == "__main__":
    main()
