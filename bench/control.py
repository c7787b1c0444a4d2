"""The readings that set a cell's correctness limits, on the chip:

    python3 bench/control.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--out control.jsonl]

For each seed one run of the cell (set-up, warm phase, a window of
--seconds at the cell's own load, all in this one process), then the
numbers `correct` compares on its sampled requests: the program's
(`program`) and the precision control's (`fp8`: the reference with every
matrix product's operands in e4m3, put in the program's place). One JSON
line a seed. The lower reading of a limit is the largest the program gives
over the seeds, the upper the smallest the control gives."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from bench.run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import harness, spec

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.Bench(ROOT)
    out = open(args.out, "a") if args.out else None
    t0 = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        res, _ = harness.run(bench, args.workload, seed, args.seconds, False,
                             "cuda:0", t0, control=True)
        line = json.dumps(dict(workload=args.workload, seed=seed,
                               correct=res["correct"], **res["control"],
                               metrics=res["metrics"], info=res["info"]))
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
        t0 = time.perf_counter()
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
