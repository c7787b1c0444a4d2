"""Run one cell of BENCHMARK.json once and print its result as one JSON
line, the last of standard output:

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics (a steady stretch of the window under torch.profiler). Needs a
CUDA device; every build and kernel cache stays inside the checkout."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment():
    """The checkout's src and root on the import path, and caches inside
    the checkout at fixed paths."""
    here = ROOT / "bench"
    sys.path[:] = [str(ROOT / "src"), str(ROOT)] + [
        p for p in sys.path if Path(p or ".").resolve() != here]
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from bench import harness, spec

    bench = spec.Bench(ROOT)
    chips = bench.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench: the cell needs {chips} CUDA device(s); this benchmark "
              "measures the card only", file=sys.stderr)
        return 2
    result, lines = harness.run(bench, args.workload, args.seed,
                                args.seconds, bool(args.trace), "cuda:0",
                                T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"bench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    emit(result, lines)
    return 0


def emit(result: dict, lines: list[str], out=None, err=None):
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    err = err or sys.stderr
    for line in lines:
        print(line, file=err, flush=True)
    print(json.dumps(result), file=out or sys.stdout, flush=True)


if __name__ == "__main__":
    sys.exit(main())
