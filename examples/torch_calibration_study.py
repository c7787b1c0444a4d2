"""Calibration granularity study (paper Table II mechanics, standalone) on
the PyTorch port: generate heterogeneous attention heads, calibrate at three
granularities, report the KL each achieves and the chosen theta_h per head.
Every candidate theta's integer stages run through the `hccs_rows` kernel
on the card (its plain PyTorch version on the CPU).

    python examples/torch_calibration_study.py                # on the card
    python examples/torch_calibration_study.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.calibrate import calibrate_heads  # noqa: E402
from repro_torch.core.constraints import b_upper, score_floor  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402

L, H, R, N = 2, 4, 48, 64
GRANULARITIES = ("global", "per_layer", "per_head")


def make_rows(L=L, H=H, R=R, N=N, seed=0):
    """(L, H, R, N) float32 logit rows, one temperature a head (focused <->
    broad), their int8 scales amax / 127, and the (L, H) temperatures."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((L, H, R, N), np.float32)
    temps = np.linspace(0.4, 5.0, L * H).reshape(L, H)
    for l in range(L):
        for h in range(H):
            rows[l, h] = rng.normal(0, temps[l, h], (R, N))
    scales = np.abs(rows).max(axis=(2, 3)) / 127.0
    return rows, scales, temps


def study(rows, scales, device=None, log=print):
    """calibrate_heads at each granularity; {granularity: (theta, kl)}."""
    n = rows.shape[-1]
    out = {}
    for gran in GRANULARITIES:
        params, kl = calibrate_heads(rows, scales, n, granularity=gran,
                                     device=device)
        log(f"{gran:10s} mean KL {kl.mean():.4f}  per-head KL "
            f"{np.round(kl.flatten(), 3).tolist()}")
        out[gran] = (params, kl)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch version of the kernel)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rows, scales, temps = make_rows()
    print(f"feasible band at n={N}: floor={score_floor(N)}, "
          f"B_max={b_upper(N)}\n")
    results = study(rows, scales, device)

    params, kl = results["per_head"]
    print("\nper-head calibrated theta (B, S, D) vs head temperature:")
    for l in range(L):
        for h in range(H):
            print(f"  layer {l} head {h}: temp={temps[l, h]:.2f} -> "
                  f"B={int(params.B[l, h])}, S={int(params.S[l, h])}, "
                  f"D={int(params.D[l, h])}, KL={kl[l, h]:.3f}")
    print("\nfocused (high-temp) heads get steeper effective decay; broad "
          "heads flatter — exactly the heterogeneity per-head calibration "
          "captures.")
    return results


if __name__ == "__main__":
    main()
