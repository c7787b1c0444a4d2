"""Integer-datapath constraints for HCCS calibration (paper §IV-C, eq. 11).

The port of `repro/core/constraints.py`: the feasibility test, the bounded
grid of feasible theta = (B, S, D), the batched validator and the
pre-calibration default.

    D <= 127                                  (int8-representable distance)
    B - S*D >= ceil(256/n)                    (score floor => Z >= 256)
    n*B <= 32767                              (Z <= 32767, int16-safe)
    B, S >= 0;  B > 0
"""
from __future__ import annotations

import numpy as np

T_I16 = 32767
D_MAX_HW = 127


def score_floor(n: int) -> int:
    """ceil(256/n): minimum per-element score so that Z >= 256."""
    return -(-256 // n)


def b_upper(n: int) -> int:
    """floor(32767/n): the tightest upper constraint on B."""
    return T_I16 // n


def is_feasible(B: int, S: int, D: int, n: int) -> bool:
    return (
        0 < B <= b_upper(n)
        and 0 <= S
        and 0 <= D <= D_MAX_HW
        and B - S * D >= score_floor(n)
    )


def feasible_grid(n: int, num_b: int = 16, num_s: int = 16,
                  d_values: tuple[int, ...] = (8, 16, 24, 32, 48, 64, 96, 127),
                  ) -> np.ndarray:
    """Enumerate a bounded integer grid of feasible (B, S, D) triples.

    Returns an int32 array (G, 3). The grid spans, for each D:
      S in [0, (b_upper - floor)/D] (log-ish spaced),
      B in [S*D + floor, b_upper].
    """
    bu = b_upper(n)
    fl = score_floor(n)
    triples: list[tuple[int, int, int]] = []
    for D in d_values:
        if D > D_MAX_HW:
            continue
        s_max = max((bu - fl) // max(D, 1), 0)
        s_vals = sorted({int(round(s)) for s in
                         np.geomspace(1, max(s_max, 1), num_s)} | {0})
        for S in s_vals:
            if S > s_max:
                continue
            b_lo = S * D + fl
            if b_lo > bu:
                continue
            b_vals = sorted({int(round(b))
                             for b in np.linspace(b_lo, bu, num_b)})
            for B in b_vals:
                if is_feasible(B, S, D, n):
                    triples.append((B, S, D))
    return np.asarray(sorted(set(triples)), dtype=np.int32)


def validate_params(B, S, D, n: int) -> None:
    """Raise if any (possibly batched) parameter violates the hardware
    region."""
    B, S, D = np.asarray(B), np.asarray(S), np.asarray(D)
    if not np.all(D <= D_MAX_HW):
        raise ValueError(f"D_max must be <= {D_MAX_HW}")
    if not np.all(B - S * D >= score_floor(n)):
        raise ValueError(f"score floor violated: need B - S*D >= "
                         f"{score_floor(n)} at n={n}")
    if not np.all(B * n <= T_I16):
        raise ValueError(f"n*B must be <= {T_I16} (n={n})")
    if not (np.all(B > 0) and np.all(S >= 0) and np.all(D >= 0)):
        raise ValueError("need B > 0, S >= 0, D >= 0")


def default_params(n: int) -> tuple[int, int, int]:
    """A safe mid-grid default (used before calibration runs)."""
    D = 64
    bu = b_upper(n)
    fl = score_floor(n)
    S = max((bu - fl) // (2 * D), 0)
    B = S * D + max(fl, (bu - S * D) // 2)
    B = min(B, bu)
    if not is_feasible(B, S, D, n):
        raise ValueError(f"default theta {(B, S, D)} infeasible at n={n}")
    return B, S, D
