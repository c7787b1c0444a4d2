"""Integer-datapath constraints for HCCS calibration (paper §IV-C, eq. 11).

The part of `repro/core/constraints.py` that the served model needs: the
feasibility test and the pre-calibration default theta = (B, S, D).

    D <= 127                                  (int8-representable distance)
    B - S*D >= ceil(256/n)                    (score floor => Z >= 256)
    n*B <= 32767                              (Z <= 32767, int16-safe)
    B, S >= 0;  B > 0
"""
from __future__ import annotations

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
