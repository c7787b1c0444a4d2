"""Offline per-head calibration of HCCS parameters (paper §III-C, eq. 10) —
the port of `repro/core/calibrate.py`.

Grid search over the feasible integer region, minimizing the expected
KL( softmax(x_fp) || HCCS_int16(x_q; theta) ) over representative logit
rows. The objective is evaluated in int16 space (the paper finds the int8
objective non-smooth due to rounding local optima); the winning theta
transfers to the uint8 output path.

The integer stages of every candidate run through the `hccs_rows` kernel
(`kernels/hccs.py`): the rows of a group of heads are repeated once per
candidate theta and each copy carries its candidate as its per-row theta,
so one call evaluates many candidates x rows x heads. On CUDA tensors that
is the hand-written kernel; on CPU tensors its plain version. The KL then
follows the JAX package's f32 formula row by row.
"""
from __future__ import annotations

from typing import Literal

import numpy as np
import torch

from repro_torch.core import constraints
from repro_torch.core.hccs import HCCSParams
from repro_torch.device import resolve_device
from repro_torch.kernels.hccs import hccs_rows

Granularity = Literal["global", "per_layer", "per_head"]

# integer evaluations (candidates x rows x columns) per hccs_rows call: the
# call's int32 output and each of the KL's f32 temporaries take 4 bytes an
# evaluation
EVALS_PER_CALL = 1 << 27


def _kl_for_heads(x_q: torch.Tensor, p_ref: torch.Tensor, grid: torch.Tensor,
                  mode: str = "i16_div") -> torch.Tensor:
    """Mean KL over rows for every candidate triple, for each of a stack of
    heads.

    x_q:   (K, R, n) integer quantized logit rows (int8 values)
    p_ref: (K, R, n) float32 reference softmax of the *float* logits
    grid:  (G, 3) int32 candidate (B, S, D)
    returns (K, G) float32 mean KL.
    """
    k, r, n = x_q.shape
    g_all = grid.shape[0]
    per = max(1, EVALS_PER_CALL // max(k * r * n, 1))
    x8 = x_q.to(torch.int8)
    logp = torch.log(torch.clamp(p_ref, min=1e-20))
    out = []
    for g0 in range(0, g_all, per):
        cand = grid[g0:g0 + per].to(torch.int32)
        g = cand.shape[0]
        rows = x8[:, None].expand(k, g, r, n).reshape(-1, n)
        theta = cand[None, :, None].expand(k, g, r, 3).reshape(-1, 3)
        p = hccs_rows(rows, theta, mode=mode).view(k, g, r, n).float()
        p = p / torch.clamp(p.sum(-1, keepdim=True), min=1.0)
        # KL(p_ref || p); clamp q away from 0 (integer truncation can zero a
        # lane)
        q = torch.clamp(p, min=1e-9)
        kl = torch.sum(p_ref[:, None] * (logp[:, None] - torch.log(q)), -1)
        out.append(kl.mean(-1))
    return torch.cat(out, dim=1)


def _kl_for_grid(x_q: torch.Tensor, p_ref: torch.Tensor, grid: torch.Tensor,
                 mode: str = "i16_div") -> torch.Tensor:
    """Mean KL over rows for every candidate triple (one head).

    x_q:   (R, n) integer quantized logit rows
    p_ref: (R, n) float32 reference softmax of the *float* logits
    grid:  (G, 3) int32 candidate (B, S, D)
    returns (G,) float32 mean KL.
    """
    return _kl_for_heads(x_q[None], p_ref[None], grid, mode)[0]


def _head_inputs(x_fp: np.ndarray, scale, device):
    """(x_q, p_ref) tensors of float rows (..., R, n) on `device`: x_q is
    clip(round(x / scale), -128, 127) in float64 numpy, as the JAX package
    quantizes calibration rows (`scale` broadcasts), as int8."""
    x_q = np.clip(np.round(np.asarray(x_fp, np.float64) / scale), -128, 127)
    x_q = torch.from_numpy(x_q.astype(np.int8)).to(device)
    p_ref = torch.softmax(torch.from_numpy(
        np.ascontiguousarray(x_fp, np.float32)).to(device), dim=-1)
    return x_q, p_ref


def calibrate_rows(x_fp: np.ndarray, scale: float, n: int,
                   mode: str = "i16_div", grid: np.ndarray | None = None,
                   device=None) -> tuple[tuple[int, int, int], float]:
    """Calibrate one parameter set from float logit rows x_fp: (R, n).

    scale: int8 quantization scale for the logits (x_q = round(x/scale)).
    The grid runs on `device` (CUDA unless the caller names another).
    Returns ((B, S, D), best_kl)."""
    device = resolve_device(device)
    if grid is None:
        grid = constraints.feasible_grid(n)
    x_q, p_ref = _head_inputs(x_fp, scale, device)
    kls = _kl_for_grid(x_q, p_ref, torch.from_numpy(np.asarray(
        grid, np.int32)).to(device), mode).cpu().numpy()
    best = int(np.argmin(kls))
    B, S, D = (int(v) for v in grid[best])
    constraints.validate_params(B, S, D, n)
    return (B, S, D), float(kls[best])


def calibrate_heads(logit_rows: np.ndarray, scale: np.ndarray, n: int,
                    granularity: Granularity = "per_head",
                    mode: str = "i16_div", device=None,
                    ) -> tuple[HCCSParams, np.ndarray]:
    """Calibrate theta at the requested granularity (paper Table II
    ablation).

    logit_rows: (L, H, R, n) float — R representative rows per (layer, head).
    scale:      (L, H) float int8 scales per head (or broadcastable).
    The grid runs on `device` (CUDA unless the caller names another); per
    head, the heads share hccs_rows calls, as many as EVALS_PER_CALL
    allows. Returns (HCCSParams of (L, H) int32 tensors on the device,
    kl (L, H) float64)."""
    device = resolve_device(device)
    L, H, R, n_ = logit_rows.shape
    assert n_ == n
    scale = np.broadcast_to(np.asarray(scale, np.float64), (L, H))
    grid = constraints.feasible_grid(n)
    grid_t = torch.from_numpy(grid).to(device)
    B = np.zeros((L, H), np.int32)
    S = np.zeros((L, H), np.int32)
    D = np.zeros((L, H), np.int32)
    kl = np.zeros((L, H), np.float64)

    if granularity == "global":
        rows = logit_rows.reshape(L * H * R, n)
        (b, s, d), k = calibrate_rows(rows, float(scale.mean()), n, mode,
                                      grid, device)
        B[:], S[:], D[:], kl[:] = b, s, d, k
    elif granularity == "per_layer":
        for l in range(L):
            rows = logit_rows[l].reshape(H * R, n)
            (b, s, d), k = calibrate_rows(rows, float(scale[l].mean()), n,
                                          mode, grid, device)
            B[l], S[l], D[l], kl[l] = b, s, d, k
    elif granularity == "per_head":
        flat = logit_rows.reshape(L * H, R, n)
        flat_scale = scale.reshape(L * H, 1, 1)
        per = max(1, EVALS_PER_CALL // max(grid.shape[0] * R * n, 1))
        for h0 in range(0, L * H, per):
            x_q, p_ref = _head_inputs(flat[h0:h0 + per],
                                      flat_scale[h0:h0 + per], device)
            kls = _kl_for_heads(x_q, p_ref, grid_t, mode).cpu().numpy()
            for j, row in enumerate(kls):
                best = int(np.argmin(row))
                l, h = divmod(h0 + j, H)
                B[l, h], S[l, h], D[l, h] = grid[best]
                kl[l, h] = float(row[best])
        constraints.validate_params(B, S, D, n)
    else:
        raise ValueError(granularity)

    params = HCCSParams(*(torch.from_numpy(a).to(device) for a in (B, S, D)))
    return params, kl


def collect_attention_logits(logit_batches, max_rows_per_head: int = 256,
                             seed: int = 0) -> np.ndarray:
    """Stack per-head logit rows from a list of (L, H, B, T, n) score tensors
    (numpy arrays or tensors) into the (L, H, R, n) calibration tensor,
    subsampling rows with the JAX package's numpy draws."""
    rng = np.random.default_rng(seed)
    rows = None
    for batch in logit_batches:
        if isinstance(batch, torch.Tensor):
            batch = batch.detach().cpu().numpy()
        arr = np.asarray(batch)
        L, H = arr.shape[:2]
        flat = arr.reshape(L, H, -1, arr.shape[-1])
        take = min(max_rows_per_head, flat.shape[2])
        idx = rng.choice(flat.shape[2], size=take, replace=False)
        sel = flat[:, :, idx]
        rows = sel if rows is None else np.concatenate([rows, sel], axis=2)
    assert rows is not None, "no calibration batches provided"
    if rows.shape[2] > max_rows_per_head:
        idx = rng.choice(rows.shape[2], size=max_rows_per_head, replace=False)
        rows = rows[:, :, idx]
    return rows
