"""Fused two-pass HCCS attention: the port of `repro/kernels/attention.py`.

The HCCS pipeline fused into a flash-style attention, in the `wide`
semantics of the served model's blockwise attention:

  pass 0: q_int = clip(round(q.k * sm_scale / scale[h]), -128, 127) for
          every live key; m = the row max of q_int       (Stage 1)
  pass 1: s = B - S * min(m - q_int, D) (0 on masked keys); Z = sum s and
          acc = s @ V in f32                             (Stages 2-4)
  out   = acc / max(Z, 1), a true division               (Stage 5)

HCCS is linear in the active window, so pass 1 needs no per-block rescaling,
only the one final division. On the card pass 0 keeps q_int in shared
memory for pass 1 where a block's rows fit (`fused_plan`), and recomputes
it otherwise. `sm_scale` is the JAX kernel's constant 1 / sqrt(d), taken
in double and rounded once to f32, and it MULTIPLIES the f32 logits (the
decode kernels divide by sqrt(d) instead; the two constants agree at
d = 32, 64 and 128 and differ by an ulp at d = 96). Causal masking is
aligned at the start, cols <= rows, whatever Tk - Tq is.

`hccs_mha_fused` dispatches on the tensors' device: CUDA tensors launch the
hand-written kernel `csrc/hccs_fused.cu` (or raise) and bump
`hccs_mha_fused.launches`; CPU tensors run the plain PyTorch version beside
it, `hccs_mha_fused_ref`, which follows the JAX kernel's arithmetic (f32
products, then the multiply) rather than the JAX oracle's. There is no
fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import cuda_device, launch
from repro_torch.kernels.decode import MAX_SMEM_BYTES, NEG_BIG, POOL_TYPES

DTYPES = (torch.float32, torch.bfloat16)     # q, k, v and the output
# launch limits of csrc/hccs_fused.cu: 64 query-head rows per block, so a
# GQA group of at most 64 heads; 16 column groups of at most 8 columns
# (two groups of four a thread)
MAX_GROUP = 64
MAX_HEAD_DIM = 128
# the kernel's block: kRows query-head rows, a ring of two kKeys1-row K/V
# slots
ROWS, RING_ROWS = 64, 128


def fused_smem_bytes(head_dim: int, elem_size: int, nk_max: int,
                     cache: bool) -> int:
    """Dynamic shared memory of one block of the fused kernel
    (csrc/hccs_fused.cu fused_smem_bytes), at the tile width dq (head_dim
    rounded up to 32, 64 or 128): the queries (f32, row stride dq + 4) and
    the 64-key s tile (ROWS x 68 f32), one region when q_int is cached; a
    two-slot ring of RING_ROWS staged K/V rows a slot (row stride
    dq * elem + 16 bytes); the exchange of row maxima and Z (8 ints a row);
    and, cached, the int8 q_int of ROWS rows x nk_max keys (row stride
    nk_max rounded up to 64, plus 16)."""
    dq = 32 if head_dim <= 32 else 64 if head_dim <= 64 else 128
    qb = ROWS * (dq + 4) * 4
    sb = ROWS * 68 * 4
    ring = 2 * RING_ROWS * (dq * elem_size + 16)
    region = max(qb, sb) if cache else qb + sb
    return (region + ring + 8 * ROWS * 4
            + (ROWS * (-(-nk_max // 64) * 64 + 16) if cache else 0))


def fused_plan(tq: int, tk: int, head_dim: int, elem_size: int,
               causal: bool) -> tuple[bool, int]:
    """Which variant of the fused kernel a shape runs, and its dynamic
    shared memory: q_int kept in shared memory when a block's rows (who see
    at most min(tk, tq) keys under causal, else tk) fit, else QK recomputed
    in the second stage. The recompute variant fits at every shape the
    launch accepts."""
    nk_max = min(tk, tq) if causal else tk
    smem = fused_smem_bytes(head_dim, elem_size, nk_max, True)
    if smem <= MAX_SMEM_BYTES:
        return True, smem
    return False, fused_smem_bytes(head_dim, elem_size, nk_max, False)


def sm_scale(head_dim: int) -> float:
    """1 / sqrt(head_dim) as the f32 value the logits are multiplied by."""
    return float(np.float32(1.0 / float(head_dim) ** 0.5))


def mha_qint(q, k, scale, causal: bool):
    """The quantized logits (B, H, Tq, Tk) int32 of every query row against
    its kv head's keys (masked keys at NEG_BIG), and the live (Tq, Tk)
    mask: exactly the logits the kernel computes."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, hkv, h // hkv, tq, d)
    logits = torch.einsum("bkgqd,bktd->bkgqt", qg, k.float())
    logits = logits.reshape(b, h, tq, tk) * torch.tensor(
        sm_scale(d), dtype=torch.float32, device=q.device)
    logits = logits / scale.float().reshape(1, h, 1, 1)
    q_int = torch.clamp(torch.round(logits), -128, 127).to(torch.int32)
    rows = torch.arange(tq, device=q.device)[:, None]
    cols = torch.arange(tk, device=q.device)[None, :]
    valid = (cols <= rows) if causal else torch.ones(
        (tq, tk), dtype=torch.bool, device=q.device)
    return torch.where(valid, q_int, NEG_BIG), valid


def hccs_mha_fused_ref(q, k, v, scale, theta, *,
                       causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel. Arguments as in
    `hccs_mha_fused`."""
    b, h, tq, d = q.shape
    hkv, tk = k.shape[1], k.shape[2]
    q_int, valid = mha_qint(q, k, scale, causal)
    theta = theta.to(torch.int32)
    B = theta[:, 0].reshape(1, h, 1, 1)
    S = theta[:, 1].reshape(1, h, 1, 1)
    D = theta[:, 2].reshape(1, h, 1, 1)
    m = q_int.max(dim=-1, keepdim=True).values
    s = torch.where(valid, B - S * torch.minimum(m - q_int, D), 0).float()
    z = torch.clamp(s.sum(dim=-1, keepdim=True), min=1.0)
    acc = torch.einsum("bkgqt,bktd->bkgqd",
                       s.reshape(b, hkv, h // hkv, tq, tk), v.float())
    return (acc.reshape(b, h, tq, d) / z).to(q.dtype)


def hccs_mha_fused(q, k, v, scale, theta, *, causal: bool = True,
                   block_q: int = 128, block_k: int = 128,
                   qint_out=None) -> torch.Tensor:
    """Fused HCCS attention. q: (B, H, Tq, d); k, v: (B, Hkv, Tk, d); GQA
    maps query head h to kv head h // (H // Hkv). q, k and v share one
    dtype, float32 or bfloat16; the output is (B, H, Tq, d) in it.
    scale: (H,) per-head int8 logit scales (cast to float32); theta: (H, 3)
    (B, S, D) (cast to int32).

    `block_q` and `block_k` are accepted for parity with the JAX signature:
    the CUDA kernel's tiles (64 query-head rows, 64 keys) are its own
    choice, and `fused_plan` picks its variant from the shape. qint_out,
    for on-card testing only, is a contiguous int8 (B, H, Tq, Tk) CUDA
    tensor that receives the kernel's quantized logits at the live keys.

    CUDA tensors launch the kernel (and bump `hccs_mha_fused.launches`);
    CPU tensors run `hccs_mha_fused_ref`."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, H, Tq, d) and k, v one (B, Hkv, "
                         f"Tk, d) shape; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, tq, d = q.shape
    bk, hkv, tk, dk = k.shape
    if bk != b or dk != d or h % hkv or tk < 1:
        raise ValueError(f"inconsistent shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share one of {DTYPES}, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if tuple(scale.shape) != (h,) or tuple(theta.shape) != (h, 3):
        raise ValueError(f"scale must be ({h},) and theta ({h}, 3), got "
                         f"{tuple(scale.shape)} and {tuple(theta.shape)}")
    scale, theta = scale.to(torch.float32), theta.to(torch.int32)
    if q.device.type == "cpu":
        if qint_out is not None:
            raise ValueError("qint_out is a hook of the CUDA kernel")
        return hccs_mha_fused_ref(q, k, v, scale, theta, causal=causal)
    if h // hkv > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP} and "
                         f"head_dim <= {MAX_HEAD_DIM}, got {h // hkv} and "
                         f"{d}")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    scale, theta = scale.contiguous(), theta.contiguous()
    dev = cuda_device(q, k, v, scale, theta, qint_out)
    if qint_out is not None and (qint_out.dtype != torch.int8 or tuple(
            qint_out.shape) != (b, h, tq, tk)):
        raise ValueError(f"qint_out must be a contiguous int8 "
                         f"{(b, h, tq, tk)} tensor on {dev}")
    cache, _ = fused_plan(tq, tk, d, q.element_size(), causal)
    out = torch.empty_like(q)
    if b and tq:
        launch(hccs_mha_fused, "hccs_fused_launch", dev, q, k, v, scale,
               theta, out, qint_out, b, h, hkv, tq, tk, d,
               POOL_TYPES[q.dtype], int(causal), sm_scale(d), int(cache))
    return out


# launches of the CUDA kernel in this process (CPU calls never count)
hccs_mha_fused.launches = 0
