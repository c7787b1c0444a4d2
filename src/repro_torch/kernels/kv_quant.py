"""The quantizing write of an int8 paged KV pool: the port of
`paged_quant_scatter` (`repro/models/attention.py:170-241`).

Pools are (N, Hkv, block_size, hd) int8 with one symmetric scale per
(block, kv head), (N, Hkv) float32. Rows land one at a time, IN POSITION
ORDER (a fold):

    s_new   = max(s_old, max(amax(row), eps) * f32(1/127))   # grow-only
    payload = requant(payload, s_old -> s_new)
    payload[row] = quantize(row, s_new)

so a block's bytes are a pure function of its rows and their order, however
steps partition them: packed == lockstep, sharing on == off and a session
re-feed == a fresh prefill stay bit-exact under quantization. A fresh block
(scale reset to 0 by the engine) has requant ratio 0, which zeroes its
stale bytes. Quantization rounds half away from zero (`quant/int8.py`).
`draft_rows` marks provisional rows (speculative verify lanes) that fold
with the block's existing scale clamped, never growing it.

The JAX package runs the fold as XLA (a lax.fori_loop), so it replaces no
TPU kernel. `paged_quant_scatter` dispatches on the pool's device: CUDA
tensors launch the hand-written kernel `csrc/kv_quant.cu` (or raise) and
bump `paged_quant_scatter.launches`; CPU tensors run the plain version
beside it, `paged_quant_scatter_ref`, the reference's loop row by row. Both
update the pool and the scales IN PLACE (the JAX step donates them to XLA
for the same effect) and agree bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.build import cuda_device, launch
from repro_torch.kernels.decode import POOL_TYPES
from repro_torch.quant.int8 import round_to_int

# amax floor: a block whose rows are all (near-)zero still gets a positive
# scale, so the requant ratio and the dequant never divide by zero
KV_QUANT_EPS = 1e-6
# the scale rule multiplies by an explicit f32 reciprocal, as the JAX
# package writes it (csrc/kv_quant.cu kInvQmax is the same float)
KV_QUANT_INV_QMAX = np.float32(1.0 / 127.0)
ROW_TYPES = (torch.float32, torch.bfloat16, torch.float16)
MAX_SMEM_BYTES = 232448          # H100: dynamic shared memory per block


def fold_smem_bytes(rows: int, block_size: int, head_dim: int) -> int:
    """Dynamic shared memory of one block of the CUDA kernel for a write of
    `rows` rows (csrc/kv_quant.cu paged_quant_scatter_smem_bytes): the
    block's payload (int8) and its last writers' values (f32), six 4-byte
    arrays over the rows, one over the block's positions."""
    return 5 * block_size * head_dim + 24 * rows + 4 * block_size


def _flat_rows(new_kv, write_pos):
    """(B, Hkv, t, hd) rows and (B, t) targets in fold order: slot-major,
    then lane."""
    hkv, hd = new_kv.shape[1], new_kv.shape[3]
    return (new_kv.permute(0, 2, 1, 3).reshape(-1, hkv, hd),
            write_pos.reshape(-1))


def paged_quant_scatter_ref(pool, scales, new_kv, write_pos,
                            draft_rows=None):
    """Plain PyTorch version: the reference's fold, one row at a time.
    Arguments as in `paged_quant_scatter`. Returns (pool, scales), both
    updated in place."""
    bs = pool.shape[2]
    upd, pos = _flat_rows(new_kv, write_pos)
    upd = upd.float()
    eps = torch.tensor(KV_QUANT_EPS, dtype=torch.float32, device=pool.device)
    inv = torch.tensor(KV_QUANT_INV_QMAX, device=pool.device)
    draft = (None if draft_rows is None
             else draft_rows.reshape(-1).bool().tolist())
    for i, p in enumerate(pos.tolist()):
        blk, row = divmod(int(p), bs)
        x = upd[i]                                         # (Hkv, hd)
        s_old = scales[blk].clone()                        # (Hkv,)
        amax = x.abs().amax(-1)
        s_new = torch.maximum(s_old, torch.maximum(amax, eps) * inv)
        if draft is not None and draft[i]:
            s_new = torch.where(s_old > 0, s_old, s_new)
        ratio = s_old / s_new                              # s_new >= eps/127
        payload = torch.clamp(
            round_to_int(pool[blk].float() * ratio[:, None, None]),
            -128, 127)
        payload[:, row, :] = torch.clamp(round_to_int(x / s_new[:, None]),
                                         -128, 127)
        pool[blk] = payload.to(torch.int8)
        scales[blk] = s_new
    return pool, scales


def _check(pool, scales, new_kv, write_pos, draft_rows):
    if pool.dim() != 4 or pool.dtype != torch.int8:
        raise ValueError(f"pool must be int8 (N, Hkv, block_size, hd), got "
                         f"{pool.dtype} {tuple(pool.shape)}")
    n, hkv, _, hd = pool.shape
    if scales.dtype != torch.float32 or tuple(scales.shape) != (n, hkv):
        raise ValueError(f"scales must be float32 {(n, hkv)}, got "
                         f"{scales.dtype} {tuple(scales.shape)}")
    if (new_kv.dim() != 4 or new_kv.shape[1] != hkv
            or new_kv.shape[3] != hd):
        raise ValueError(f"new_kv must be (B, {hkv}, t, {hd}), got "
                         f"{tuple(new_kv.shape)}")
    if new_kv.dtype not in ROW_TYPES:
        raise TypeError(f"new_kv must be one of {ROW_TYPES}, got "
                        f"{new_kv.dtype}")
    b, _, t, _ = new_kv.shape
    if write_pos.dtype != torch.int32 or tuple(write_pos.shape) != (b, t):
        raise ValueError(f"write_pos must be int32 {(b, t)}, got "
                         f"{write_pos.dtype} {tuple(write_pos.shape)}")
    if draft_rows is not None and tuple(draft_rows.shape) != (b, t):
        raise ValueError(f"draft_rows must be {(b, t)}, got "
                         f"{tuple(draft_rows.shape)}")


def paged_quant_scatter(pool, scales, new_kv, write_pos, draft_rows=None):
    """Quantizing write into an int8 paged pool with per-block scales.

    pool: (N, Hkv, block_size, hd) int8; scales: (N, Hkv) float32 (0 marks
    a block never written since its reset); new_kv: (B, Hkv, t, hd)
    float32/bfloat16/float16; write_pos: (B, t) int32 flat positions
    block_id * block_size + row, each in [0, N * block_size) (pad lanes
    point into the trash block 0); draft_rows: optional (B, t) bool rows
    that fold with a clamped scale. Returns (pool, scales), updated in
    place.

    CUDA tensors launch `csrc/kv_quant.cu` once (and bump
    `paged_quant_scatter.launches`); CPU tensors run
    `paged_quant_scatter_ref`."""
    _check(pool, scales, new_kv, write_pos, draft_rows)
    if pool.device.type == "cpu":
        return paged_quant_scatter_ref(pool, scales, new_kv, write_pos,
                                       draft_rows)
    _, hkv, bs, hd = pool.shape
    if (bs * hd) % 4:
        raise ValueError(f"kernel takes block_size * head_dim a multiple of "
                         f"4, got {bs} x {hd}")
    smem = fold_smem_bytes(write_pos.numel(), bs, hd)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"a write of {write_pos.numel()} rows needs {smem} "
                         f"B of shared memory, over the {MAX_SMEM_BYTES} B "
                         f"a block can have")
    upd, pos = _flat_rows(new_kv, write_pos)
    upd, pos = upd.contiguous(), pos.contiguous()
    draft = (None if draft_rows is None
             else draft_rows.reshape(-1).to(torch.uint8).contiguous())
    dev = cuda_device(pool, scales, upd, pos, draft)
    launch(paged_quant_scatter, "paged_quant_scatter_launch", dev, pool,
           scales, upd, pos, draft, pos.shape[0], hkv, bs, hd,
           POOL_TYPES[upd.dtype])
    return pool, scales


# launches of the CUDA kernel in this process (CPU calls never count)
paged_quant_scatter.launches = 0
