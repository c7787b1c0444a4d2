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
(scale reset to 0) has requant ratio 0, which zeroes its stale bytes.
Quantization rounds half away from zero (`quant/int8.py`). `draft_rows`
marks provisional rows (speculative verify lanes) that fold with the
block's existing scale clamped, never growing it.

The JAX package runs the fold as XLA (a lax.fori_loop, vmapped over layers
for the speculative replay), so it replaces no TPU kernel. Two wrappers
share the hand-written kernel `csrc/kv_quant.cu`:

  * `paged_quant_scatter_kv` folds a layer's K and V rows in ONE launch,
    with the fresh-block scale reset; given pools with a leading layer
    axis it folds every layer at once (the replay: JAX's vmap);
  * `paged_quant_scatter` folds one pool, the JAX function's own form.

Each dispatches on the pool's device: CUDA tensors launch the kernel (or
raise) and bump `paged_quant_scatter_kv.launches`, the one fold counter;
CPU tensors run the plain
versions beside them (`paged_quant_scatter_kv_ref`,
`paged_quant_scatter_ref`: the reference's loop row by row). All update the
pools and scales IN PLACE (the JAX step donates them to XLA for the same
effect) and agree bit for bit. The kernel reads the rows through their
strides, so the wrappers copy nothing.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import launch
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
FOLD_WARPS = 16                  # csrc/kv_quant.cu kWarps


def fold_smem_bytes(rows: int, block_size: int) -> int:
    """Dynamic shared memory of one CTA of the CUDA kernel for a launch of
    `rows` rows (csrc/kv_quant.cu paged_quant_scatter_kv_smem_bytes):
    eleven 4-byte arrays over the rows, a hash set of two 4-byte arrays over
    the next power of two >= 2 rows (at least 32), each warp's last writer
    per block position. A write of more rows than fit (3740 at block_size
    32 on the H100, beside the kernel's 264 B of static shared memory) is folded in consecutive slices, one launch each, from
    the one C call."""
    slots = 32
    while slots < 2 * rows:
        slots <<= 1
    return 44 * rows + 8 * slots + 4 * FOLD_WARPS * block_size


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


def paged_quant_scatter_kv_ref(k_pool, k_scales, k_rows, v_pool, v_scales,
                               v_rows, write_pos, draft_rows=None,
                               fresh_blocks=None):
    """Plain PyTorch version of `paged_quant_scatter_kv`: the fresh blocks'
    scales reset to 0, then `paged_quant_scatter_ref` for K, then for V,
    layer by layer where the pools carry a layer axis. Returns (k_pool,
    k_scales, v_pool, v_scales), updated in place."""
    if fresh_blocks is not None:
        idx = fresh_blocks.long()
        k_scales[..., idx, :] = 0.0
        v_scales[..., idx, :] = 0.0
    for pool, scales, rows in ((k_pool, k_scales, k_rows),
                               (v_pool, v_scales, v_rows)):
        if pool.dim() == 4:
            paged_quant_scatter_ref(pool, scales, rows, write_pos,
                                    draft_rows)
            continue
        for layer in range(pool.shape[0]):
            paged_quant_scatter_ref(pool[layer], scales[layer], rows[layer],
                                    write_pos, draft_rows)
    return k_pool, k_scales, v_pool, v_scales


def _check(pools, write_pos, draft_rows, fresh_blocks):
    """pools: ((pool, scales, rows), ...), one geometry for all."""
    pool0, _, rows0 = pools[0]
    shape, rshape = pool0.shape, rows0.shape
    if pool0.dtype != torch.int8 or len(shape) not in (4, 5):
        raise ValueError(f"pool must be int8 (N, Hkv, block_size, hd) or "
                         f"(L, N, Hkv, block_size, hd), got {pool0.dtype} "
                         f"{tuple(shape)}")
    lead = tuple(shape[:-4])
    n, hkv, _, hd = shape[-4:]
    for pool, scales, rows in pools:
        if pool.dtype != torch.int8 or pool.shape != shape:
            raise ValueError(f"pools must be int8 {tuple(shape)}, got "
                             f"{pool.dtype} {tuple(pool.shape)}")
        if scales.dtype != torch.float32 or scales.shape != (*lead, n, hkv):
            raise ValueError(f"scales must be float32 {(*lead, n, hkv)}, "
                             f"got {scales.dtype} {tuple(scales.shape)}")
        if (rows.shape != rshape or len(rshape) != len(shape)
                or rshape[:-4] != lead or rshape[-3] != hkv
                or rshape[-1] != hd):
            raise ValueError(f"new_kv must be ({', '.join(map(str, lead))}"
                             f"{', ' if lead else ''}B, {hkv}, t, {hd}), "
                             f"one shape for K and V, got "
                             f"{tuple(rows.shape)}")
        if rows.dtype not in ROW_TYPES or rows.dtype != rows0.dtype:
            raise TypeError(f"new_kv must be one of {ROW_TYPES}, one dtype "
                            f"for K and V, got {rows.dtype}")
    bt = rshape[-4:-3] + rshape[-2:-1]
    if write_pos.dtype != torch.int32 or write_pos.shape != bt:
        raise ValueError(f"write_pos must be int32 {tuple(bt)}, got "
                         f"{write_pos.dtype} {tuple(write_pos.shape)}")
    if draft_rows is not None and draft_rows.shape != bt:
        raise ValueError(f"draft_rows must be {tuple(bt)}, got "
                         f"{tuple(draft_rows.shape)}")
    if fresh_blocks is not None and fresh_blocks.dim() != 1:
        raise ValueError(f"fresh_blocks must be 1-D, got "
                         f"{tuple(fresh_blocks.shape)}")


def launch_args(pools, write_pos, draft_rows, fresh_blocks) -> tuple:
    """The C entry paged_quant_scatter_kv_launch's arguments for `pools`
    (one or two (pool, scales, rows), checked by `_check`) up to its
    stream: the rows by their strides; write_pos, draft_rows (bool or
    uint8) and fresh_blocks (int32) as they are where contiguous, else
    converted. Raises for what the kernel does not take."""
    pool0, _, rows0 = pools[0]
    layered = pool0.dim() == 5
    n, hkv, bs, hd = pool0.shape[-4:]
    b, _, t, _ = rows0.shape[-4:]
    if (bs * hd) % 4:
        raise ValueError(f"kernel takes block_size * head_dim a multiple of "
                         f"4, got {bs} x {hd}")
    smem = fold_smem_bytes(1, bs)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"block_size {bs} needs {smem} B of shared memory "
                         f"for one row, over the {MAX_SMEM_BYTES} B a block "
                         f"can have")
    dev = pool0.get_device()
    if any(x is not None and x.get_device() != dev for x in
           (*(a for p in pools for a in p), write_pos, draft_rows,
            fresh_blocks)):
        raise ValueError("all operands must lie on one device")
    if not all(p.is_contiguous() and s.is_contiguous() for p, s, _ in pools):
        raise ValueError("pools and scales must be contiguous")
    if not write_pos.is_contiguous():
        raise ValueError("write_pos must be contiguous")
    if draft_rows is not None and (
            draft_rows.dtype not in (torch.bool, torch.uint8)
            or not draft_rows.is_contiguous()):
        draft_rows = draft_rows.to(torch.uint8).contiguous()
    if fresh_blocks is not None and (fresh_blocks.dtype != torch.int32
                                     or not fresh_blocks.is_contiguous()):
        fresh_blocks = fresh_blocks.to(torch.int32).contiguous()
    strides = []
    for _, _, rows in pools:
        strides += rows.stride() if layered else (0, *rows.stride())
    strides += [0] * (10 - len(strides))
    v = pools[1] if len(pools) == 2 else (None, None, None)
    return (*pools[0], *v, write_pos, draft_rows, fresh_blocks,
            (ctypes.c_longlong * 10)(*strides),
            pool0.shape[0] if layered else 1, len(pools), n, hkv, bs, hd, b,
            t, 0 if fresh_blocks is None else fresh_blocks.numel(),
            POOL_TYPES[rows0.dtype])


def _launch(pools, write_pos, draft_rows, fresh_blocks):
    """One C call of csrc/kv_quant.cu over `pools`, counted on
    `paged_quant_scatter_kv`."""
    dev = pools[0][0].device
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    launch(paged_quant_scatter_kv, "paged_quant_scatter_kv_launch", dev,
           *launch_args(pools, write_pos, draft_rows, fresh_blocks))


def paged_quant_scatter_kv(k_pool, k_scales, k_rows, v_pool, v_scales,
                           v_rows, write_pos, draft_rows=None,
                           fresh_blocks=None):
    """Quantizing write of a step's K and V rows into their int8 pools, in
    ONE launch.

    k_pool, v_pool: (N, Hkv, block_size, hd) int8, or (L, N, Hkv,
    block_size, hd) to fold every layer at once; k_scales, v_scales: (N,
    Hkv) or (L, N, Hkv) float32 (0 marks a block never written since its
    reset); k_rows, v_rows: (B, Hkv, t, hd) or (L, B, Hkv, t, hd)
    float32/bfloat16/float16, one dtype, any strides; write_pos: (B, t)
    int32 flat positions block_id * block_size + row, each in [0, N *
    block_size) (pad lanes point into the trash block 0), one list for
    every layer and pool; draft_rows: optional (B, t) rows that fold with a
    clamped scale; fresh_blocks: optional (F,) block ids in [0, N) whose
    scales (of every layer given) reset to 0 before the fold. Returns
    (k_pool, k_scales, v_pool, v_scales), updated in place.

    CUDA tensors launch `csrc/kv_quant.cu` once (and bump
    `paged_quant_scatter_kv.launches`); CPU tensors run
    `paged_quant_scatter_kv_ref`."""
    pools = ((k_pool, k_scales, k_rows), (v_pool, v_scales, v_rows))
    _check(pools, write_pos, draft_rows, fresh_blocks)
    if k_pool.device.type == "cpu":
        return paged_quant_scatter_kv_ref(k_pool, k_scales, k_rows, v_pool,
                                          v_scales, v_rows, write_pos,
                                          draft_rows, fresh_blocks)
    _launch(pools, write_pos, draft_rows, fresh_blocks)
    return k_pool, k_scales, v_pool, v_scales


def paged_quant_scatter(pool, scales, new_kv, write_pos, draft_rows=None):
    """Quantizing write into one int8 paged pool with per-block scales: the
    JAX function's form.

    pool: (N, Hkv, block_size, hd) int8; scales: (N, Hkv) float32; new_kv:
    (B, Hkv, t, hd) float32/bfloat16/float16; write_pos, draft_rows as in
    `paged_quant_scatter_kv`. Returns (pool, scales), updated in place.

    CUDA tensors launch `csrc/kv_quant.cu` once (and bump
    `paged_quant_scatter_kv.launches`); CPU tensors run
    `paged_quant_scatter_ref`."""
    pools = ((pool, scales, new_kv),)
    _check(pools, write_pos, draft_rows, None)
    if pool.dim() != 4:
        raise ValueError(f"pool must be int8 (N, Hkv, block_size, hd), got "
                         f"{tuple(pool.shape)}")
    if pool.device.type == "cpu":
        return paged_quant_scatter_ref(pool, scales, new_kv, write_pos,
                                       draft_rows)
    _launch(pools, write_pos, draft_rows, None)
    return pool, scales


# C calls of the CUDA kernel in this process, through either wrapper (CPU
# calls never count)
paged_quant_scatter_kv.launches = 0
