"""Token-centric packed HCCS attention over a paged KV pool.

`hccs_packed_prefill` is the port of the Pallas kernel of the same name
(repro/kernels/decode.py `hccs_packed_prefill` / `_packed_kernel` +
`_decode_tile`). Every packed engine step runs it once per layer: each of
the T packed tokens (prefill-chunk tokens and decode lanes alike) runs one
single-query HCCS sweep over the KV of its OWNING slot, walked through
`block_table[slot_ids[t]]` up to the token's causal frontier `lengths[t]`.

The wrapper dispatches on the tensors' device: CUDA tensors launch the
hand-written kernel in `csrc/hccs_packed.cu` (or raise); CPU tensors run the
plain PyTorch version `hccs_packed_prefill_ref` below, which the CPU tests
hold against the JAX kernel and `chip_smoke.py` holds the CUDA kernel
against on the card. There is no fallback from one to the other.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.core.hccs import hccs_mode_inv
from repro_torch.kernels.build import load_library

NEG_BIG = -(2 ** 30)
MODES = ("wide", "i16_div", "i16_clb")
# pool element codes shared with csrc/hccs_packed.cu
POOL_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3}
MODE_CODES = {"wide": 0, "i16_div": 1, "i16_clb": 2}
# launch limits of the CUDA kernel: one warp per query head of a GQA group,
# each lane owning head_dim / 32 output columns
MAX_GROUP = 32
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 232448          # H100: dynamic shared memory per block


def sm_denom(head_dim: int) -> float:
    """sqrt(head_dim) as the float32 value both versions divide by."""
    return float(np.sqrt(np.float32(head_dim)))


def packed_qint(q, k_pool, block_table, slot_ids, lengths, scale,
                k_scales=None):
    """Stage 0 of the sweep in plain PyTorch: the quantized logits
    q_int = clip(round_half_even(q.k / sqrt(d) / scale[h]), -128, 127) of
    every token against its slot's gathered keys, and which keys are live.

    Returns (q_int (T, H, L) int32 with dead keys at NEG_BIG, valid (T, L)
    bool) where L = nblk * block_size. A key is live when it lies before the
    token's frontier, its table entry is allocated (>= 0) and the token is
    not a pad lane (slot id -1) — exactly the keys the kernel reads."""
    t, h, d = q.shape
    n, hkv, bs, _ = k_pool.shape
    g = h // hkv
    nblk = block_table.shape[1]
    live_tok = slot_ids >= 0
    tbl = block_table[slot_ids.clamp(min=0).long()]           # (T, nblk)
    lens = torch.where(live_tok, lengths, torch.zeros_like(lengths))
    cols = torch.arange(nblk * bs, device=q.device)
    valid = ((cols[None, :] < lens[:, None])
             & (tbl[:, cols // bs] >= 0))                     # (T, L)
    tb = tbl.clamp(min=0).long()
    kg = k_pool[tb].float()                       # (T, nblk, Hkv, bs, d)
    if k_scales is not None:
        kg = kg * k_scales[tb][..., None, None]
    kg = kg.permute(0, 2, 1, 3, 4).reshape(t, hkv, nblk * bs, d)
    qg = q.float().reshape(t, hkv, g, d)
    logits = torch.einsum("tkgd,tkld->tkgl", qg, kg)
    # true divisions, in this order: a reciprocal multiply can move a logit
    # across an int8 bin boundary (see csrc/hccs_packed.cu)
    logits = logits / torch.tensor(sm_denom(d), dtype=torch.float32,
                                   device=q.device)
    logits = logits / scale.float().reshape(1, hkv, g, 1)
    q_int = torch.clamp(torch.round(logits), -128, 127).to(torch.int32)
    q_int = torch.where(valid[:, None, None, :], q_int,
                        torch.full_like(q_int, NEG_BIG))
    return q_int.reshape(t, h, nblk * bs), valid


def hccs_packed_prefill_ref(q, k_pool, v_pool, block_table, slot_ids,
                            lengths, scale, theta, *, mode: str = "wide",
                            static_max: bool = False, k_scales=None,
                            v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the twin of the JAX oracle
    `repro/kernels/ref.py` hccs_packed_prefill_ref, with the kernel's
    sentinel-entry skip): gather each token's slot blocks, quantize the
    logits, stages 1-4 in int32, PV and Z in float32, one mode-aware
    normalization. Arguments as in `hccs_packed_prefill`."""
    t, h, d = q.shape
    n, hkv, bs, _ = k_pool.shape
    g = h // hkv
    nblk = block_table.shape[1]
    q_int, valid = packed_qint(q, k_pool, block_table, slot_ids, lengths,
                               scale, k_scales)
    B = theta[:, 0].reshape(1, h, 1)
    S = theta[:, 1].reshape(1, h, 1)
    D = theta[:, 2].reshape(1, h, 1)
    if static_max:
        m = torch.full_like(q_int[..., :1], 127)
    else:
        m = q_int.max(dim=-1, keepdim=True).values
    s = B - S * torch.minimum(m - q_int, D)
    s = torch.where(valid[:, None, :], s, torch.zeros_like(s)).float()
    z = torch.clamp(s.sum(-1, keepdim=True), min=1.0)
    tb = block_table[slot_ids.clamp(min=0).long()].clamp(min=0).long()
    vg = v_pool[tb].float()
    if v_scales is not None:
        vg = vg * v_scales[tb][..., None, None]
    vg = vg.permute(0, 2, 1, 3, 4).reshape(t, hkv, nblk * bs, d)
    acc = torch.einsum("tkgl,tkld->tkgd", s.reshape(t, hkv, g, -1), vg)
    out = acc.reshape(t, h, d) * hccs_mode_inv(z, mode)
    return out


def _check(q, k_pool, v_pool, block_table, slot_ids, lengths, scale, theta,
           mode, k_scales, v_scales):
    """Raise on anything the kernel does not take. Shared by both devices,
    so the CPU tests exercise the same contract the card enforces."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (the i8 modes are not "
                         f"post-hoc linear), got {mode!r}")
    if q.dim() != 3 or k_pool.dim() != 4:
        raise ValueError(f"q must be (T, H, d) and pools (N, Hkv, bs, d); "
                         f"got {tuple(q.shape)} and {tuple(k_pool.shape)}")
    t, h, d = q.shape
    n, hkv, bs, dk = k_pool.shape
    if v_pool.shape != k_pool.shape or dk != d or h % hkv:
        raise ValueError(f"inconsistent shapes q {tuple(q.shape)}, k_pool "
                         f"{tuple(k_pool.shape)}, v_pool "
                         f"{tuple(v_pool.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    if k_pool.dtype not in POOL_TYPES or v_pool.dtype != k_pool.dtype:
        raise TypeError(f"pools must share one of {list(POOL_TYPES)}, got "
                        f"{k_pool.dtype}/{v_pool.dtype}")
    quant = k_pool.dtype == torch.int8
    if quant != (k_scales is not None) or quant != (v_scales is not None):
        raise ValueError("int8 pools need k_scales and v_scales; other pool "
                         "dtypes take none")
    if quant:
        for sc in (k_scales, v_scales):
            if sc.shape != (n, hkv) or sc.dtype != torch.float32:
                raise ValueError(f"scales must be float32 {(n, hkv)}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
    for name, a, shape in (("slot_ids", slot_ids, (t,)),
                           ("lengths", lengths, (t,)),
                           ("theta", theta, (h, 3))):
        if a.dtype != torch.int32 or tuple(a.shape) != shape:
            raise ValueError(f"{name} must be int32 {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if block_table.dtype != torch.int32 or block_table.dim() != 2:
        raise ValueError(f"block_table must be int32 (B, nblk), got "
                         f"{block_table.dtype} {tuple(block_table.shape)}")
    if scale.dtype != torch.float32 or tuple(scale.shape) != (h,):
        raise ValueError(f"scale must be float32 ({h},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")
    args = [q, k_pool, v_pool, block_table, slot_ids, lengths, scale, theta]
    if quant:
        args += [k_scales, v_scales]
    if len({a.device for a in args}) != 1:
        raise ValueError("all operands must lie on one device")


def smem_bytes(group: int, head_dim: int, block_size: int,
               nblk: int) -> int:
    """Dynamic shared memory of one kernel block: the group's queries, one
    staged K/V tile (row stride head_dim + 1 against bank conflicts), and
    the int8 quantized-logit row of every head in the group."""
    floats = group * head_dim + block_size * (head_dim + 1)
    return floats * 4 + -(-group * nblk * block_size // 16) * 16


def hccs_packed_prefill(q, k_pool, v_pool, block_table, slot_ids, lengths,
                        scale, theta, *, mode: str = "wide",
                        static_max: bool = False, k_scales=None,
                        v_scales=None, qint_out=None) -> torch.Tensor:
    """Token-centric HCCS attention over a paged pool: one query per token.

    q: (T, H, d) float32 one query per packed token; k_pool/v_pool:
    (N, Hkv, block_size, d) float32/bfloat16/float16, or int8 with
    k_scales/v_scales (N, Hkv) float32 per-(block, kv-head) dequant scales;
    block_table: (B, nblk) int32 pool ids, -1 = unallocated; slot_ids: (T,)
    int32 owning slot per token, -1 = pad lane (returns zeros); lengths:
    (T,) int32 per-token valid-KV counts including the token's own K/V;
    scale: (H,) float32 logit scales; theta: (H, 3) int32 per-head
    (B, S, D). Returns (T, H, d) float32.

    CUDA tensors launch the kernel (and bump `hccs_packed_prefill.launches`);
    CPU tensors run `hccs_packed_prefill_ref`. qint_out, for on-card
    testing only, is an int8 (T, H, nblk * block_size) CUDA tensor that
    receives the kernel's quantized logits at the live keys."""
    _check(q, k_pool, v_pool, block_table, slot_ids, lengths, scale, theta,
           mode, k_scales, v_scales)
    if q.device.type == "cpu":
        if qint_out is not None:
            raise ValueError("qint_out is a hook of the CUDA kernel")
        return hccs_packed_prefill_ref(
            q, k_pool, v_pool, block_table, slot_ids, lengths, scale, theta,
            mode=mode, static_max=static_max, k_scales=k_scales,
            v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    t, h, d = q.shape
    n, hkv, bs, _ = k_pool.shape
    g = h // hkv
    nblk = block_table.shape[1]
    if g > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP} and "
                         f"head_dim <= {MAX_HEAD_DIM}, got {g} and {d}")
    smem = smem_bytes(g, d, bs, nblk)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"kernel needs {smem} B of shared memory, over the "
                         f"{MAX_SMEM_BYTES} B a block can have")
    args = [q, k_pool, v_pool, block_table, slot_ids, lengths, scale, theta]
    if k_scales is not None:
        args += [k_scales, v_scales]
    for a in args:
        if not a.is_contiguous():
            raise ValueError("every operand must be contiguous")
    if qint_out is not None and (
            qint_out.dtype != torch.int8 or not qint_out.is_contiguous()
            or tuple(qint_out.shape) != (t, h, nblk * bs)
            or qint_out.device != q.device):
        raise ValueError(f"qint_out must be a contiguous int8 "
                         f"{(t, h, nblk * bs)} tensor on {q.device}")
    out = torch.empty((t, h, d), dtype=torch.float32, device=q.device)
    if t == 0:
        return out
    lib = load_library()
    ptr = (lambda a: ctypes.c_void_p(a.data_ptr() if a is not None else 0))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.hccs_packed_prefill_launch(
            ptr(q), ptr(k_pool), ptr(v_pool), ptr(k_scales), ptr(v_scales),
            ptr(block_table), ptr(slot_ids), ptr(lengths), ptr(scale),
            ptr(theta), ptr(out), ptr(qint_out), t, hkv, g, bs, nblk, d,
            POOL_TYPES[k_pool.dtype], MODE_CODES[mode], int(static_max),
            sm_denom(d), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"hccs_packed_prefill launch failed: CUDA error "
                           f"{err} ({lib.cuda_error_string(err).decode()})")
    hccs_packed_prefill.launches += 1
    return out


# launches of the CUDA kernel in this process (CPU calls never count)
hccs_packed_prefill.launches = 0
