"""Single-query HCCS attention kernels: the port of `repro/kernels/decode.py`.

Three entry points compute the same single-query sweep (the JAX package's
`_decode_tile`) and differ in where a row's keys live:

  hccs_packed_prefill  packed token steps: token t walks its OWNING slot's
                       block table, block_table[slot_ids[t]], up to its
                       causal frontier lengths[t] (csrc/hccs_packed.cu)
  hccs_paged_decode    the lockstep paged decode step: slot b walks
                       block_table[b] up to lengths[b] (csrc/hccs_paged.cu)
  hccs_decode          the slot-arena decode step: slot b reads rows
                       [0, lengths[b]) of a contiguous (B, Hkv, Tmax, d)
                       arena (csrc/hccs_arena.cu)

On the card the two decode kernels run the split-KV sweep
(`csrc/hccs_split.cuh`): (row, kv head, SPLIT_KEYS-key split) work items in
three passes (QK and split maxima; partial Z and s @ V; the fixed-order
combine and Stage 5; passes 1 and 2 fused under static_max). The packed
kernel runs the query-tiled sweep (`csrc/hccs_tiled.cuh`): the same passes
and partials, but a work item is a tile of up to `tile_tokens(group)`
consecutive tokens of one slot segment against one split, so a prefill
chunk's K/V split is staged once for TILE_ROWS (token, head) rows instead
of once per token; the tile list is built on the card in the same call.
A packed call of at most SPLIT_SWEEP_TOKENS tokens (decode lanes, at
serving widths) runs the split sweep. Each call is one C call into one
workspace the wrapper allocates (`workspace_bytes`). The row type each
source instantiates its sweep on (PackedRows, PagedRows, ArenaRows) says
where a row's keys live.

Each wrapper dispatches on the tensors' device: CUDA tensors launch the
hand-written kernel (or raise) and bump the wrapper's `launches` counter,
once per wrapper call whatever the number of passes; CPU tensors run the
plain PyTorch version beside it (`*_ref`), which the CPU tests hold against
the JAX kernel and `chip_smoke.py` holds the CUDA kernel against on the
card. There is no fallback from one to the other.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hccs import hccs_mode_inv
from repro_torch.kernels.build import cuda_device, launch
from repro_torch.spans import span

NEG_BIG = -(2 ** 30)
MODES = ("wide", "i16_div", "i16_clb")
# pool element codes shared with csrc/hccs_common.cuh
POOL_TYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2,
              torch.int8: 3}
MODE_CODES = {"wide": 0, "i16_div": 1, "i16_clb": 2}
# launch limits of the CUDA kernels: one warp per query head of a GQA group,
# each lane owning head_dim / 32 output columns
MAX_GROUP = 32
MAX_HEAD_DIM = 256
MAX_SMEM_BYTES = 232448          # H100: dynamic shared memory per block
# the split-KV sweep of csrc/hccs_split.cuh: keys per work item and
# threads per block (kSplitKeys; a decode step at 2048 keys is 16 splits per
# (row, kv head), enough blocks to fill 132 SMs at 8 slots x 8 kv heads),
# and the alignment of each workspace region (kWsAlign)
SPLIT_KEYS = 128
WS_ALIGN = 256
# the query-tiled sweep of csrc/hccs_tiled.cuh (hccs_packed_prefill): the
# (token, head) rows of a tile (kTileRows), so tile_tokens(group) tokens a
# tile: 16 at granite-3-2b's GQA group of 4, 32 at granite-moe's 2
TILE_ROWS = 64
# a packed call of at most this many tokens runs the split sweep
# (kSplitSweepTokens): at such widths a serving step is one-token decode
# lanes, which a tile cannot share a split across
SPLIT_SWEEP_TOKENS = 128


def sm_denom(head_dim: int) -> float:
    """sqrt(head_dim) as the float32 value every version divides by."""
    return float(np.sqrt(np.float32(head_dim)))


def split_smem_bytes(group: int, head_dim: int, elem_size: int,
                     static_max: bool) -> int:
    """Dynamic shared memory of the largest pass of the split sweep
    (hccs_paged_decode and hccs_decode; hccs::split_smem_bytes): per
    key its pool offset and V scale, per (warp, head) a max, the group's
    queries (QK) and s per (head, key) (PV, both in the static_max pass),
    and the split's SPLIT_KEYS rows of K or V, each padded to 16 bytes plus
    16. It does not depend on the row's length."""
    def r16(n):
        return -(-n // 16) * 16
    fixed = (SPLIT_KEYS * 12 + r16(16 * group)
             + SPLIT_KEYS * (r16(head_dim * elem_size) + 16))
    qk, pv = r16(group * head_dim * 4), group * SPLIT_KEYS * 4
    return fixed + (qk + pv if static_max else max(qk, pv))


def tile_tokens(group: int) -> int:
    """Tokens of a full tile of the packed kernel (hccs::tile_tokens)."""
    return 1 if group >= TILE_ROWS else TILE_ROWS // group


def uses_tiles(tokens: int) -> bool:
    """Whether a packed call of `tokens` lanes runs the tiled sweep (else
    the split sweep; kSplitSweepTokens in csrc/hccs_tiled.cuh)."""
    return tokens > SPLIT_SWEEP_TOKENS


def tiled_smem_bytes(head_dim: int, static_max: bool) -> int:
    """Dynamic shared memory of the largest pass of the tiled sweep
    (hccs_packed_prefill; hccs::tiled_smem_bytes of its wide tiles, which
    need more than its narrow ones): per key its pool offset and K and V
    scales, per tile token its frontier, per (warp, row) of a narrow tile
    (16 rows) a partial maximum or Z, the split's allocated keys as 128
    bits; the tile's TILE_ROWS query rows (QK) or s per (key, row) (PV) in
    one union, or the QK pass's logits (TILE_ROWS rows of SPLIT_KEYS + 4
    floats); the split's SPLIT_KEYS rows staged as float32 whatever the
    pool. Query and K rows take head_dim rounded to 8, plus 4, floats, the
    V rows of a PV pass head_dim rounded to 4."""
    stride = -(-head_dim // 8) * 8 + 4
    head = SPLIT_KEYS * 16 + TILE_ROWS * 4 + (SPLIT_KEYS // 32) * 16 * 4 + 16
    q, s = TILE_ROWS * stride * 4, SPLIT_KEYS * (TILE_ROWS + 4) * 4
    kv = SPLIT_KEYS * stride * 4
    if static_max:
        return head + max(q, s) + kv
    v = SPLIT_KEYS * -(-head_dim // 4) * 4 * 4      # V rows, unpadded
    return head + max(q + kv, s + v, TILE_ROWS * (SPLIT_KEYS + 4) * 4)


def split_count(max_len: int) -> int:
    """Key splits of a row of capacity max_len."""
    return -(-max_len // SPLIT_KEYS)


def workspace_bytes(rows: int, heads: int, max_len: int, head_dim: int, *,
                    qint_scratch: bool, tiles: bool = False) -> int:
    """Bytes of the one workspace a call takes
    (hccs::split_workspace_bytes): the int8 q_int scratch (rows, heads,
    max_len) when the call needs its own (no qint_out, not static_max), the
    split maxima and partial Z (rows, heads, nsplit) int32 and the partial
    s @ V (rows, heads, nsplit, head_dim) f32, each region aligned to
    WS_ALIGN bytes. With `tiles` (the packed kernel;
    hccs::tiled_workspace_bytes) the last region is aligned too and the
    tile list follows: a work item per (tile, split) (four int32: first
    token, tokens, top frontier, split), 3 int32 counters, and per tile its
    first token, tokens and top frontier (int32)."""
    def align(n):
        return -(-n // WS_ALIGN) * WS_ALIGN
    rh, ns = rows * heads, split_count(max_len)
    split = ((align(rh * max_len) if qint_scratch else 0)
             + 2 * align(rh * ns * 4) + rh * ns * head_dim * 4)
    if not tiles:
        return split
    return align(split) + rows * ns * 16 + (3 + 3 * rows) * 4


# ----------------------------------------------------------- plain versions --

def _gather(pool, tbl, scales):
    """(R, nblk) pool ids (>= 0) -> contiguous (R, Hkv, nblk * bs, d) f32,
    int8 pools dequantized per (block, kv-head)."""
    r, nblk = tbl.shape
    _, hkv, bs, d = pool.shape
    g = pool[tbl].float()                         # (R, nblk, Hkv, bs, d)
    if scales is not None:
        g = g * scales[tbl][..., None, None]
    return g.permute(0, 2, 1, 3, 4).reshape(r, hkv, nblk * bs, d)


def _qint(q, kg, valid, scale):
    """Stage 0: q_int = clip(round_half_even(q.k / sqrt(d) / scale[h]),
    -128, 127) of every query row against its keys kg (R, Hkv, L, d), dead
    keys at NEG_BIG. Returns (R, H, L) int32."""
    r, h, d = q.shape
    hkv, length = kg.shape[1], kg.shape[2]
    g = h // hkv
    qg = q.float().reshape(r, hkv, g, d)
    logits = torch.einsum("rkgd,rkld->rkgl", qg, kg)
    # true divisions, in this order: a reciprocal multiply can move a logit
    # across an int8 bin boundary (see csrc/hccs_split.cuh)
    logits = logits / torch.tensor(sm_denom(d), dtype=torch.float32,
                                   device=q.device)
    logits = logits / scale.float().reshape(1, hkv, g, 1)
    q_int = torch.clamp(torch.round(logits), -128, 127).to(torch.int32)
    q_int = torch.where(valid[:, None, None, :], q_int,
                        torch.full_like(q_int, NEG_BIG))
    return q_int.reshape(r, h, length)


def _sweep(q_int, valid, vg, theta, mode, static_max):
    """Stages 1-5 of the sweep on quantized logits (R, H, L) against values
    vg (R, Hkv, L, d): int32 scores, PV and Z in f32, one mode-aware
    normalization. Rows with no live key return zeros."""
    r, h, length = q_int.shape
    hkv, d = vg.shape[1], vg.shape[3]
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
    acc = torch.einsum("rkgl,rkld->rkgd", s.reshape(r, hkv, h // hkv, -1), vg)
    return acc.reshape(r, h, d) * hccs_mode_inv(z, mode)


def _paged_rows(block_table, rows, lengths, bs):
    """Each query row's table row (clamped to pool ids >= 0) and its live
    keys: before the row's frontier, in an allocated (>= 0) entry."""
    tbl = block_table[rows.long()]                            # (R, nblk)
    cols = torch.arange(tbl.shape[1] * bs, device=tbl.device)
    valid = ((cols[None, :] < lengths[:, None])
             & (tbl[:, cols // bs] >= 0))
    return tbl.clamp(min=0).long(), valid


def packed_qint(q, k_pool, block_table, slot_ids, lengths, scale,
                k_scales=None):
    """The quantized logits (T, H, nblk * block_size) int32 of every packed
    token against its slot's gathered keys (dead keys at NEG_BIG), and which
    keys are live (T, L) bool — exactly the keys the kernel reads. A pad
    lane (slot id -1) has none."""
    lens = torch.where(slot_ids >= 0, lengths, torch.zeros_like(lengths))
    tbl, valid = _paged_rows(block_table, slot_ids.clamp(min=0), lens,
                             k_pool.shape[2])
    return _qint(q, _gather(k_pool, tbl, k_scales), valid, scale), valid


def hccs_packed_prefill_ref(q, k_pool, v_pool, block_table, slot_ids,
                            lengths, scale, theta, *, mode: str = "wide",
                            static_max: bool = False, k_scales=None,
                            v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of the packed kernel (the twin of the JAX
    oracle `repro/kernels/ref.py` hccs_packed_prefill_ref, with the
    kernel's sentinel-entry skip). Arguments as in `hccs_packed_prefill`."""
    q_int, valid = packed_qint(q, k_pool, block_table, slot_ids, lengths,
                               scale, k_scales)
    tbl = block_table[slot_ids.clamp(min=0).long()].clamp(min=0).long()
    return _sweep(q_int, valid, _gather(v_pool, tbl, v_scales), theta, mode,
                  static_max)


def paged_qint(q, k_pool, block_table, lengths, scale, k_scales=None):
    """The quantized logits (B, H, nblk * block_size) int32 of every slot's
    query against its block table's keys, and the live keys (B, L)."""
    rows = torch.arange(q.shape[0], device=q.device)
    tbl, valid = _paged_rows(block_table, rows, lengths, k_pool.shape[2])
    return _qint(q, _gather(k_pool, tbl, k_scales), valid, scale), valid


def hccs_paged_decode_ref(q, k_pool, v_pool, block_table, lengths, scale,
                          theta, *, mode: str = "wide",
                          static_max: bool = False, k_scales=None,
                          v_scales=None) -> torch.Tensor:
    """Plain PyTorch version of the paged decode kernel (the twin of
    `repro/kernels/ref.py` hccs_paged_decode_ref, with the kernel's
    sentinel-entry skip). Arguments as in `hccs_paged_decode`."""
    q_int, valid = paged_qint(q, k_pool, block_table, lengths, scale,
                              k_scales)
    tbl = block_table.clamp(min=0).long()
    return _sweep(q_int, valid, _gather(v_pool, tbl, v_scales), theta, mode,
                  static_max)


def decode_qint(q, k, lengths, scale):
    """The quantized logits (B, H, Tmax) int32 of every slot's query against
    its arena rows, and the live keys (B, Tmax): rows before lengths[b]."""
    cols = torch.arange(k.shape[2], device=q.device)
    valid = cols[None, :] < lengths[:, None]
    return _qint(q, k.float(), valid, scale), valid


def hccs_decode_ref(q, k, v, lengths, scale, theta, *, mode: str = "wide",
                    static_max: bool = False) -> torch.Tensor:
    """Plain PyTorch version of the arena decode kernel (the twin of
    `repro/kernels/ref.py` hccs_decode_ref). Arguments as in
    `hccs_decode`."""
    q_int, valid = decode_qint(q, k, lengths, scale)
    return _sweep(q_int, valid, v.float(), theta, mode, static_max)


# ------------------------------------------------------------------ checks --

def _check_index(name, a, shape):
    if a.dtype != torch.int32 or tuple(a.shape) != tuple(shape):
        raise ValueError(f"{name} must be int32 {tuple(shape)}, got "
                         f"{a.dtype} {tuple(a.shape)}")


def _check(q, k, v, scale, theta, mode, k_scales, v_scales, *, pool: bool):
    """Raise on anything the kernels do not take, shared by both devices so
    the CPU tests exercise the contract the card enforces. k/v are pools
    (N, Hkv, bs, d) when `pool`, else an arena (B, Hkv, Tmax, d)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES} (the i8 modes are not "
                         f"post-hoc linear), got {mode!r}")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"q must be (rows, H, d) and K/V 4-d; got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    r, h, d = q.shape
    n, hkv, _, dk = k.shape
    if v.shape != k.shape or dk != d or h % hkv or (not pool and n != r):
        raise ValueError(f"inconsistent shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if q.dtype != torch.float32:
        raise TypeError(f"q must be float32, got {q.dtype}")
    dtypes = list(POOL_TYPES) if pool else [torch.float32, torch.bfloat16,
                                            torch.float16]
    if k.dtype not in dtypes or v.dtype != k.dtype:
        raise TypeError(f"K/V must share one of {dtypes}, got "
                        f"{k.dtype}/{v.dtype}")
    quant = k.dtype == torch.int8
    if quant != (k_scales is not None) or quant != (v_scales is not None):
        raise ValueError("int8 pools need k_scales and v_scales; other pool "
                         "dtypes take none")
    if quant:
        for sc in (k_scales, v_scales):
            if sc.shape != (n, hkv) or sc.dtype != torch.float32:
                raise ValueError(f"scales must be float32 {(n, hkv)}, got "
                                 f"{sc.dtype} {tuple(sc.shape)}")
    _check_index("theta", theta, (h, 3))
    if scale.dtype != torch.float32 or tuple(scale.shape) != (h,):
        raise ValueError(f"scale must be float32 ({h},), got {scale.dtype} "
                         f"{tuple(scale.shape)}")


def _check_table(block_table, rows=None):
    """An int32 (B, nblk) table; B == rows where each query row is a
    slot."""
    if (block_table.dtype != torch.int32 or block_table.dim() != 2
            or rows not in (None, block_table.shape[0])):
        raise ValueError(f"block_table must be int32 ({rows or 'B'}, nblk), "
                         f"got {block_table.dtype} "
                         f"{tuple(block_table.shape)}")


def _launch(fn, entry: str, args, q, k, *, qint_out, qint_len,
            tiles: bool = False, **ctx) -> torch.Tensor:
    """Launch one of the CUDA kernels on `q`'s device and stream: the shared
    launch limits and qint_out checks, the output and workspace
    allocation, then `build.launch` (device, contiguity, error check,
    launch count): one C call, whatever the number of passes. `tiles`: the
    kernel runs the tiled sweep (its shared memory and workspace). `ctx`
    are the entry point's trailing int arguments, in order, before pool
    type, mode, static_max."""
    r, h, d = q.shape
    g = h // k.shape[1]
    dev = cuda_device(*args, qint_out)
    if g > MAX_GROUP or d > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes GQA groups <= {MAX_GROUP} and "
                         f"head_dim <= {MAX_HEAD_DIM}, got {g} and {d}")
    static_max = ctx["static_max"]
    smem = (tiled_smem_bytes(d, static_max) if tiles
            else split_smem_bytes(g, d, k.element_size(), static_max))
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"kernel needs {smem} B of shared memory, over the "
                         f"{MAX_SMEM_BYTES} B a block can have")
    if qint_out is not None and (qint_out.dtype != torch.int8 or tuple(
            qint_out.shape) != (r, h, qint_len)):
        raise ValueError(f"qint_out must be a contiguous int8 "
                         f"{(r, h, qint_len)} tensor on {dev}")
    out = torch.empty((r, h, d), dtype=torch.float32, device=dev)
    if r == 0:
        return out
    with span("repro.workspace"):
        ws = torch.empty(workspace_bytes(
            r, h, qint_len, d,
            qint_scratch=qint_out is None and not static_max, tiles=tiles),
            dtype=torch.uint8, device=dev)
    mode, static_max = ctx.pop("mode"), ctx.pop("static_max")
    launch(fn, entry, dev, *args, out, qint_out, ws, ws.numel(),
           *ctx.values(), POOL_TYPES[k.dtype], MODE_CODES[mode],
           int(static_max), sm_denom(d))
    return out


def _cpu_only_hook(qint_out):
    if qint_out is not None:
        raise ValueError("qint_out is a hook of the CUDA kernel")


# ---------------------------------------------------------------- wrappers --

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

    CUDA tensors run the tiled sweep's passes through one C call (and bump
    `hccs_packed_prefill.launches` once); a call of at most
    SPLIT_SWEEP_TOKENS tokens runs the split sweep instead (`uses_tiles`:
    such a step is decode lanes, where the split sweep is the faster); CPU
    tensors run `hccs_packed_prefill_ref`. The tiles are cut on the card from
    slot_ids: each run of equal slot ids >= 0 (a slot segment, as
    `serve/paged.py` pack_slot_ids lays them out) into tiles of
    `tile_tokens(group)` tokens, a one-token segment being a one-token
    tile. A tile's block stages each 128-key split of its slot's K and V
    once for all its tokens, so a prefill chunk is bound by its QK and PV
    products on the f32 CUDA cores, not by re-reading its K/V per token; a
    decode lane is bound by its slot's K/V bytes. Output and q_int equal
    the split sweep's (`hccs_paged_decode` run per token) bit for bit.
    qint_out, for on-card testing only, is an int8 (T, H, nblk *
    block_size) CUDA tensor, prefilled by the caller, that receives the
    kernel's quantized logits at the live keys; it then serves as the
    kernel's q_int scratch."""
    _check(q, k_pool, v_pool, scale, theta, mode, k_scales, v_scales,
           pool=True)
    _check_table(block_table)
    _check_index("slot_ids", slot_ids, (q.shape[0],))
    _check_index("lengths", lengths, (q.shape[0],))
    kw = dict(mode=mode, static_max=static_max)
    if q.device.type == "cpu":
        _cpu_only_hook(qint_out)
        return hccs_packed_prefill_ref(
            q, k_pool, v_pool, block_table, slot_ids, lengths, scale, theta,
            k_scales=k_scales, v_scales=v_scales, **kw)
    _, hkv, bs, d = k_pool.shape
    nblk = block_table.shape[1]
    return _launch(
        hccs_packed_prefill, "hccs_packed_prefill_launch",
        [q, k_pool, v_pool, k_scales, v_scales, block_table, slot_ids,
         lengths, scale, theta], q, k_pool, qint_out=qint_out,
        qint_len=nblk * bs, tiles=uses_tiles(q.shape[0]), T=q.shape[0],
        num_kv=hkv, group=q.shape[1] // hkv, block_size=bs, nblk=nblk, d=d,
        **kw)


def hccs_paged_decode(q, k_pool, v_pool, block_table, lengths, scale, theta,
                      *, mode: str = "wide", static_max: bool = False,
                      k_scales=None, v_scales=None,
                      qint_out=None) -> torch.Tensor:
    """Single-query HCCS attention against a paged pool: one query per slot.

    q: (B, H, d) float32; k_pool/v_pool: (N, Hkv, block_size, d) float32/
    bfloat16/float16, or int8 with k_scales/v_scales (N, Hkv) float32;
    block_table: (B, nblk) int32 pool ids, -1 = unallocated (skipped without
    a read); lengths: (B,) int32 valid-KV counts including the current
    token; scale: (H,) float32; theta: (H, 3) int32. Returns (B, H, d)
    float32; rows with length 0 return zeros.

    CUDA tensors run the split sweep's passes through one C call (and bump
    `hccs_paged_decode.launches` once); CPU tensors run
    `hccs_paged_decode_ref`. qint_out, for on-card testing only, is an int8
    (B, H, nblk * block_size) CUDA tensor, prefilled by the caller, that
    receives the quantized logits at the live keys and serves as the
    kernel's q_int scratch."""
    _check(q, k_pool, v_pool, scale, theta, mode, k_scales, v_scales,
           pool=True)
    _check_table(block_table, rows=q.shape[0])
    _check_index("lengths", lengths, (q.shape[0],))
    kw = dict(mode=mode, static_max=static_max)
    if q.device.type == "cpu":
        _cpu_only_hook(qint_out)
        return hccs_paged_decode_ref(
            q, k_pool, v_pool, block_table, lengths, scale, theta,
            k_scales=k_scales, v_scales=v_scales, **kw)
    _, hkv, bs, d = k_pool.shape
    nblk = block_table.shape[1]
    return _launch(
        hccs_paged_decode, "hccs_paged_decode_launch",
        [q, k_pool, v_pool, k_scales, v_scales, block_table, lengths, scale,
         theta], q, k_pool, qint_out=qint_out, qint_len=nblk * bs,
        B=q.shape[0], num_kv=hkv, group=q.shape[1] // hkv,
        block_size=bs, nblk=nblk, d=d, **kw)


def hccs_decode(q, k, v, lengths, scale, theta, *, mode: str = "wide",
                static_max: bool = False, qint_out=None) -> torch.Tensor:
    """Single-query HCCS attention against a slot-arena KV cache.

    q: (B, H, d) float32 one query per slot; k, v: (B, Hkv, Tmax, d)
    float32/bfloat16/float16 arenas (any Tmax); lengths: (B,) int32 valid-KV
    counts (the slot frontier, including the current token's K/V already
    written at lengths - 1); scale: (H,) float32; theta: (H, 3) int32.
    Returns (B, H, d) float32; rows with length 0 return zeros.

    CUDA tensors run the split sweep's passes through one C call (and bump
    `hccs_decode.launches` once); CPU tensors run `hccs_decode_ref`.
    qint_out, for on-card testing only, is an int8 (B, H, Tmax) CUDA tensor,
    prefilled by the caller, that receives the quantized logits at the live
    keys and serves as the kernel's q_int scratch."""
    _check(q, k, v, scale, theta, mode, None, None, pool=False)
    _check_index("lengths", lengths, (q.shape[0],))
    kw = dict(mode=mode, static_max=static_max)
    if q.device.type == "cpu":
        _cpu_only_hook(qint_out)
        return hccs_decode_ref(q, k, v, lengths, scale, theta, **kw)
    _, hkv, tmax, d = k.shape
    return _launch(
        hccs_decode, "hccs_decode_launch",
        [q, k, v, lengths, scale, theta], q, k, qint_out=qint_out,
        qint_len=tmax, B=q.shape[0], num_kv=hkv,
        group=q.shape[1] // hkv, tmax=tmax, d=d, **kw)


# launches of each CUDA kernel in this process (CPU calls never count)
hccs_packed_prefill.launches = 0
hccs_paged_decode.launches = 0
hccs_decode.launches = 0
