"""The benchmark's yardstick of work: the chip's peaks, and the operations
and bytes of one `hccs_packed_prefill` call from the step's schedule.
Counted from shapes, never from the program's own counters. A model's
FLOPs, and the shape and number of its attention calls, are its model
module's (bench/models/<model>.py)."""
from __future__ import annotations

# one NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's data sheet),
# at the full 700 W power limit
PEAK_BF16 = 989e12          # FLOP/s, bf16 and fp16 on the tensor cores
PEAK_TOP = 1979e12          # the chip's top dense rate: int8 OP/s, fp8 FLOP/s
PEAK_F32_CORES = 67e12      # FLOP/s, float32 outside the tensor cores
PEAK_HBM = 3.35e12          # bytes/s


def packed_keys(slots) -> int:
    """Live keys summed over a call's tokens. slots: (L0, n) per slot that
    has tokens in the step: its n tokens sit at positions L0 .. L0 + n - 1
    and token i reads the L0 + i + 1 keys up to and including its own."""
    return sum(n * l0 + n * (n + 1) // 2 for l0, n in slots)


def packed_call(slots, heads: int, kv_heads: int, head_dim: int,
                pool_bytes: int = 4) -> tuple[float, float]:
    """(operations, bytes) of one packed attention call. Operations: the
    QK and PV products of every token's live keys, 2 x 2 x head_dim a key
    and head. Bytes: each slot's live K and V rows once (up to its last
    token's frontier), each valid token's float32 query and output once."""
    ops = 4.0 * heads * head_dim * packed_keys(slots)
    rows = sum(l0 + n for l0, n in slots)
    tokens = sum(n for _, n in slots)
    nbytes = (2.0 * rows * kv_heads * head_dim * pool_bytes
              + 2.0 * tokens * heads * head_dim * 4)
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float, peak_ops: float = PEAK_TOP,
                  peak_bytes: float = PEAK_HBM) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(ops / peak_ops, nbytes / peak_bytes)

