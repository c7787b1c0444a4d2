// hccs_sweep.cuh — the one-block-per-row single-query HCCS sweep, run by
// hccs_paged.cu (the lockstep paged decode step). hccs_arena.cu and
// hccs_packed.cu ran it until they moved to the split-KV sweep
// (hccs_split.cuh); its shared pieces are in hccs_common.cuh.
//
// Replaces the body the Pallas TPU kernels share, `_decode_tile`
// (src/repro/kernels/decode.py:65). One thread block runs one query row
// (a packed token or a slot) against one kv head; its warps are the GQA
// group's query heads. For every live key j < nk of the row:
//
//   l     = dot(q, k) / sqrt(d)                          true f32 division
//   q_int = clip(rint(l / scale[h]), -128, 127)          half to even
//   m     = max q_int over live keys (127 with static_max)       Stage 1
//   s     = B - S * min(m - q_int, D)   (int32; 0 on dead keys)  Stages 2-3
//   Z     = sum s,  acc = sum s * v     (f32)                    Stage 4
//   out   = acc * mode_inv(max(Z, 1))                            Stage 5
//
// How tile j of a row is located is the `Locator` the sweep is templated on
// (hccs_common.cuh); hccs_paged.cu walks a block of the paged pool through
// block_table[b]. A locator returns false for a tile that holds no live key
// (a sentinel -1 table entry); such a tile is never read.
//
// What bounds it on the H100: memory. Each (row, kv-head) reads its live K
// and V rows once, about 2 * d flops per element read — far below the ~20
// flops/byte where the f32 pipes would take over. The design: every K/V tile
// is read from global memory once per GQA group, not once per head (the TPU
// kernels' grouping); the first sweep keeps each head's int8 q_int row in
// shared memory, so the second sweep reads V only and never recomputes a QK
// product — K and V are each read exactly once, with or without static_max.
// Tiles are staged in shared memory with a padded row stride (d + 1) so the
// lanes' per-key dot products do not bank-conflict. What holds it back is
// the serial walk: one block per (row, kv head) walks the whole frontier
// twice, so a decode step runs 64 blocks on 132 SMs. hccs_split.cuh splits
// the walk; the paged kernel moves onto it next.
//
// Numerics that must match the JAX kernels bit for bit on exact inputs:
// both divisions are true IEEE divisions (__fdiv_rn; never build with fast
// math), rounding is rintf (half to even, as jnp.round), Z is a float sum of
// integers (exact below 2^24), and Stage 5 evaluates the same float formulas
// as repro/core/hccs.py hccs_mode_inv.
#pragma once

#include "hccs_common.cuh"

namespace hccs {

// Stage rows [0, rows) starting at element `base` (row stride d) into
// `tile` (row stride d + 1) as f32, dequantized by `dq` for int8 pools.
template <int PT>
__device__ __forceinline__ void stage_tile(float* tile, const void* src,
                                           int64_t base, int rows, int d,
                                           float dq) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    float x = load_elem<PT>(src, base + i);
    if (PT == kI8) x = x * dq;
    tile[r * (d + 1) + c] = x;
  }
}

// Dynamic shared memory of one block: the group's queries, one staged tile
// and the int8 q_int row of every head in the group.
inline size_t sweep_smem_bytes(int group, int d, int tile, int max_len) {
  const size_t floats = static_cast<size_t>(group) * d +
                        static_cast<size_t>(tile) * (d + 1);
  const size_t qi_bytes = (static_cast<size_t>(group) * max_len + 15) / 16 * 16;
  return floats * 4 + qi_bytes;
}

// The sweep of one (row, kv-head) block; block = 32 * group threads, warp w
// owning query head kv * group + w. qsrc: the group's queries (group * d
// f32); out: this row's (H, d) output; qint_out: null, or this row's
// (H, max_len) int8 quantized logits (testing hook). nk: the row's frontier
// (0 returns zeros); tile: rows per located tile; max_len: the row's
// capacity (nblk * block_size, or Tmax).
template <int PT, class Locator>
__device__ __forceinline__ void sweep(
    const Locator& locate, const float* __restrict__ qsrc,
    const void* __restrict__ k_src, const void* __restrict__ v_src,
    const float* __restrict__ scale, const int* __restrict__ theta,
    float* __restrict__ out, int8_t* __restrict__ qint_out, int nk, int tile,
    int max_len, int kv, int group, int d, int mode, int static_max,
    float sm_denom) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = kv * group + warp;           // this warp's query head
  float* out_row = out + static_cast<int64_t>(h) * d;
  nk = min(nk, max_len);
  if (nk <= 0) {                             // empty row / pad lane: zeros
    for (int c = lane; c < d; c += 32) out_row[c] = 0.0f;
    return;                                  // uniform across the block
  }

  float* qs = smem;                                   // group * d
  float* stage = qs + group * d;                      // tile * (d + 1)
  int8_t* qi = reinterpret_cast<int8_t*>(stage + tile * (d + 1));
  int8_t* qi_row = qi + warp * max_len;               // this head's q_int
  for (int i = threadIdx.x; i < group * d; i += blockDim.x) qs[i] = qsrc[i];

  const float scale_h = scale[h];
  const int B = theta[3 * h], S = theta[3 * h + 1], D = theta[3 * h + 2];
  const int nb = (nk + tile - 1) / tile;

  // sweep 1: quantized logits of every live key, kept in shared memory;
  // running max for Stage 1
  int m_lane = kNegBig;
  const float* qh = qs + warp * d;
  for (int j = 0; j < nb; ++j) {
    int64_t base = 0;
    float kdq = 1.0f, vdq = 1.0f;
    if (!locate(j, &base, &kdq, &vdq)) continue;  // uniform per block
    const int col0 = j * tile;
    const int rows = min(tile, nk - col0);
    __syncthreads();                         // previous tile fully consumed
    stage_tile<PT>(stage, k_src, base, rows, d, kdq);
    __syncthreads();
    for (int r = lane; r < rows; r += 32) {
      const float* kr = stage + r * (d + 1);
      float acc = 0.0f;
      for (int c = 0; c < d; ++c) acc = fmaf(qh[c], kr[c], acc);
      const float l = __fdiv_rn(acc, sm_denom);
      float x = rintf(__fdiv_rn(l, scale_h));
      x = fminf(fmaxf(x, -128.0f), 127.0f);
      const int qv = static_cast<int>(x);
      qi_row[col0 + r] = static_cast<int8_t>(qv);
      if (qint_out != nullptr)
        qint_out[static_cast<int64_t>(h) * max_len + col0 + r] =
            static_cast<int8_t>(qv);
      m_lane = max(m_lane, qv);
    }
  }
  const int m = static_max ? kStaticMax : warp_max(m_lane);

  // sweep 2: Stages 2-4 against V, each lane owning columns lane + 32u
  float acc[kMaxColsPerLane];
#pragma unroll
  for (int u = 0; u < kMaxColsPerLane; ++u) acc[u] = 0.0f;
  float z = 0.0f;
  for (int j = 0; j < nb; ++j) {
    int64_t base = 0;
    float kdq = 1.0f, vdq = 1.0f;
    if (!locate(j, &base, &kdq, &vdq)) continue;
    const int col0 = j * tile;
    const int rows = min(tile, nk - col0);
    __syncthreads();
    stage_tile<PT>(stage, v_src, base, rows, d, vdq);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const int qv = qi_row[col0 + r];
      const float s = static_cast<float>(B - S * min(m - qv, D));
      z += s;
      const float* vr = stage + r * (d + 1);
#pragma unroll
      for (int u = 0; u < kMaxColsPerLane; ++u) {
        const int c = lane + 32 * u;
        if (c < d) acc[u] = fmaf(s, vr[c], acc[u]);
      }
    }
  }
  const float inv = mode_inv(fmaxf(z, 1.0f), mode);
#pragma unroll
  for (int u = 0; u < kMaxColsPerLane; ++u) {
    const int c = lane + 32 * u;
    if (c < d) out_row[c] = acc[u] * inv;
  }
}

}  // namespace hccs
