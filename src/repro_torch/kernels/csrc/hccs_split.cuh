// hccs_split.cuh — the split-KV single-query HCCS sweep, run by
// hccs_arena.cu (hccs_decode) and hccs_paged.cu (hccs_paged_decode); its
// workspace, helpers and combine pass also serve the query-tiled sweep of
// hccs_packed.cu (hccs_packed_prefill, hccs_tiled.cuh).
//
// Replaces, for those kernels, the body the Pallas TPU kernels share,
// `_decode_tile` (src/repro/kernels/decode.py:65). Each query row (a slot or
// a packed token) computes, per query head h, over its live keys j < nk:
//
//   l     = dot(q, k) / sqrt(d)                          true f32 division
//   q_int = clip(rint(l / scale[h]), -128, 127)          half to even
//   m     = max q_int over live keys (127 with static_max)       Stage 1
//   s     = B - S * min(m - q_int, D)   (int32; 0 on dead keys)  Stages 2-3
//   Z     = sum s (int32),  acc = sum s * v (f32)                Stage 4
//   out   = acc * mode_inv(max(Z, 1))                            Stage 5
//
// A work item is (query row, kv head, key split): the kSplitKeys keys
// [split * kSplitKeys, (split + 1) * kSplitKeys) of the row, cut at its
// frontier. Given m, Stages 2-4 are plain sums, so the splits' partials
// combine by addition, with no rescaling as in flash-decoding; the one
// cross-split dependence is m, a max of int8 values, which combines exactly.
// One host call enqueues, on one stream:
//
//   pass 1  grid (row, kv, split): QK, q_int written to a global int8
//           scratch (R, H, L) at live keys, the split's max per head into
//           (R, H, nsplit) int32; kNegBig for a split with no live key
//   pass 2  grid (row, kv, split): m = max of the row's split maxima; s from
//           the scratch; the split's partial acc (R, H, nsplit, d) f32 and
//           partial Z (R, H, nsplit) int32
//   pass 3  grid (row, kv): the partials summed in split order, Stage 5
//
// Under static_max m = 127 is known in advance: passes 1 and 2 run as one
// (QK, then PV on the same staged rows), and q_int is written only to a
// caller's qint_out. The partials and the scratch live in one workspace the
// wrapper allocates (split_workspace_bytes); nothing is allocated here.
//
// What bounds it on the H100: memory and latency. Every live K and V row is
// read once per (row, kv head), for about 2 * d flops an element, far below
// the f32 pipes' line. The one-block-per-row sweep it replaced put a
// decode step on 64 blocks of 132 SMs, each walking up to 2048 keys twice
// with two barriers a 32-key tile. Here a block of kSplitKeys threads owns
// a split, a thread one key, so a decode step at 2048 keys is 16 blocks per
// (row, kv head), each with its whole split in flight: warp w stages the
// rows of its 32 keys with 16-byte cp.async as soon as their pool offsets
// (and block-table entries) are known, and computes when they land. In QK
// a thread runs four heads' dot products side by side, reading its K row
// from shared memory once per four heads; in PV a warp owns a head and a
// lane columns lane + 32u, walking the split's keys with s and V in shared
// memory. The price is the partials' traffic (d + 2 words per (row, head,
// split)) and two more launches. Single-query rows want this parallelism
// over keys; a prefill chunk's tokens would each read their slot's K/V
// again, so the packed kernel shares each staged split across a tile of a
// slot's tokens instead (hccs_tiled.cuh), with the same numerics.
//
// Numerics, bit for bit with the JAX kernels on exact inputs: the logit is
// one sequential fmaf chain over c = 0..d-1 (int8 pools dequantized as
// x * dq before the product), then __fdiv_rn by sqrt(d), __fdiv_rn by
// scale[h], rintf, the clip; never build with fast math. Z is an int32 sum,
// exact in any order. acc is summed in key order within a split and in
// split order across splits (no atomics), so a call is deterministic;
// random inputs move by ulps of acc against a single walk, exact inputs
// (multiples of 2^-3) not at all.
#pragma once

#include <limits.h>

#include "hccs_common.cuh"

namespace hccs {

constexpr int kSplitKeys = 128;   // keys per work item = threads per block
constexpr int kWarps = kSplitKeys / 32;
constexpr size_t kWsAlign = 256;  // alignment of each workspace region

__host__ __device__ inline int split_count(int max_len) {
  return (max_len + kSplitKeys - 1) / kSplitKeys;
}

__host__ __device__ inline int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

inline size_t ws_align(size_t bytes) {
  return (bytes + kWsAlign - 1) / kWsAlign * kWsAlign;
}

// Bytes of one call's workspace (decode.py workspace_bytes): the q_int
// scratch (R, H, L) int8 when the call needs one of its own (no qint_out,
// not static_max), then the split maxima and the partial Z (R, H, nsplit)
// int32 and the partial acc (R, H, nsplit, d) f32, each region aligned.
inline size_t split_workspace_bytes(int rows, int heads, int max_len, int d,
                                    bool qint_scratch) {
  const size_t rh = static_cast<size_t>(rows) * heads;
  const size_t ns = split_count(max_len);
  return (qint_scratch ? ws_align(rh * max_len) : 0) +
         2 * ws_align(rh * ns * 4) + rh * ns * d * 4;
}

// Shared-memory row stride of the staged K/V rows: the row's bytes rounded
// to 16, plus 16, so that 32 lanes reading 16 bytes of 32 rows at one
// column do not bank-conflict.
__host__ __device__ inline int split_row_stride(int d, int elem) {
  return round16(d * elem) + 16;
}

// Dynamic shared memory of a pass (decode.py split_smem_bytes): per key its
// row's pool offset and V dequant scale, per (warp, head) a max, the
// group's queries (QK), s per (head, key) (PV), and the split's kSplitKeys
// staged rows (K, then V in the static_max pass). It does not depend on
// the row's length.
inline size_t split_smem_bytes(int group, int d, int elem, bool qk, bool pv) {
  return static_cast<size_t>(kSplitKeys) * 12 + round16(16 * group) +
         (qk ? round16(group * d * 4) : 0) +
         (pv ? static_cast<size_t>(group) * kSplitKeys * 4 : 0) +
         static_cast<size_t>(kSplitKeys) * split_row_stride(d, elem);
}

struct SplitWorkspace {
  int8_t* qint;  // (R, H, L) q_int scratch, or qint_out, or null
  int* smax;     // (R, H, nsplit) split maxima
  int* z;        // (R, H, nsplit) partial Z
  float* acc;    // (R, H, nsplit, d) partial acc
};

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Stage the 32 rows [r0, r0 + 32) of a split, whose pool offsets are in
// `bases` (-1: a dead key, left unread), into `dst` (row stride rs): one
// warp, 16 bytes a cp.async with consecutive lanes on consecutive bytes of
// a row (vec), else an element at a time through registers.
template <class T>
__device__ __forceinline__ void stage_rows(unsigned char* dst,
                                           const void* src,
                                           const int64_t* bases, int r0,
                                           int rs, int d, bool vec,
                                           int lane) {
  if (vec) {
    const int cpr = d * static_cast<int>(sizeof(T)) / 16;  // chunks a row
    const bool pow2 = (cpr & (cpr - 1)) == 0;
    const int sh = __ffs(cpr) - 1;
    for (int i = lane; i < 32 * cpr; i += 32) {
      int r;
      if (pow2) r = i >> sh;
      else r = i / cpr;
      const int c = i - r * cpr;
      const int64_t b = bases[r0 + r];
      if (b < 0) continue;
      cp_async16(dst + (r0 + r) * rs + c * 16,
                 static_cast<const unsigned char*>(src) +
                     b * static_cast<int64_t>(sizeof(T)) + c * 16);
    }
  } else {
    for (int i = lane; i < 32 * d; i += 32) {
      const int r = i / d, c = i - r * d;
      const int64_t b = bases[r0 + r];
      if (b < 0) continue;
      reinterpret_cast<T*>(dst + (r0 + r) * rs)[c] =
          static_cast<const T*>(src)[b + c];
    }
  }
}

__device__ __forceinline__ void zero_row(unsigned char* row, int rs) {
  for (int c = 0; c < rs / 16; ++c)
    reinterpret_cast<uint4*>(row)[c] = make_uint4(0u, 0u, 0u, 0u);
}

// 16 staged bytes as floats (4 f32, 8 bf16 or f16, 16 int8).
template <int PT>
__device__ __forceinline__ void unpack16(const unsigned char* p, float* x) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  if constexpr (PT == kF32) {
    const float* f = reinterpret_cast<const float*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = f[i];
  } else if constexpr (PT == kBF16) {
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(b[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else if constexpr (PT == kF16) {
    const __half2* b = reinterpret_cast<const __half2*>(&w);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(b[i]);
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  } else {
    const int8_t* b = reinterpret_cast<const int8_t*>(&w);
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = static_cast<float>(b[i]);
  }
}

template <int PT>
__device__ __forceinline__ float dequant(float x, float dq) {
  return PT == kI8 ? x * dq : x;
}

// dot(q_h, k) of one staged key row for the four heads g0..g0+3 of the
// group side by side (heads past the group repeat its last one; their
// results are dropped), each one sequential fmaf chain over c = 0..d-1 as
// every version computes it; `vec` reads the row 16 bytes and each query
// 4 floats at a time.
template <int PT, int COLS>
__device__ __forceinline__ void dot4(const float* qs, int g0, int group,
                                     int d, const unsigned char* kr,
                                     float dq, bool vec, float* a) {
  using T = typename Elem<PT>::T;
  const float* q0 = qs + min(g0, group - 1) * d;
  const float* q1 = qs + min(g0 + 1, group - 1) * d;
  const float* q2 = qs + min(g0 + 2, group - 1) * d;
  const float* q3 = qs + min(g0 + 3, group - 1) * d;
  if (vec) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int c0 = 0; c0 < 32 * COLS; c0 += kPer) {
      if (c0 >= d) break;
      float x[kPer];
      unpack16<PT>(kr + c0 * static_cast<int>(sizeof(T)), x);
#pragma unroll
      for (int e = 0; e < kPer; e += 4) {
        const float4 w0 = *reinterpret_cast<const float4*>(q0 + c0 + e);
        const float4 w1 = *reinterpret_cast<const float4*>(q1 + c0 + e);
        const float4 w2 = *reinterpret_cast<const float4*>(q2 + c0 + e);
        const float4 w3 = *reinterpret_cast<const float4*>(q3 + c0 + e);
        float k = dequant<PT>(x[e], dq);
        a[0] = fmaf(w0.x, k, a[0]); a[1] = fmaf(w1.x, k, a[1]);
        a[2] = fmaf(w2.x, k, a[2]); a[3] = fmaf(w3.x, k, a[3]);
        k = dequant<PT>(x[e + 1], dq);
        a[0] = fmaf(w0.y, k, a[0]); a[1] = fmaf(w1.y, k, a[1]);
        a[2] = fmaf(w2.y, k, a[2]); a[3] = fmaf(w3.y, k, a[3]);
        k = dequant<PT>(x[e + 2], dq);
        a[0] = fmaf(w0.z, k, a[0]); a[1] = fmaf(w1.z, k, a[1]);
        a[2] = fmaf(w2.z, k, a[2]); a[3] = fmaf(w3.z, k, a[3]);
        k = dequant<PT>(x[e + 3], dq);
        a[0] = fmaf(w0.w, k, a[0]); a[1] = fmaf(w1.w, k, a[1]);
        a[2] = fmaf(w2.w, k, a[2]); a[3] = fmaf(w3.w, k, a[3]);
      }
    }
  } else {
    for (int c = 0; c < d; ++c) {
      const float k = dequant<PT>(load_elem<PT>(kr, c), dq);
      a[0] = fmaf(q0[c], k, a[0]); a[1] = fmaf(q1[c], k, a[1]);
      a[2] = fmaf(q2[c], k, a[2]); a[3] = fmaf(q3[c], k, a[3]);
    }
  }
}

// Pass 1 (kQK), pass 2 (kPV) or the static_max pass (both) of one
// (row, kv head, split) block of kSplitKeys threads, thread t owning key
// split * kSplitKeys + t. `Rows` maps a query row to its frontier and a
// (row, kv head, key) to the key's element offset in the pools and its
// dequant scales (false: a dead key, never read); q (R, H, d) f32; the
// columns a lane owns in PV are lane + 32u, u < COLS (d <= 32 * COLS); vec:
// K/V rows may be staged 16 bytes at a time (d * elem a multiple of 16,
// pools 16-byte aligned).
//
// Warp w stages the K (or, in pass 2, V) rows of keys [32w, 32w + 32) with
// cp.async the moment their pool offsets are known, so that each warp's
// copies land while the block stages the queries (QK) or Stage 1 and s
// (pass 2). QK: each thread runs its key's dot products for four heads
// side by side, reading its K row from shared memory once per four heads
// and each query as a broadcast. PV: warp w walks the split's keys for
// heads w, w + kWarps, ..., each lane summing s * v over its columns; dead
// keys have s = 0 and a zeroed row, so the walk has no branches. In the
// static_max pass each warp restages its rows with V as soon as its QK is
// done, while the other warps still compute.
#define HCCS_SPLIT_PARAMS                                                     \
  Rows rows, const float* __restrict__ q, const void* __restrict__ k_src,     \
      const void* __restrict__ v_src, const float* __restrict__ scale,        \
      const int* __restrict__ theta, SplitWorkspace ws, int num_kv,           \
      int group, int max_len, int d, float sm_denom, int vec
#define HCCS_SPLIT_ARGS                                                       \
  rows, q, k_src, v_src, scale, theta, ws, num_kv, group, max_len, d,         \
      sm_denom, vec

template <int PT, int COLS, bool kQK, bool kPV, class Rows>
__device__ __forceinline__ void split_pass(HCCS_SPLIT_PARAMS) {
  using T = typename Elem<PT>::T;
  const int nsplit = split_count(max_len);
  const int pair = blockIdx.x / nsplit;             // row * num_kv + kv
  const int split = blockIdx.x - pair * nsplit;
  const int row = pair / num_kv, kv = pair - row * num_kv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int64_t rh0 = static_cast<int64_t>(pair) * group;  // head kv*group
  const int nk = min(rows.frontier(row), max_len);
  const int k0 = split * kSplitKeys;
  if (k0 >= nk) {                                   // past the frontier
    if (kQK && !kPV)
      for (int g = tid; g < group; g += kSplitKeys)
        ws.smax[(rh0 + g) * nsplit + split] = kNegBig;
    return;                                         // uniform per block
  }
  const int k1 = min(nk, k0 + kSplitKeys);
  const int rs = split_row_stride(d, static_cast<int>(sizeof(T)));
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  int64_t* bases = reinterpret_cast<int64_t*>(p);  // pool offset, -1 dead
  p += kSplitKeys * 8;
  float* vdqs = reinterpret_cast<float*>(p);        // V dequant per key
  p += kSplitKeys * 4;
  int* mpart = reinterpret_cast<int*>(p);           // (warp, head) maxima
  p += round16(16 * group);
  float* qs = reinterpret_cast<float*>(p);          // group * d queries
  if (kQK) p += round16(group * d * 4);
  float* ss = reinterpret_cast<float*>(p);          // (head, key) s
  if (kPV) p += group * kSplitKeys * 4;
  unsigned char* rt = p;                            // the split's rows

  const int key = k0 + tid;
  int64_t base = 0;
  float kdq = 1.0f, vdq = 1.0f;
  const bool live = key < k1 && rows.locate(row, kv, key, &base, &kdq, &vdq);
  bases[tid] = live ? base : -1;
  vdqs[tid] = vdq;
  __syncwarp();
  stage_rows<T>(rt, kQK ? k_src : v_src, bases, warp * 32, rs, d, vec, lane);
  cp_async_commit();
  if (!kQK && !live) zero_row(rt + tid * rs, rs);

  if (kQK) {
    for (int i = tid; i < group * d; i += kSplitKeys) qs[i] = q[rh0 * d + i];
  } else {                                          // Stage 1 from pass 1
    for (int g = warp; g < group; g += kWarps) {
      int m = kNegBig;
      for (int s = lane; s < nsplit; s += 32)
        m = max(m, ws.smax[(rh0 + g) * nsplit + s]);
      m = warp_max(m);
      if (lane == 0) mpart[g] = m;
    }
  }
  __syncthreads();

  if (!kQK) {                                       // pass 2: s from q_int
#pragma unroll 4
    for (int g = 0; g < group; ++g) {
      const int* th = theta + 3 * (kv * group + g);
      int s = 0;
      if (live) {
        const int qv = ws.qint[(rh0 + g) * max_len + key];
        s = th[0] - th[1] * min(mpart[g] - qv, th[2]);
      }
      ss[g * kSplitKeys + tid] = static_cast<float>(s);
    }
  } else {                                          // QK
    cp_async_wait_all();
    __syncwarp();                                   // this warp's K rows
    for (int g0 = 0; g0 < group; g0 += 4) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (live) dot4<PT, COLS>(qs, g0, group, d, rt + tid * rs, kdq, vec, a);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int g = g0 + j;
        if (g >= group) break;                      // uniform
        const int h = kv * group + g;
        int qv = kNegBig;
        if (live) {
          const float l = __fdiv_rn(a[j], sm_denom);
          float x = rintf(__fdiv_rn(l, scale[h]));
          x = fminf(fmaxf(x, -128.0f), 127.0f);
          qv = static_cast<int>(x);
          if (ws.qint != nullptr)
            ws.qint[(rh0 + g) * max_len + key] = static_cast<int8_t>(qv);
        }
        if (kPV) {
          const int* th = theta + 3 * h;
          ss[g * kSplitKeys + tid] = live
              ? static_cast<float>(th[0] - th[1] * min(kStaticMax - qv, th[2]))
              : 0.0f;
        } else {
          const int m = warp_max(qv);
          if (lane == 0) mpart[warp * group + g] = m;
        }
      }
    }
    if (!kPV) {                                     // the split's maxima
      __syncthreads();
      for (int g = tid; g < group; g += kSplitKeys) {
        int m = mpart[g];
        for (int w = 1; w < kWarps; ++w) m = max(m, mpart[w * group + g]);
        ws.smax[(rh0 + g) * nsplit + split] = m;
      }
      return;
    }
    __syncwarp();                                   // K rows consumed
    stage_rows<T>(rt, v_src, bases, warp * 32, rs, d, vec, lane);
    cp_async_commit();
    if (!live) zero_row(rt + tid * rs, rs);
  }

  // PV: Stages 2-4 of the split, warp w for heads w, w + kWarps, ...
  cp_async_wait_all();
  __syncthreads();                                  // every V row and s
  const int nr = (k1 - k0 + 3) & ~3;
  for (int g = warp; g < group; g += kWarps) {
    const float* sg = ss + g * kSplitKeys;
    float acc[COLS];
#pragma unroll
    for (int u = 0; u < COLS; ++u) acc[u] = 0.0f;
#pragma unroll 2
    for (int r = 0; r < nr; r += 4) {
      const float4 s4 = *reinterpret_cast<const float4*>(sg + r);
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char* vr = rt + (r + j) * rs;
        const float dq = PT == kI8 ? vdqs[r + j] : 1.0f;
#pragma unroll
        for (int u = 0; u < COLS; ++u) {
          const int c = lane + 32 * u;
          if (c < d)
            acc[u] = fmaf(sv[j], dequant<PT>(load_elem<PT>(vr, c), dq),
                          acc[u]);
        }
      }
    }
    int z = 0;
    for (int r = lane; r < nr; r += 32) z += static_cast<int>(sg[r]);
    z = warp_sum(z);
    if (lane == 0) ws.z[(rh0 + g) * nsplit + split] = z;
    float* out = ws.acc + ((rh0 + g) * nsplit + split) * d;
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      const int c = lane + 32 * u;
      if (c < d) out[c] = acc[u];
    }
  }
}

// Each pass is a kernel of its own name, so that a profile tells them apart.
template <int PT, int COLS, class Rows>
__global__ void __launch_bounds__(kSplitKeys)
split_qk_kernel(HCCS_SPLIT_PARAMS) {                // pass 1
  split_pass<PT, COLS, true, false>(HCCS_SPLIT_ARGS);
}

template <int PT, int COLS, class Rows>
__global__ void __launch_bounds__(kSplitKeys)
split_pv_kernel(HCCS_SPLIT_PARAMS) {                // pass 2
  split_pass<PT, COLS, false, true>(HCCS_SPLIT_ARGS);
}

template <int PT, int COLS, class Rows>
__global__ void __launch_bounds__(kSplitKeys)
split_fused_kernel(HCCS_SPLIT_PARAMS) {             // passes 1-2, static_max
  split_pass<PT, COLS, true, true>(HCCS_SPLIT_ARGS);
}

#undef HCCS_SPLIT_PARAMS
#undef HCCS_SPLIT_ARGS

// Pass 3 of one (row, kv head) block, warp w owning head kv * group + w:
// the live splits' partials summed in split order (four splits' loads in
// flight at a time), then Stage 5. A row with no live key writes zeros.
template <int COLS, class Rows>
__global__ void __launch_bounds__(1024)
split_combine_kernel(Rows rows, SplitWorkspace ws, float* __restrict__ out,
                     int num_kv, int group, int max_len, int d, int mode) {
  const int row = blockIdx.x / num_kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t rh = static_cast<int64_t>(blockIdx.x) * group + warp;
  const int nsplit = split_count(max_len);
  const int nk = min(rows.frontier(row), max_len);
  const int live = nk > 0 ? (nk + kSplitKeys - 1) / kSplitKeys : 0;
  int z = 0;
  for (int s = lane; s < live; s += 32) z += ws.z[rh * nsplit + s];
  z = warp_sum(z);
  const float* a = ws.acc + rh * nsplit * d;
  float acc[COLS];
#pragma unroll
  for (int u = 0; u < COLS; ++u) acc[u] = 0.0f;
  int s = 0;
  for (; s + 4 <= live; s += 4) {
    float v[4][COLS];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < COLS; ++u) {
        const int c = lane + 32 * u;
        v[j][u] = c < d ? a[(s + j) * d + c] : 0.0f;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int u = 0; u < COLS; ++u) acc[u] += v[j][u];
  }
  for (; s < live; ++s)
#pragma unroll
    for (int u = 0; u < COLS; ++u) {
      const int c = lane + 32 * u;
      if (c < d) acc[u] += a[s * d + c];
    }
  const float inv = mode_inv(fmaxf(static_cast<float>(z), 1.0f), mode);
  float* o = out + rh * d;
#pragma unroll
  for (int u = 0; u < COLS; ++u) {
    const int c = lane + 32 * u;
    if (c < d) o[c] = acc[u] * inv;
  }
}

template <int PT, int COLS, class Rows>
cudaError_t split_passes(const Rows& rows, const float* q, const void* k,
                         const void* v, const float* scale, const int* theta,
                         float* out, const SplitWorkspace& ws, int R,
                         int num_kv, int group, int max_len, int d, int mode,
                         int static_max, float sm_denom, int vec,
                         cudaStream_t stream) {
  const int elem = static_cast<int>(sizeof(typename Elem<PT>::T));
  const int64_t grid = static_cast<int64_t>(R) * num_kv *
                       split_count(max_len);
  auto pass = [&](auto kernel, bool qk, bool pv) {
    const size_t smem = split_smem_bytes(group, d, elem, qk, pv);
    cudaError_t err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
    kernel<<<static_cast<unsigned>(grid), kSplitKeys, smem, stream>>>(
        rows, q, k, v, scale, theta, ws, num_kv, group, max_len, d,
        sm_denom, vec);
    return cudaGetLastError();
  };
  cudaError_t e = cudaSuccess;
  if (grid > 0) {
    if (static_max) {
      e = pass(split_fused_kernel<PT, COLS, Rows>, true, true);
    } else {
      e = pass(split_qk_kernel<PT, COLS, Rows>, true, false);
      if (e == cudaSuccess)
        e = pass(split_pv_kernel<PT, COLS, Rows>, false, true);
    }
    if (e != cudaSuccess) return e;
  }
  split_combine_kernel<COLS, Rows><<<R * num_kv, 32 * group, 0, stream>>>(
      rows, ws, out, num_kv, group, max_len, d, mode);
  return cudaGetLastError();
}

// Enqueue the passes of one call on `stream`: carve `workspace` (ws_bytes
// long) into the scratch and the partials, then pass 1 and 2 (or the
// static_max pass) and pass 3. qint_out, when given, serves as the q_int
// scratch. Returns the first launch error.
template <int PT, class Rows>
cudaError_t split_launch(const Rows& rows, const float* q, const void* k,
                         const void* v, const float* scale, const int* theta,
                         float* out, int8_t* qint_out, void* workspace,
                         size_t ws_bytes, int R, int num_kv, int group,
                         int max_len, int d, int mode, int static_max,
                         float sm_denom, cudaStream_t stream) {
  const int elem = static_cast<int>(sizeof(typename Elem<PT>::T));
  const int nsplit = split_count(max_len);
  const bool scratch = qint_out == nullptr && !static_max;
  const size_t rh = static_cast<size_t>(R) * num_kv * group;
  if (max_len < 0 ||
      static_cast<int64_t>(R) * num_kv * nsplit > INT_MAX ||
      ws_bytes < split_workspace_bytes(R, num_kv * group, max_len, d,
                                       scratch))
    return cudaErrorInvalidValue;
  unsigned char* p = static_cast<unsigned char*>(workspace);
  SplitWorkspace ws;
  ws.qint = qint_out;
  if (scratch) {
    ws.qint = reinterpret_cast<int8_t*>(p);
    p += ws_align(rh * max_len);
  }
  ws.smax = reinterpret_cast<int*>(p);
  p += ws_align(rh * nsplit * 4);
  ws.z = reinterpret_cast<int*>(p);
  p += ws_align(rh * nsplit * 4);
  ws.acc = reinterpret_cast<float*>(p);
  const int vec = (d * elem) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(v) % 16 == 0;
  if (d <= 64)
    return split_passes<PT, 2>(rows, q, k, v, scale, theta, out, ws, R,
                               num_kv, group, max_len, d, mode, static_max,
                               sm_denom, vec, stream);
  if (d <= 128)
    return split_passes<PT, 4>(rows, q, k, v, scale, theta, out, ws, R,
                               num_kv, group, max_len, d, mode, static_max,
                               sm_denom, vec, stream);
  return split_passes<PT, 8>(rows, q, k, v, scale, theta, out, ws, R,
                             num_kv, group, max_len, d, mode, static_max,
                             sm_denom, vec, stream);
}

}  // namespace hccs
