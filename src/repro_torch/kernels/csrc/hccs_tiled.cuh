// hccs_tiled.cuh — the query-tiled HCCS sweep of hccs_packed.cu
// (hccs_packed_prefill); the decode kernels keep the split sweep of
// hccs_split.cuh, whose helpers (stage_rows, zero_row, dequant, the
// workspace layout and the combine pass) this sweep shares.
//
// A packed step's lanes are slot segments (serve/paged.py pack_slot_ids): a
// prefill chunk's tokens all read their slot's keys, each up to its own
// causal frontier. The split sweep gives every token its own blocks, so a
// chunk of n tokens reads the slot's K and V n times. Here a TILE is up to
// tile_tokens(group) = kTileRows / group consecutive tokens of one slot
// segment (16 at a GQA group of 4, 32 at 2): a block stages a 128-key split
// of the slot's K (then V) once, as f32, and computes it against all the
// tile's (token, query head) rows of one kv head. The math per (row, key)
// is the split sweep's, bit for bit:
//
//   logit  one sequential fmaf chain over c = 0..d-1 (int8 pools dequantized
//          as x * dq when staged); / sqrt(d) by __fdiv_rn, or by the exact
//          product with 1 / sqrt(d) when sqrt(d) is a power of two (the same
//          rounding of the same quotient); / scale[h] by __fdiv_rn; rintf;
//          the clip
//   PV     acc summed in key order within a split, keys past a row's own
//          frontier masked (never multiplied: a stale row may hold any bits),
//          sentinel keys staged as zero rows with s = 0, as in the split
//          sweep
//
// and the workspace, the partials' layouts and the combine pass are the
// split sweep's, so the output and q_int equal hccs_split.cuh's bit for bit.
//
// One host call enqueues, on one stream:
//
//   tile list  one block: slot segments cut into tiles (runs of equal
//              slot_ids >= 0, cut every tile_tokens from each run's first
//              token), each tile's largest frontier, and a work item per
//              (tile, split) below it, narrow tiles (at most kNarrowRows
//              rows: decode lanes, short chunks) and wide ones apart, into
//              the workspace; no host copy, no host wait
//   pass 1     QK, narrow items then wide ones, (item, kv head) pairs dealt
//              round robin over kGridWaves times the blocks the SMs hold;
//              q_int at live keys and the split's maximum per row, as the
//              split sweep's pass 1
//   pass 2     PV, the same way: m from the row's split maxima, s from
//              q_int, the partial Z and acc per row
//   pass 3     the split sweep's combine pass over every token (pad lanes
//              and rows without keys write zeros)
//
// (static_max: passes 1 and 2 run as one, K then V restaged in one buffer.)
//
// What bounds it (H100; chip_smoke.py phase 3's cell-shaped steps): at a
// prefill chunk, the f32 CUDA cores and the waits around them. A wide QK
// block gives warp w rows 16 w .. + 15 and a lane 4 keys (20 shared-memory
// float4 loads per 256 fmaf, a query element a broadcast), then passes its
// logits through shared memory to a row a thread pair (one true division a
// logit, q_int stored 16 bytes at a time); a wide PV block gives a thread
// 8 rows x 4 columns (3 float4 loads per 32 fmaf). A chunk's K/V is read
// once per tile, where the split sweep read it once per token. Staging each
// pair's split (and, in QK, the tile's queries) and waiting for it is about
// half of a wide pass: a block that stages the next split while it computes
// is the next step. At a decode lane, a narrow block (a thread a key, as in
// the split sweep; kernels of their own, so that five blocks an SM wait on
// memory at once) is bound by the latency of its slot's K/V, and is slower
// than the split sweep's block (91 / 140 us QK / PV against 82 / 120 at a
// 64-lane all-decode step): calls of at most kSplitSweepTokens tokens,
// where such steps live, run the split sweep. What the order
// of the sums forbids is the tensor cores: TF32, bf16 or split-f32 products
// move q_int at near-ties, a different result, which a counted-flip gate
// would have to admit first.
#pragma once

#include "hccs_split.cuh"

namespace hccs {

constexpr int kTileRows = 64;             // (token, head) rows of a tile
// a packed call of at most this many tokens runs the split sweep instead
// (hccs_packed.cu): at such widths a serving step is decode lanes, one
// token a slot, which gain nothing from a tile, and the split sweep's
// (token, kv head, split) grid is small, while the tile list and the
// tiled passes' launches would add their fixed cost to a short call
constexpr int kSplitSweepTokens = 128;
constexpr int kNarrowRows = 16;           // a narrow tile's rows, at most
constexpr int kTileThreads = kSplitKeys;  // one thread a key when staging
constexpr int kTileWarps = kTileThreads / 32;
constexpr int kListThreads = 1024;        // the tile list's one block
constexpr int kTileHead = 3;              // the tile list's counters
// a pass's grid: this many times the blocks the SMs hold at once, each
// taking every gridDim.x-th (item, kv head) pair, so that the blocks that
// finish first start the last ones and the pass does not wait on a tail
constexpr int kGridWaves = 4;
constexpr int kLStride = kSplitKeys + 4;  // floats of a row's logits
// per-block head of the shared memory: per key its pool offset and K / V
// dequant scales, per tile token its frontier, per (warp, narrow row) a
// partial maximum or Z, the split's allocated keys as a bit mask
constexpr size_t kTileHeadBytes = static_cast<size_t>(kSplitKeys) * 16 +
                                  kTileRows * 4 +
                                  kTileWarps * kNarrowRows * 4 + 16;

__host__ __device__ inline int tile_tokens(int group) {
  return group >= kTileRows ? 1 : kTileRows / group;
}

// Floats of a staged row: d rounded to 8, plus 4, where a warp's lanes
// read different rows at one column (query and K rows; the float4 loads of
// 8 rows then fall in 8 different bank quads), d rounded to 4 where they
// all read one row (the V rows of a PV pass).
__host__ __device__ inline int tile_stride(int d, bool qk = true) {
  return qk ? (d + 7) / 8 * 8 + 4 : (d + 3) / 4 * 4;
}

// Dynamic shared memory of a tiled pass (decode.py tiled_smem_bytes gives
// the wide ones' largest): the head, the tile's query rows (QK) and s per
// (key, row) of a wide tile, (row, key) of a narrow one (PV), in one union,
// and the split's kSplitKeys staged f32 rows; a wide QK pass passes its
// logits through the same space (kTileRows rows of kLStride floats).
inline size_t tiled_smem_bytes(int d, bool qk, bool pv, bool narrow) {
  const int rows = narrow ? kNarrowRows : kTileRows;
  const size_t q = qk ? static_cast<size_t>(rows) * tile_stride(d) * 4 : 0;
  const size_t s =
      pv ? static_cast<size_t>(kSplitKeys) * (narrow ? rows : rows + 4) * 4
         : 0;
  const size_t body = (q > s ? q : s) + static_cast<size_t>(kSplitKeys) *
                                            tile_stride(d, qk) * 4;
  const size_t logits =
      qk && !pv && !narrow ? static_cast<size_t>(kTileRows) * kLStride * 4
                           : 0;
  return kTileHeadBytes + (body > logits ? body : logits);
}

// The tile list, after the split sweep's workspace: the work items, then 3
// counters, then per tile its first token, tokens and top frontier.
struct TileList {
  int tokens;  // T
  int4* item;  // (T * nsplit,) {first token, tokens, top, split}: wide
               // items from the front, narrow ones from the back
  int* head;   // tiles, wide items, narrow items
  int* start;  // (T,) first token of each tile
  int* len;    // (T,) its tokens
  int* top;    // (T,) its largest frontier, capped at max_len
};

inline size_t tile_list_bytes(int tokens, int max_len) {
  return static_cast<size_t>(tokens) * split_count(max_len) * 16 +
         (kTileHead + 3 * static_cast<size_t>(tokens)) * 4;
}

// Bytes of a packed call's workspace (decode.py workspace_bytes with
// tiles): the split sweep's regions, aligned, then the tile list.
inline size_t tiled_workspace_bytes(int tokens, int heads, int max_len,
                                    int d, bool qint_scratch) {
  return ws_align(split_workspace_bytes(tokens, heads, max_len, d,
                                        qint_scratch)) +
         tile_list_bytes(tokens, max_len);
}

// Inclusive scan of v over the kListThreads threads of a block, by max or
// by sum; *total receives the block's reduction.
template <bool kMax>
__device__ __forceinline__ int block_scan(int v, int* sh, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = kMax ? max(v, n) : v + n;
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = sh[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w = kMax ? max(w, n) : w + n;
    }
    sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0) v = kMax ? max(v, sh[warp - 1]) : v + sh[warp - 1];
  *total = sh[31];
  __syncthreads();
  return v;
}

// The tile list of a call, in token order. A token t >= 0 of slot s belongs
// to the run of equal slot ids around it; runs are cut into tiles of `tq`
// tokens from their first token. Each tile's top is the largest of its
// tokens' frontiers (capped at max_len); its work items are its splits
// below top, narrow if the tile has at most kNarrowRows rows.
template <class Rows>
__global__ void __launch_bounds__(kListThreads)
tile_list_kernel(Rows rows, const int* __restrict__ slot_ids, int T, int tq,
                 int group, int max_len, TileList tl) {
  __shared__ int sh[32];
  __shared__ int carry[3];  // the last run's first token, tiles so far
  const int tid = threadIdx.x;
  if (tid == 0) carry[0] = carry[1] = 0;
  __syncthreads();
  for (int base = 0; base < T; base += kListThreads) {
    const int t = base + tid;
    const bool in = t < T;
    const int sid = in ? slot_ids[t] : -1;
    const bool first_of_run = in && (t == 0 || slot_ids[t - 1] != sid);
    int total;
    const int run0 = max(block_scan<true>(first_of_run ? t : -1, sh, &total),
                         carry[0]);
    const int pos = t - run0;
    const bool own = in && sid >= 0;
    const bool first = own && pos % tq == 0;
    const int tile = carry[1] + block_scan<false>(first, sh, &total) - 1;
    if (first) {
      tl.start[tile] = t;
      tl.top[tile] = 0;
    }
    if (own && (t + 1 == T || slot_ids[t + 1] != sid || (pos + 1) % tq == 0))
      tl.len[tile] = pos % tq + 1;
    __syncthreads();                     // tops zeroed before the maxima
    if (own) atomicMax(tl.top + tile, min(rows.frontier(t), max_len));
    __syncthreads();
    if (tid == kListThreads - 1) {
      carry[0] = run0;
      carry[1] += total;
    }
    __syncthreads();
  }
  const int tiles = carry[1];
  const int cap = T * split_count(max_len);
  __syncthreads();
  if (tid == 0) carry[0] = carry[2] = 0;
  __syncthreads();
  for (int base = 0; base < tiles; base += kListThreads) {
    const int i = base + tid;
    int t0 = 0, n = 0, top = 0;
    if (i < tiles) {
      t0 = tl.start[i];
      n = tl.len[i];
      top = tl.top[i];
    }
    const int ns = split_count(top);
    const bool narrow = n * group <= kNarrowRows;
    int wide_total, narrow_total;
    const int wide_off = carry[0] - (narrow ? 0 : ns) +
                         block_scan<false>(narrow ? 0 : ns, sh, &wide_total);
    const int narrow_off = carry[2] - (narrow ? ns : 0) +
                           block_scan<false>(narrow ? ns : 0, sh,
                                             &narrow_total);
    for (int s = 0; s < ns; ++s)
      tl.item[narrow ? cap - 1 - (narrow_off + s) : wide_off + s] =
          make_int4(t0, n, top, s);
    __syncthreads();
    if (tid == 0) {
      carry[0] += wide_total;
      carry[2] += narrow_total;
    }
    __syncthreads();
  }
  if (tid == 0) {
    tl.head[0] = tiles;
    tl.head[1] = carry[0];
    tl.head[2] = carry[2];
  }
}

// Stage the 32 rows [r0, r0 + 32) of a split as f32 rows of `stride`
// floats, dequantized as the split sweep dequantizes them (x * dq for int8
// pools); rows with a negative offset (dead keys) are left unwritten. One
// warp, an element a lane at a time: the path of every pool but a
// 16-byte-aligned f32 one, which stage_rows copies with cp.async.
template <int PT>
__device__ __forceinline__ void stage_f32(float* dst, const void* src,
                                          const int64_t* bases,
                                          const float* dqs, int r0,
                                          int stride, int d, int lane) {
  for (int i = lane; i < 32 * d; i += 32) {
    const int r = i / d, c = i - r * d;
    const int64_t b = bases[r0 + r];
    if (b < 0) continue;
    dst[(r0 + r) * stride + c] =
        dequant<PT>(load_elem<PT>(src, b + c), dqs[r0 + r]);
  }
}

template <int PT>
__device__ __forceinline__ void stage_split(float* dst, const void* src,
                                            const int64_t* bases,
                                            const float* dqs, int stride,
                                            int d, int kvec, int warp,
                                            int lane) {
  if (PT == kF32 && kvec)
    stage_rows<float>(reinterpret_cast<unsigned char*>(dst), src, bases,
                      warp * 32, stride * 4, d, true, lane);
  else
    stage_f32<PT>(dst, src, bases, dqs, warp * 32, stride, d, lane);
}

// q_int of one logit, as the split sweep computes it.
__device__ __forceinline__ int quantize(float a, float sm_denom,
                                        float inv_denom, bool pow2,
                                        float scale) {
  const float l = pow2 ? __fmul_rn(a, inv_denom) : __fdiv_rn(a, sm_denom);
  float x = rintf(__fdiv_rn(l, scale));
  x = fminf(fmaxf(x, -128.0f), 127.0f);
  return static_cast<int>(x);
}

// QK of a wide tile: warp w's rows 16 w + i against the keys lane + 32 j
// of the staged split, each logit one sequential fmaf chain over the
// columns (a query element a broadcast, a key row a lane's own).
__device__ __forceinline__ void qk_wide(const float* qs, const float* kt,
                                        int stride, int d, bool vec4,
                                        float (&a)[16][4]) {
  if (vec4) {
#pragma unroll 2
    for (int c = 0; c < d; c += 4) {
      float4 k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        k[j] = *reinterpret_cast<const float4*>(kt + j * 32 * stride + c);
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float4 w = *reinterpret_cast<const float4*>(qs + i * stride + c);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          a[i][j] = fmaf(w.x, k[j].x, a[i][j]);
          a[i][j] = fmaf(w.y, k[j].y, a[i][j]);
          a[i][j] = fmaf(w.z, k[j].z, a[i][j]);
          a[i][j] = fmaf(w.w, k[j].w, a[i][j]);
        }
      }
    }
  } else {
    for (int c = 0; c < d; ++c) {
      float k[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) k[j] = kt[j * 32 * stride + c];
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const float w = qs[i * stride + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = fmaf(w, k[j], a[i][j]);
      }
    }
  }
}

// QK of a narrow tile: the thread's own key row kr against rows
// qs .. qs + 3 rows.
__device__ __forceinline__ void qk_narrow(const float* qs, const float* kr,
                                          int stride, int d, bool vec4,
                                          float* a) {
  if (vec4) {
#pragma unroll 2
    for (int c = 0; c < d; c += 4) {
      const float4 k = *reinterpret_cast<const float4*>(kr + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4 w =
            *reinterpret_cast<const float4*>(qs + e * stride + c);
        a[e] = fmaf(w.x, k.x, a[e]);
        a[e] = fmaf(w.y, k.y, a[e]);
        a[e] = fmaf(w.z, k.z, a[e]);
        a[e] = fmaf(w.w, k.w, a[e]);
      }
    }
  } else {
    for (int c = 0; c < d; ++c) {
      const float k = kr[c];
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = fmaf(qs[e * stride + c], k, a[e]);
    }
  }
}

// PV of a wide tile: thread (rg, cg)'s rows rg * 8 + i and columns
// c .. c + 3 (vp = the staged rows at column c), keys j0 .. j1 - 1 in
// order; with kMasked, key j adds to row i only below nlim[i].
template <bool kMasked>
__device__ __forceinline__ void pv_wide(const float* sp, const float* vp,
                                        int stride, int j0, int j1,
                                        const int (&nlim)[8], int ncols,
                                        bool vec4, float (&acc)[8][4]) {
  constexpr int kSS = kTileRows + 4;
  for (int j = j0; j < j1; ++j) {
    float s[8];
    const float4 s0 = *reinterpret_cast<const float4*>(sp + j * kSS);
    const float4 s1 = *reinterpret_cast<const float4*>(sp + j * kSS + 4);
    s[0] = s0.x; s[1] = s0.y; s[2] = s0.z; s[3] = s0.w;
    s[4] = s1.x; s[5] = s1.y; s[6] = s1.z; s[7] = s1.w;
    float v[4];
    if (vec4) {
      const float4 w = *reinterpret_cast<const float4*>(vp + j * stride);
      v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = u < ncols ? vp[j * stride + u] : 0.0f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (kMasked && j >= nlim[i]) continue;
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(s[i], v[u], acc[i][u]);
    }
  }
}

// PV of a narrow tile: warp w's rows w + 4 e (e < ne; sp = s of row w,
// rows kSplitKeys floats apart), the lane's columns c, c + 1 (vp = the
// staged rows at column c), keys j0 .. j1 - 1 in order.
template <bool kMasked>
__device__ __forceinline__ void pv_narrow(const float* sp, const float* vp,
                                          int stride, int j0, int j1, int ne,
                                          const int (&nlim)[4], int ncols,
                                          bool vec2, float (&acc)[4][2]) {
  for (int j = j0; j < j1; ++j) {
    float v[2];
    if (vec2) {
      const float2 w = *reinterpret_cast<const float2*>(vp + j * stride);
      v[0] = w.x;
      v[1] = w.y;
    } else {
      v[0] = vp[j * stride];
      v[1] = ncols > 1 ? vp[j * stride + 1] : 0.0f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (e >= ne) break;                             // uniform per warp
      if (kMasked && j >= nlim[e]) continue;
      const float s = sp[4 * e * kSplitKeys + j];
      acc[e][0] = fmaf(s, v[0], acc[e][0]);
      acc[e][1] = fmaf(s, v[1], acc[e][1]);
    }
  }
}

#define HCCS_TILED_PARAMS                                                     \
  Rows rows, TileList tl, const float* __restrict__ q,                        \
      const void* __restrict__ k_src, const void* __restrict__ v_src,         \
      const float* __restrict__ scale, const int* __restrict__ theta,         \
      SplitWorkspace ws, int num_kv, int group, int max_len, int d,           \
      float sm_denom, int kvec, int qvec
#define HCCS_TILED_ARGS                                                       \
  rows, tl, q, k_src, v_src, scale, theta, ws, num_kv, group, max_len, d,     \
      sm_denom, kvec, qvec

// Pass 1 (kQK), pass 2 (kPV) or the static_max pass (both) of the tiled
// sweep, over the narrow (kNarrow) or the wide items: a persistent block of
// kTileThreads threads takes (item, kv head) pairs until none is left. Per
// pair, thread t looks key k0 + t up through the tile's slot
// (Rows::locate of its first token) and warp w stages the rows of keys
// [32w, 32w + 32): K in QK, V in PV. Row r of a tile is token
// t0 + r / group, query head kv * group + r % group; its live keys lie
// below its own frontier, outside a sentinel block.
//
// QK, with the tile's query rows staged beside K: a wide block gives warp w
// rows 16 w .. + 15 and a lane the keys lane + 32 j; a narrow one a thread
// its own key against every row. q_int is written at live keys, and each
// row's split maximum (reduced over the warp, then the warps) where the
// split holds keys below the row's frontier, as the split sweep writes it.
// PV: s (0 where dead) and Z from q_int and m, then s @ V with keys in
// order, each row masked at its frontier: a wide block gives thread
// (rg = t / 16, cg = t % 16) rows rg * 8 .. + 7 and columns cg * 4 .. + 3 of
// each 64-column chunk, a narrow one warp w rows w + 4 e and a lane columns
// 2 lane, 2 lane + 1.
template <int PT, bool kQK, bool kPV, bool kNarrow, class Rows>
__device__ __forceinline__ void tiled_pass(HCCS_TILED_PARAMS) {
  constexpr int kRows = kNarrow ? kNarrowRows : kTileRows;
  constexpr int kSS = kTileRows + 4;            // floats of a wide key's s
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int heads = num_kv * group;
  const int nsplit = split_count(max_len);
  const int stride = tile_stride(d, kQK);
  const bool vec4 = (d & 3) == 0, vec2 = (d & 1) == 0;
  const bool pow2 = (__float_as_uint(sm_denom) & 0x7fffffu) == 0u;
  const float inv_denom = __frcp_rn(sm_denom);
  const bool q16 = (max_len & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(ws.qint) & 15) == 0;
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* bases = reinterpret_cast<int64_t*>(smem);
  float* kdqs = reinterpret_cast<float*>(smem + kSplitKeys * 8);
  float* vdqs = kdqs + kSplitKeys;
  int* frs = reinterpret_cast<int*>(vdqs + kSplitKeys);
  int* part = frs + kTileRows;                      // (warp, narrow row)
  unsigned* kmask =
      reinterpret_cast<unsigned*>(part + kTileWarps * kNarrowRows);
  float* qs = reinterpret_cast<float*>(smem + kTileHeadBytes);  // Q, or s
  float* ss = qs;
  const size_t u_q = kQK ? static_cast<size_t>(kRows) * stride : 0;
  const size_t u_s =
      kPV ? static_cast<size_t>(kSplitKeys) * (kNarrow ? kRows : kSS) : 0;
  float* rt = qs + (u_q > u_s ? u_q : u_s);          // the split's rows
  const int cap = nsplit * tl.tokens;
  const int work = tl.head[kNarrow ? 2 : 1] * num_kv;
  // block b takes the pairs b, b + gridDim.x, ...; each reads its next
  // item while it works on this one
  auto item_of = [&](int i) {
    const int w = i / num_kv;
    return i < work ? tl.item[kNarrow ? cap - 1 - w : w]
                    : make_int4(0, 0, 0, 0);
  };
  int4 e_nxt = item_of(blockIdx.x);

  for (int it = blockIdx.x; it < work; it += gridDim.x) {
    const int4 e = e_nxt;
    e_nxt = item_of(it + gridDim.x);
    const int kv = it % num_kv;
    const int t0 = e.x, ntok = e.y, split = e.w;
    const int nrows = ntok * group;
    const int k0 = split * kSplitKeys;
    const int nkeys = min(e.z - k0, kSplitKeys);
    if (tid < ntok) frs[tid] = min(rows.frontier(t0 + tid), max_len);
    int qv[kNarrowRows], mr[kNarrowRows];            // narrow pass 2: each
    if (!kQK && kNarrow) {                           // row's q_int at this
#pragma unroll                                       // thread's key and its
      for (int r = 0; r < kNarrowRows; ++r) {        // share of m, loaded
        qv[r] = 0;                                   // before the split's
        mr[r] = kNegBig;                             // keys are located
        if (r < nrows) {
          const int tok = r / group;
          const int64_t row = static_cast<int64_t>(t0 + tok) * heads +
                              kv * group + (r - tok * group);
          const int fr = min(rows.frontier(t0 + tok), max_len);
          if (k0 + tid < fr) qv[r] = ws.qint[row * max_len + k0 + tid];
          if (lane < split_count(max(fr, 0)))        // the rest below
            mr[r] = ws.smax[row * nsplit + lane];
        }
      }
    }
    int64_t base = 0;
    float kdq = 1.0f, vdq = 1.0f;
    const bool live =
        tid < nkeys && rows.locate(t0, kv, k0 + tid, &base, &kdq, &vdq);
    bases[tid] = live ? base : -1;
    kdqs[tid] = kdq;
    vdqs[tid] = vdq;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) kmask[warp] = bal;
    __syncwarp();
    stage_split<PT>(rt, kQK ? k_src : v_src, bases, kQK ? kdqs : vdqs,
                    stride, d, kvec, warp, lane);
    if (kQK) {
      const int64_t q0 = static_cast<int64_t>(t0) * heads + kv * group;
      if (qvec) {
        const int cpr = d / 4;
        for (int i = tid; i < nrows * cpr; i += kTileThreads) {
          const int r = i / cpr, c = i - r * cpr;
          const int tok = r / group;
          cp_async16(qs + r * stride + c * 4,
                     q + (q0 + static_cast<int64_t>(tok) * heads +
                          (r - tok * group)) * d + c * 4);
        }
      } else {
        for (int i = tid; i < nrows * d; i += kTileThreads) {
          const int r = i / d, c = i - r * d;
          const int tok = r / group;
          qs[r * stride + c] =
              q[(q0 + static_cast<int64_t>(tok) * heads + (r - tok * group)) *
                    d + c];
        }
      }
    }
    cp_async_commit();
    if (!kQK && !live && tid < nkeys)
      zero_row(reinterpret_cast<unsigned char*>(rt + tid * stride),
               stride * 4);
    __syncthreads();                                 // frs, bases

    if (!kQK && kNarrow) {                           // pass 2: s, a key a
#pragma unroll                                       // thread
      for (int r = 0; r < kNarrowRows; ++r) {
        if (r >= nrows) break;                       // uniform
        const int tok = r / group;
        const int h = kv * group + (r - tok * group);
        const int64_t row = static_cast<int64_t>(t0 + tok) * heads + h;
        for (int s = lane + 32; s < split_count(max(frs[tok], 0)); s += 32)
          mr[r] = max(mr[r], ws.smax[row * nsplit + s]);
        const int m = warp_max(mr[r]);
        int s = 0;
        if (live && k0 + tid < frs[tok])
          s = theta[3 * h] -
              theta[3 * h + 1] * min(m - qv[r], theta[3 * h + 2]);
        ss[r * kSplitKeys + tid] = static_cast<float>(s);
      }                                              // (Z beside the PV)
    } else if (!kQK) {                               // pass 2: s, a row a
      const int r = tid >> 1, half = tid & 1;        // thread pair
      const bool rl = r < nrows;
      const int tok = rl ? r / group : 0;
      const int h = kv * group + (r - tok * group);
      const int64_t row = static_cast<int64_t>(t0 + tok) * heads + h;
      const int fr = rl ? frs[tok] : 0;
      const int ns = split_count(max(fr, 0));
      int m = kNegBig;
#pragma unroll 4
      for (int s = half; s < ns; s += 2)
        m = max(m, ws.smax[row * nsplit + s]);
      m = max(m, __shfl_xor_sync(0xffffffffu, m, 1));
      int z = 0;
      const int lo = half * (kSplitKeys / 2);
      const int hi = min(lo + kSplitKeys / 2, nkeys);
      if (rl && lo < hi) {
        const int b = theta[3 * h], sl = theta[3 * h + 1];
        const int dd = theta[3 * h + 2];
        const int8_t* qrow = ws.qint + row * max_len + k0;
        if (q16) {
          int4 wv[4];
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (lo + 16 * c < hi)
              wv[c] = *reinterpret_cast<const int4*>(qrow + lo + 16 * c);
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int8_t* x = reinterpret_cast<const int8_t*>(&wv[c]);
#pragma unroll
            for (int i = 0; i < 16; ++i) {
              const int kl = lo + 16 * c + i;
              if (kl < hi) {
                int s = 0;
                if (k0 + kl < fr && bases[kl] >= 0)
                  s = b - sl * min(m - static_cast<int>(x[i]), dd);
                ss[kl * kSS + r] = static_cast<float>(s);
                z += s;
              }
            }
          }
        } else {
#pragma unroll 8
          for (int kl = lo; kl < hi; ++kl) {
            int s = 0;
            if (k0 + kl < fr && bases[kl] >= 0)
              s = b - sl * min(m - static_cast<int>(qrow[kl]), dd);
            ss[kl * kSS + r] = static_cast<float>(s);
            z += s;
          }
        }
      }
      z += __shfl_xor_sync(0xffffffffu, z, 1);
      if (half == 0 && rl && k0 < fr) ws.z[row * nsplit + split] = z;
    } else if (kNarrow) {                            // QK, a key a thread
      cp_async_wait_all();
      __syncthreads();                               // Q and K rows
      float a[kNarrowRows];
#pragma unroll
      for (int r = 0; r < kNarrowRows; ++r) a[r] = 0.0f;
#pragma unroll
      for (int r0 = 0; r0 < kNarrowRows; r0 += 4)
        if (r0 < nrows)
          qk_narrow(qs + r0 * stride, rt + tid * stride, stride, d, vec4,
                    a + r0);
      if (kPV) {                                     // Q and K consumed
        __syncthreads();
        stage_split<PT>(rt, v_src, bases, vdqs, stride, d, kvec, warp,
                        lane);
        cp_async_commit();
        if (!live && tid < nkeys)
          zero_row(reinterpret_cast<unsigned char*>(rt + tid * stride),
                   stride * 4);
      }
#pragma unroll
      for (int r = 0; r < kNarrowRows; ++r) {
        if (r >= nrows) break;                       // uniform
        const int tok = r / group;
        const int h = kv * group + (r - tok * group);
        const int64_t row = static_cast<int64_t>(t0 + tok) * heads + h;
        const bool lv = live && k0 + tid < frs[tok];
        int qv = kNegBig;
        if (lv) {
          qv = quantize(a[r], sm_denom, inv_denom, pow2, scale[h]);
          if (ws.qint != nullptr)
            ws.qint[row * max_len + k0 + tid] = static_cast<int8_t>(qv);
        }
        if (kPV) {
          int s = 0;
          if (lv) {
            const int* th = theta + 3 * h;
            s = th[0] - th[1] * min(kStaticMax - qv, th[2]);
          }
          ss[r * kSplitKeys + tid] = static_cast<float>(s);
          s = warp_sum(s);
          if (lane == 0) part[warp * kNarrowRows + r] = s;
        } else {
          qv = warp_max(qv);
          if (lane == 0) part[warp * kNarrowRows + r] = qv;
        }
      }
      __syncthreads();                               // the warps' parts
      if (tid < nrows) {
        const int tok = tid / group;
        const int64_t row = static_cast<int64_t>(t0 + tok) * heads +
                            kv * group + (tid - tok * group);
        int x = part[tid];
        for (int w2 = 1; w2 < kTileWarps; ++w2)
          x = kPV ? x + part[w2 * kNarrowRows + tid]
                  : max(x, part[w2 * kNarrowRows + tid]);
        if (k0 < frs[tok]) (kPV ? ws.z : ws.smax)[row * nsplit + split] = x;
      }
    } else {                                         // QK, 16 rows a warp
      cp_async_wait_all();
      __syncthreads();                               // Q and K rows
      float a[16][4];
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) a[i][j] = 0.0f;
      if (warp * 16 < nrows)
        qk_wide(qs + warp * 16 * stride, rt + lane * stride, stride, d, vec4,
                a);
      if (kPV) {                                     // Q and K consumed
        __syncthreads();
        stage_split<PT>(rt, v_src, bases, vdqs, stride, d, kvec, warp,
                        lane);
        cp_async_commit();
        if (!live && tid < nkeys)
          zero_row(reinterpret_cast<unsigned char*>(rt + tid * stride),
                   stride * 4);
      }
      if (kPV) {                                     // static_max: s
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int r = warp * 16 + i;
          const bool rl = r < nrows;
          const int tok = rl ? r / group : 0;
          const int h = kv * group + (r - tok * group);
          const int64_t row = static_cast<int64_t>(t0 + tok) * heads + h;
          const int fr = rl ? frs[tok] : 0;
          const float sc = rl ? scale[h] : 1.0f;
          int z = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kl = lane + 32 * j;
            const bool lv = rl && k0 + kl < fr && bases[kl] >= 0;
            int s = 0;
            if (lv) {
              const int qv = quantize(a[i][j], sm_denom, inv_denom, pow2, sc);
              if (ws.qint != nullptr)
                ws.qint[row * max_len + k0 + kl] = static_cast<int8_t>(qv);
              const int* th = theta + 3 * h;
              s = th[0] - th[1] * min(kStaticMax - qv, th[2]);
            }
            ss[kl * kSS + r] = static_cast<float>(s);
            z += s;
          }
          z = warp_sum(z);
          if (lane == 0 && rl && k0 < fr) ws.z[row * nsplit + split] = z;
        }
      } else {                                       // the logits through
        __syncthreads();                             // shared memory, then
        float* lg = qs;                              // a row a thread pair
#pragma unroll
        for (int i = 0; i < 16; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            lg[(warp * 16 + i) * kLStride + lane + 32 * j] = a[i][j];
        __syncthreads();
        const int r = tid >> 1, half = tid & 1;
        const bool rl = r < nrows;
        const int tok = rl ? r / group : 0;
        const int h = kv * group + (r - tok * group);
        const int64_t row = static_cast<int64_t>(t0 + tok) * heads + h;
        const int fr = rl ? frs[tok] : 0;
        const int lo = half * (kSplitKeys / 2);
        const int hi = min(lo + kSplitKeys / 2, fr - k0);
        int mx = kNegBig;
        if (rl && lo < hi) {
          const float sc = scale[h];
          const float* lr = lg + r * kLStride;
          const uint64_t alloc = kmask[2 * half] |
                                 static_cast<uint64_t>(kmask[2 * half + 1])
                                     << 32;
          int8_t* qrow =
              ws.qint == nullptr ? nullptr : ws.qint + row * max_len + k0;
          for (int c = lo; c < hi; c += 16) {
            uint32_t pk[4] = {0u, 0u, 0u, 0u};
            unsigned on = 0u;                        // keys written
#pragma unroll
            for (int e4 = 0; e4 < 4; ++e4) {
              const float4 x4 =
                  *reinterpret_cast<const float4*>(lr + c + 4 * e4);
              const float x[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const int kl = c + 4 * e4 + u;
                if (kl < hi && ((alloc >> (kl - lo)) & 1u)) {
                  const int qv = quantize(x[u], sm_denom, inv_denom, pow2, sc);
                  mx = max(mx, qv);
                  pk[e4] |= (static_cast<uint32_t>(qv) & 0xffu) << (8 * u);
                  on |= 1u << (4 * e4 + u);
                }
              }
            }
            if (qrow != nullptr) {
              if (on == 0xffffu && q16) {
                *reinterpret_cast<uint4*>(qrow + c) =
                    make_uint4(pk[0], pk[1], pk[2], pk[3]);
              } else {
#pragma unroll
                for (int i = 0; i < 16; ++i)
                  if ((on >> i) & 1u)
                    qrow[c + i] =
                        static_cast<int8_t>(pk[i / 4] >> (8 * (i % 4)));
              }
            }
          }
        }
        mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        if (half == 0 && rl && k0 < fr) ws.smax[row * nsplit + split] = mx;
      }
    }

    if (kPV) {                                       // Stages 2-4
      cp_async_wait_all();
      __syncthreads();                               // V rows and s
      if (kNarrow) {
        const int ne = nrows > warp ? (nrows - warp + 3) / 4 : 0;
        int nlim[4];
        int jmin = kSplitKeys, jmax = 0;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = warp + 4 * i;
          nlim[i] = i < ne ? min(max(frs[r / group] - k0, 0), nkeys) : 0;
          if (i < ne) jmin = min(jmin, nlim[i]);
          jmax = max(jmax, nlim[i]);
        }
        if (!kQK) {                                  // pass 2: Z of the
#pragma unroll                                       // warp's rows
          for (int i = 0; i < 4; ++i) {
            if (i >= ne) break;
            int z = 0;
            for (int j = lane; j < nlim[i]; j += 32)
              z += static_cast<int>(ss[(warp + 4 * i) * kSplitKeys + j]);
            z = warp_sum(z);
            const int r = warp + 4 * i;
            const int tok = r / group;
            if (lane == 0 && nlim[i] > 0)
              ws.z[(static_cast<int64_t>(t0 + tok) * heads + kv * group +
                    (r - tok * group)) * nsplit + split] = z;
          }
        }
        for (int cc = 0; cc < d; cc += 64) {
          const int c = cc + 2 * lane;
          if (jmax == 0 || c >= d) continue;
          float acc[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.0f;
          const int ncols = min(2, d - c);
          const float* sp = ss + warp * kSplitKeys;
          pv_narrow<false>(sp, rt + c, stride, 0, jmin, ne, nlim, ncols,
                           vec2, acc);
          pv_narrow<true>(sp, rt + c, stride, jmin, jmax, ne, nlim, ncols,
                          vec2, acc);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            if (i >= ne) break;
            if (nlim[i] == 0) continue;
            const int r = warp + 4 * i;
            const int tok = r / group;
            const int64_t row = static_cast<int64_t>(t0 + tok) * heads +
                                kv * group + (r - tok * group);
            float* out = ws.acc + (row * nsplit + split) * d + c;
            if (vec2) {
              *reinterpret_cast<float2*>(out) =
                  make_float2(acc[i][0], acc[i][1]);
            } else {
              out[0] = acc[i][0];
              if (ncols > 1) out[1] = acc[i][1];
            }
          }
        }
      } else {
        const int rg = tid >> 4, cg = tid & 15;
        int nlim[8];
        int jmin = kSplitKeys, jmax = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rg * 8 + i;
          nlim[i] = r < nrows ? min(max(frs[r / group] - k0, 0), nkeys) : 0;
          jmin = min(jmin, nlim[i]);
          jmax = max(jmax, nlim[i]);
        }
        for (int cc = 0; cc < d; cc += 64) {
          const int c = cc + cg * 4;
          if (jmax == 0 || c >= d) continue;
          float acc[8][4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int u = 0; u < 4; ++u) acc[i][u] = 0.0f;
          const float* sp = ss + rg * 8;
          const float* vp = rt + c;
          const int ncols = min(4, d - c);
          pv_wide<false>(sp, vp, stride, 0, jmin, nlim, ncols, vec4, acc);
          pv_wide<true>(sp, vp, stride, jmin, jmax, nlim, ncols, vec4, acc);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            if (nlim[i] == 0) continue;
            const int r = rg * 8 + i;
            const int tok = r / group;
            const int64_t row = static_cast<int64_t>(t0 + tok) * heads +
                                kv * group + (r - tok * group);
            float* out = ws.acc + (row * nsplit + split) * d + c;
            if (vec4) {
              *reinterpret_cast<float4*>(out) =
                  make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (u < ncols) out[u] = acc[i][u];
            }
          }
        }
      }
    }
    __syncthreads();                                 // smem free again
  }
}

// Each pass is a kernel of its own name, so that a profile tells them
// apart; the narrow and wide instances are kernels of their own, so that
// the narrow ones (few registers, less shared memory) keep more blocks
// resident.
template <int PT, bool kNarrow, class Rows>
__global__ void __launch_bounds__(kTileThreads, kNarrow ? 5 : 4)
tiled_qk_kernel(HCCS_TILED_PARAMS) {                 // pass 1
  tiled_pass<PT, true, false, kNarrow>(HCCS_TILED_ARGS);
}

template <int PT, bool kNarrow, class Rows>
__global__ void __launch_bounds__(kTileThreads, kNarrow ? 5 : 3)
tiled_pv_kernel(HCCS_TILED_PARAMS) {                 // pass 2
  tiled_pass<PT, false, true, kNarrow>(HCCS_TILED_ARGS);
}

template <int PT, bool kNarrow, class Rows>
__global__ void __launch_bounds__(kTileThreads, kNarrow ? 5 : 3)
tiled_fused_kernel(HCCS_TILED_PARAMS) {              // passes 1-2, static_max
  tiled_pass<PT, true, true, kNarrow>(HCCS_TILED_ARGS);
}

#undef HCCS_TILED_PARAMS
#undef HCCS_TILED_ARGS

// Enqueue the tiled passes of one call on `stream`: carve `workspace`
// (ws_bytes long) as split_launch does and the tile list after it; the
// tile list, pass 1 and 2 (or the static_max pass), each a narrow and a
// wide persistent grid of as many blocks as the SMs hold, and the split
// sweep's pass 3 over all T tokens. Returns the first launch error.
template <int PT, class Rows>
cudaError_t tiled_launch(const Rows& rows, const int* slot_ids, const float* q,
                         const void* k, const void* v, const float* scale,
                         const int* theta, float* out, int8_t* qint_out,
                         void* workspace, size_t ws_bytes, int T, int num_kv,
                         int group, int max_len, int d, int mode,
                         int static_max, float sm_denom,
                         cudaStream_t stream) {
  const int nsplit = split_count(max_len);
  const bool scratch = qint_out == nullptr && !static_max;
  const int heads = num_kv * group;
  const size_t rh = static_cast<size_t>(T) * heads;
  if (max_len < 0 ||
      static_cast<int64_t>(T) * num_kv * nsplit > INT_MAX ||
      static_cast<int64_t>(T) * heads * nsplit > INT_MAX ||
      ws_bytes < tiled_workspace_bytes(T, heads, max_len, d, scratch))
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
  TileList tl;
  tl.tokens = T;
  tl.item = reinterpret_cast<int4*>(
      static_cast<unsigned char*>(workspace) +
      ws_align(split_workspace_bytes(T, heads, max_len, d, scratch)));
  tl.head = reinterpret_cast<int*>(tl.item + static_cast<size_t>(T) * nsplit);
  tl.start = tl.head + kTileHead;
  tl.len = tl.start + T;
  tl.top = tl.len + T;
  const int kvec = PT == kF32 && d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v) % 16 == 0;
  const int qvec = d % 4 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  cudaError_t e = cudaSuccess;
  if (nsplit > 0) {
    tile_list_kernel<Rows><<<1, kListThreads, 0, stream>>>(
        rows, slot_ids, T, tile_tokens(group), group, max_len, tl);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    const int sms = device_attr(0, 132);
    auto pass = [&](auto kernel, bool qk, bool pv, bool narrow) {
      const size_t smem = tiled_smem_bytes(d, qk, pv, narrow);
      int per_sm = 0;
      const cudaError_t err =
          resident_blocks(kernel, kTileThreads, smem, &per_sm);
      if (err != cudaSuccess) return err;
      const int64_t bound = static_cast<int64_t>(T) * nsplit * num_kv;
      const int64_t fill =
          static_cast<int64_t>(max(per_sm, 1)) * sms * kGridWaves;
      kernel<<<static_cast<unsigned>(bound < fill ? bound : fill),
               kTileThreads, smem, stream>>>(
          rows, tl, q, k, v, scale, theta, ws, num_kv, group, max_len, d,
          sm_denom, kvec, qvec);
      return cudaGetLastError();
    };
    if (static_max) {
      e = pass(tiled_fused_kernel<PT, true, Rows>, true, true, true);
      if (e == cudaSuccess)
        e = pass(tiled_fused_kernel<PT, false, Rows>, true, true, false);
    } else {
      e = pass(tiled_qk_kernel<PT, true, Rows>, true, false, true);
      if (e == cudaSuccess)
        e = pass(tiled_qk_kernel<PT, false, Rows>, true, false, false);
      if (e == cudaSuccess)
        e = pass(tiled_pv_kernel<PT, true, Rows>, false, true, true);
      if (e == cudaSuccess)
        e = pass(tiled_pv_kernel<PT, false, Rows>, false, true, false);
    }
    if (e != cudaSuccess) return e;
  }
  const unsigned grid = static_cast<unsigned>(T) * num_kv;
  if (d <= 64)
    split_combine_kernel<2, Rows><<<grid, 32 * group, 0, stream>>>(
        rows, ws, out, num_kv, group, max_len, d, mode);
  else if (d <= 128)
    split_combine_kernel<4, Rows><<<grid, 32 * group, 0, stream>>>(
        rows, ws, out, num_kv, group, max_len, d, mode);
  else
    split_combine_kernel<8, Rows><<<grid, 32 * group, 0, stream>>>(
        rows, ws, out, num_kv, group, max_len, d, mode);
  return cudaGetLastError();
}

}  // namespace hccs
