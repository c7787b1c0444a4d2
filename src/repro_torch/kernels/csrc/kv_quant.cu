// kv_quant.cu — the quantizing write of an int8 paged KV pool, for Hopper.
//
// No TPU kernel is replaced: the JAX package runs this fold as XLA, a
// lax.fori_loop over the step's rows (`paged_quant_scatter`,
// src/repro/models/attention.py:178), vmapped over the layers for the
// speculative replay (src/repro/serve/paged.py:656). In plain PyTorch on
// the card that loop costs about eight launches per row, per layer, for
// each of k and v; here one launch folds a layer's K and V, or every
// layer's K and V of a replay.
//
// The fold, per row i of the step in order, for the (block, kv head) the
// row lands in (blk = write_pos[i] / block_size, p = write_pos[i] %
// block_size):
//
//   s_i     = max(s_{i-1}, max(amax(x_i), eps) * f32(1/127))   grow-only
//   s_i     = s_{i-1}                 if draft_rows[i] and s_{i-1} > 0
//   payload = clip(round(payload * (s_{i-1} / s_i)), -128, 127)
//   payload[p] = clip(round(x_i / s_i), -128, 127)
//
// with round = sign(v) * floor(|v| + 0.5) (half away from zero). A block
// listed in `fresh` (allocated since the last step) starts from scale 0,
// and a fresh block no row lands in gets scale 0.
//
// What bounds it on the H100. The bytes are few: a 256-row bf16 step's K
// and V at granite's shapes read their rows once and each distinct
// block's payload and scale once, about 1.6 MB (0.47 us at 3.35 TB/s); a
// decode step's 8 rows about 0.54 MB. So the time is the launch floor, the
// dependent rounds of loads and barriers, the longest serial chain and the
// requant arithmetic, never the bytes. The design, against what held back
// the row-grid kernel it replaced (one CTA per (row, kv head), each scanning
// every target before its row to learn whether it leads its block, most
// returning at once; one thread walking each block's scale chain; the rows
// copied to (R, Hkv, hd); one launch per pool and layer):
//
//   1. Launches: one launch folds a layer's K and V (grid axis `pool`), or
//      all layers of a speculative replay (grid axis `layer`, one write_pos
//      for all: JAX's vmap written out). The fresh-block scale reset of
//      models/attention.py is done here too.
//   2. Copies: rows are read through their (layer, B, Hkv, t, hd) strides,
//      16-byte loads along hd where it is unit-stride and aligned; the
//      targets, the draft flags (bool or uint8) and the fresh list are
//      read as given. The wrapper makes no copy.
//   3. Grid: a cluster of `splits` CTAs per (kv head, pool, layer), with
//      splits = min(8, ceil(2 x SMs / groups)): 8 for a step's K and V, 1
//      for a 40-layer replay; a CTA reads its split and the split count
//      from its cluster rank. Every CTA of a cluster finds the step's
//      distinct blocks itself (a hash set of the targets in shared memory,
//      one pass), takes every row's candidate scale and scans every block's
//      chain (a warp a block, over the 32-row chunks between the block's
//      first and last row); each then rewrites its own slice of every
//      block's payload words, so a CTA idles only where the step's payload
//      has fewer words than it has threads. Split 0 writes the scales once
//      every split of the cluster has arrived at a cluster barrier holding
//      the old ones; the wait overlaps the scans. No block scans the
//      targets before it, and shared memory grows with the targets only
//      (44 B a row, 8 B a hash slot), not with a block's payload. A write
//      of more rows than one CTA's shared memory holds (over 3740 rows at
//      block_size 32 on the H100) is folded in consecutive slices of rows,
//      one launch each from the same call: folding rows [0, r) and then
//      [r, R) is the fold of [0, R), step for step.
//   4. Scale chain: each row is a map on the running scale, closed under
//      composition: as a pair (a, b) meaning s > 0 ? max(s, a) : b, a
//      plain row is (c, c), a draft row (0, c), no row (0, 0), and (a1, b1)
//      then (a2, b2) is (max(a1, a2), b1 > 0 ? max(b1, a2) : b2). A warp
//      scans the pairs of its block's rows (32 at a time, shuffles), so
//      the trash block's ~250 pad rows are a log-depth scan, not a serial
//      chain. Only max and selects: every association gives the same
//      floats. Each growth event's ratio s_{i-1} / s_i is one __fdiv_rn.
//   5. Rounds: two of loads. The targets with their blocks' old scales,
//      the draft flags, the fresh list and every row's candidate scale (8
//      lanes a row, coalesced) come at once; then the payload words and
//      the last writers' values. A word no row writes in a block whose
//      scale did not grow is neither read nor written.
//
// The payload element (p, c) is rewritten only by the LAST row r* landing
// at p, and after that only requantized at the block's growth events
// k > r* (a step whose scale did not grow has ratio 1, the identity), so
// every element is computed on its own: round(x_{r*} / s_{r*}), or the old
// byte where no row landed, then each later event's requant in order.
// Every step is the plain version's float operation on the same operands,
// written __fmul_rn / __fadd_rn / __fdiv_rn so nvcc neither contracts an
// FMA nor takes a reciprocal: the pools and scales equal the plain version
// (kernels/kv_quant.py paged_quant_scatter_ref) bit for bit. Pad lanes,
// steered into the trash block 0, fold there like any other row, as in the
// JAX package. The kernel allocates nothing.

#include <algorithm>

#include "hccs_common.cuh"

using namespace hccs;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 512;                       // 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRowLanes = 8;                        // lanes a row's amax
constexpr int kMaxSplits = 8;                       // a portable cluster
constexpr int kAmaxRows = 2;                        // rows a lane loads at once
constexpr float kEps = 1e-6f;                       // KV_QUANT_EPS
constexpr float kInvQmax = 1.0f / 127.0f;           // f32(1/127)

// sign(v) * floor(|v| + 0.5), clipped to the int8 range
__device__ __forceinline__ float round_clip(float v) {
  float r = floorf(__fadd_rn(fabsf(v), 0.5f));
  r = v < 0.0f ? -r : (v > 0.0f ? r : 0.0f);
  return fminf(fmaxf(r, -128.0f), 127.0f);
}

// One pool of the fold: its payload, scales and rows, the rows' strides
// in elements over (layer, B, Hkv, t, hd), and whether 16-byte loads along
// hd are aligned.
struct FoldPool {
  int8_t* pool;
  float* scales;
  const void* rows;
  int64_t s_l, s_b, s_h, s_t, s_c;
  int vec;
};

struct FoldArgs {
  FoldPool pool[2];           // K, V (one pool: pool[0] only)
  const int* write_pos;       // (B, t), row i = b * t + lane
  const uint8_t* draft;       // (B, t) or null
  const int* fresh;           // (n_fresh,) or null
  int n_fresh, t, num_blocks, num_kv, block_size, d;
  int r0, R, hash_size;       // this launch's rows: r0 .. r0 + R - 1
  int64_t pool_ls, scale_ls;  // layer strides of the pools and scales
};

int hash_size(int R) {
  int h = 32;
  while (h < 2 * R) h <<= 1;
  return h;
}

__device__ __forceinline__ unsigned hash_slot(int blk, int bits) {
  return (static_cast<unsigned>(blk) * 2654435761u) >> (32 - bits);
}

// This lane's share (every kRowLanes-th 16-byte word, or value) of
// amax(|x|) over one row of d values
template <int RT>
__device__ __forceinline__ float row_amax_part(
    const typename Elem<RT>::T* row, int d, int64_t s_c, bool vec, int g) {
  using T = typename Elem<RT>::T;
  float amax = 0.0f;
  if (vec) {
    constexpr int kPer = 16 / sizeof(T);
    const uint4* rp = reinterpret_cast<const uint4*>(row);
#pragma unroll 2
    for (int q = g; q < d / kPer; q += kRowLanes) {
      const uint4 w = rp[q];
      const T* v = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        amax = fmaxf(amax, fabsf(load_elem<RT>(v, u)));
    }
  } else {
    for (int c = g; c < d; c += kRowLanes)
      amax = fmaxf(amax, fabsf(load_elem<RT>(row, c * s_c)));
  }
  return amax;
}

// this CTA's rank in its cluster, and the cluster's CTAs
__device__ __forceinline__ int cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return static_cast<int>(r);
}
__device__ __forceinline__ int cluster_size() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return static_cast<int>(n);
}

// the cluster barrier, split in two: every split arrives once it holds its
// blocks' old scales, and waits before split 0 writes the new ones
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
    paged_quant_scatter_kv_kernel(const FoldArgs a) {
  using T = typename Elem<RT>::T;
  // shared memory (paged_quant_scatter_kv_smem_bytes): per row its target,
  // its block's dense index, candidate scale (negated for a draft row),
  // scale (first its block's old scale, then its running scale) and its
  // block's growth events through it; the growth ratios (each block a
  // segment); per dense block its id, row count (then its segment), old
  // scale, first and last row; the hash set (keys, dense indices); each
  // warp's last writer per position
  extern __shared__ int4 smem_raw[];
  const int R = a.R, H = a.hash_size, bs = a.block_size, d = a.d;
  int* tgt = reinterpret_cast<int*>(smem_raw);
  int* dense = tgt + R;
  float* cand = reinterpret_cast<float*>(dense + R);
  float* srow = cand + R;
  int* evthru = reinterpret_cast<int*>(srow + R);
  float* evratio = reinterpret_cast<float*>(evthru + R);
  int* dblk = reinterpret_cast<int*>(evratio + R);
  int* dseg = dblk + R;
  float* dsold = reinterpret_cast<float*>(dseg + R);
  int* dlo = reinterpret_cast<int*>(dsold + R);
  int* dhi = dlo + R;
  int* hkey = dhi + R;
  int* hval = hkey + H;
  int* last = hval + H;
  __shared__ int n_dense, seg_total;
  __shared__ int wblk[kWarps], wseg[kWarps], wnev[kWarps];
  __shared__ float wsnew[kWarps];

  // a group's splits are one cluster, rank = split
  const int splits = cluster_size(), split = cluster_rank();
  const int kv = blockIdx.x / splits;
  const int layer = blockIdx.z;
  const FoldPool P = blockIdx.y ? a.pool[1] : a.pool[0];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int8_t* pool = P.pool + layer * a.pool_ls;
  float* scales = P.scales + layer * a.scale_ls;
  const T* rows = static_cast<const T*>(P.rows) + layer * P.s_l +
                  kv * P.s_h;

  // 1. targets and their blocks' old scales, the fresh blocks, the hash
  // set's reset, every row's candidate scale: one round of loads
  if (tid == 0) n_dense = seg_total = 0;
  const int fresh0 = tid < a.n_fresh ? a.fresh[tid] : -1;
  for (int i = tid; i < R; i += kThreads) {
    const int p = a.write_pos[a.r0 + i];
    tgt[i] = p;
    srow[i] = scales[static_cast<int64_t>(p / bs) * a.num_kv + kv];
    dseg[i] = 0;
    dlo[i] = R;
    dhi[i] = -1;
  }
  for (int h = tid; h < H; h += kThreads) hkey[h] = -1;
  const int g = tid % kRowLanes;
  for (int base = 0; base < R * kRowLanes; base += kThreads * kAmaxRows) {
    float amax[kAmaxRows];
#pragma unroll
    for (int q = 0; q < kAmaxRows; ++q) {   // kAmaxRows rows' loads in flight
      const int i = (base + q * kThreads + tid) / kRowLanes;
      amax[q] = 0.0f;
      if (i < R) {
        const int r = a.r0 + i, b = r / a.t;
        amax[q] = row_amax_part<RT>(
            rows + b * P.s_b + (r - b * a.t) * P.s_t, d, P.s_c, P.vec, g);
      }
    }
#pragma unroll
    for (int q = 0; q < kAmaxRows; ++q) {
      const int i = (base + q * kThreads + tid) / kRowLanes;
#pragma unroll
      for (int o = 1; o < kRowLanes; o <<= 1)
        amax[q] = fmaxf(amax[q], __shfl_xor_sync(kFull, amax[q], o));
      if (i < R && g == 0) {
        const float c = __fmul_rn(fmaxf(amax[q], kEps), kInvQmax);
        cand[i] = (a.draft != nullptr && a.draft[a.r0 + i] != 0) ? -c : c;
      }
    }
  }
  __syncthreads();
  // 2. the distinct blocks: the first row to claim a block's hash slot
  // gives it a dense index and its old scale
  const int bits = __ffs(H) - 1;
  for (int i = tid; i < R; i += kThreads) {
    const int blk = tgt[i] / bs;
    unsigned h = hash_slot(blk, bits);
    for (;;) {
      const int prev = atomicCAS(&hkey[h], -1, blk);
      if (prev == -1) {
        const int di = atomicAdd(&n_dense, 1);
        dblk[di] = blk;
        dsold[di] = srow[i];
        hval[h] = di;
        break;
      }
      if (prev == blk) break;
      h = (h + 1) & (H - 1);
    }
    dense[i] = static_cast<int>(h);
  }
  __syncthreads();
  for (int i = tid; i < R; i += kThreads) {
    const int di = hval[dense[i]];
    dense[i] = di;
    atomicAdd(&dseg[di], 1);
    atomicMin(&dlo[di], i);
    atomicMax(&dhi[di], i);
  }
  // the fresh blocks: a written one starts from scale 0, the others get it
  for (int f = tid; f < a.n_fresh; f += kThreads) {
    const int blk = f == tid ? fresh0 : a.fresh[f];
    if (blk < 0 || blk >= a.num_blocks) continue;
    unsigned h = hash_slot(blk, bits);
    while (hkey[h] != -1 && hkey[h] != blk) h = (h + 1) & (H - 1);
    if (hkey[h] == blk)
      dsold[hval[h]] = 0.0f;
    else if (split == 0)
      scales[static_cast<int64_t>(blk) * a.num_kv + kv] = 0.0f;
  }
  __syncthreads();
  cluster_arrive();
  const int nd = n_dense;

  // 3. rounds of kWarps blocks: a warp a block scans its scale chain, then
  // the whole CTA rewrites this split's words of the round's payloads
  const int nw = bs * d / 4;
  const int w0 = split * nw / splits, span = (split + 1) * nw / splits - w0;
  int* wlast = last + warp * bs;
  for (int rb = 0; rb < nd; rb += kWarps) {
    const int di = rb + warp;
    if (di < nd) {
      const int blk = dblk[di];
      int seg = 0;
      if (lane == 0) seg = atomicAdd(&seg_total, dseg[di]);
      seg = __shfl_sync(kFull, seg, 0);
      for (int p = lane; p < bs; p += 32) wlast[p] = -1;
      __syncwarp();
      float s_run = dsold[di];
      int nev = 0;
      for (int base = dlo[di] & ~31; base <= dhi[di]; base += 32) {
        const int i = base + lane;
        const bool hit = i < R && dense[i] == di;
        if (__ballot_sync(kFull, hit) == 0) continue;
        float pa = 0.0f, pb = 0.0f;        // no row: the identity (0, 0)
        if (hit) {
          const float c = cand[i];
          pa = c < 0.0f ? 0.0f : c;
          pb = fabsf(c);
        }
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) { // inclusive scan of the maps
          const float qa = __shfl_up_sync(kFull, pa, o);
          const float qb = __shfl_up_sync(kFull, pb, o);
          if (lane >= o) {
            pb = qb > 0.0f ? fmaxf(qb, pa) : pb;
            pa = fmaxf(qa, pa);
          }
        }
        const float s_i = s_run > 0.0f ? fmaxf(s_run, pa) : pb;
        float s_prev = __shfl_up_sync(kFull, s_i, 1);
        if (lane == 0) s_prev = s_run;
        const bool grow = hit && s_i != s_prev;
        const unsigned ev = __ballot_sync(kFull, grow);
        if (hit) {
          const int k = nev + __popc(ev & ((1u << lane) - 1u));
          if (grow) evratio[seg + k] = __fdiv_rn(s_prev, s_i);
          evthru[i] = k + (grow ? 1 : 0);
          srow[i] = s_i;
          atomicMax(&wlast[tgt[i] - blk * bs], i);
        }
        nev += __popc(ev);
        s_run = __shfl_sync(kFull, s_i, 31);
      }
      if (lane == 0) {
        wblk[warp] = blk;
        wseg[warp] = seg;
        wnev[warp] = nev;
        wsnew[warp] = s_run;
      }
    }
    __syncthreads();
    const int nb = min(kWarps, nd - rb);
    if (rb == 0) cluster_wait();           // every split holds its old scales
    if (split == 0 && tid < nb)
      scales[static_cast<int64_t>(wblk[tid]) * a.num_kv + kv] = wsnew[tid];
    const int nwords = nb * span;
    // every payload element of this split's words: its last write, then the
    // later requants; a word no row writes in a block whose scale did not
    // grow keeps its bytes
    for (int idx = tid; idx < nwords; idx += kThreads) {
      const int wb = idx / span, w = w0 + idx - wb * span;
      const int* bl = last + wb * bs;
      const int nev = wnev[wb], seg = wseg[wb];
      int m[4];
      bool written = false;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        m[u] = bl[(4 * w + u) / d];
        written |= m[u] >= 0;
      }
      if (!written && nev == 0) continue;
      uint32_t* gp = reinterpret_cast<uint32_t*>(
          pool + (static_cast<int64_t>(wblk[wb]) * a.num_kv + kv) * bs * d);
      const uint32_t old = gp[w];
      uint32_t out = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float v;
        int k = 0;
        if (m[u] >= 0) {
          const int el = 4 * w + u, c = el - el / d * d, r = a.r0 + m[u],
                    b = r / a.t;
          const float x = load_elem<RT>(
              rows, b * P.s_b + (r - b * a.t) * P.s_t + c * P.s_c);
          v = round_clip(__fdiv_rn(x, srow[m[u]]));
          k = evthru[m[u]];
        } else {
          v = static_cast<float>(static_cast<int8_t>(old >> (8 * u)));
        }
        for (; k < nev; ++k) v = round_clip(__fmul_rn(v, evratio[seg + k]));
        out |= static_cast<uint32_t>(static_cast<uint8_t>(
                   static_cast<int8_t>(static_cast<int>(v))))
               << (8 * u);
      }
      gp[w] = out;
    }
    __syncthreads();
  }
  if (nd == 0) cluster_wait();
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA for R rows (kv_quant.py
// fold_smem_bytes).
size_t paged_quant_scatter_kv_smem_bytes(int R, int block_size) {
  return 44 * static_cast<size_t>(R) + 8 * static_cast<size_t>(hash_size(R)) +
         4 * static_cast<size_t>(kWarps) * block_size;
}

// Fold a step's rows into one or two int8 pools (K, V) of one or `layers`
// layers, in place, on `stream`: one launch, or one for each slice of rows
// where one CTA's shared memory cannot hold them all; allocates nothing.
// Returns the cudaError_t of the launches (0 = success).
//   k_pool / v_pool: (layers, num_blocks, num_kv, block_size, d) int8,
//     contiguous, 4-byte aligned; k_scales / v_scales (layers, num_blocks,
//     num_kv) f32, contiguous; pools == 1 folds K only (v_* unused).
//   k_rows / v_rows: (layers, B, num_kv, t, d) of `row_type` (f32, bf16 or
//     f16: hccs_common.cuh's pool codes, both pools the same), at the
//     element strides strides[0..4] (K) and strides[5..9] (V).
//   write_pos: (B, t) int32 contiguous, flat positions blk * block_size + p
//     in [0, num_blocks * block_size), one list for every layer and pool;
//   draft: (B, t) uint8 (or bool) contiguous, or null;
//   fresh: (n_fresh,) int32 block ids whose scales reset to 0 before the
//     fold (ids outside [0, num_blocks) are skipped), or null.
// block_size * d must be a multiple of 4.
int paged_quant_scatter_kv_launch(
    void* k_pool, void* k_scales, const void* k_rows, void* v_pool,
    void* v_scales, const void* v_rows, const void* write_pos,
    const void* draft, const void* fresh, const long long* strides,
    int layers, int pools, int num_blocks, int num_kv, int block_size, int d,
    int B, int t, int n_fresh, int row_type, void* stream) {
  const int R = B * t;
  if (R <= 0 && (fresh == nullptr || n_fresh <= 0)) return 0;
  if (layers < 1 || layers > 65535 || pools < 1 || pools > 2 ||
      num_blocks < 1 || num_kv < 1 || block_size < 1 || d < 1 ||
      (block_size * d) % 4 != 0 || R < 0 || n_fresh < 0 ||
      (row_type != kF32 && row_type != kBF16 && row_type != kF16))
    return static_cast<int>(cudaErrorInvalidValue);
  // the rows of one launch: all R, or the most whose shared memory fits
  // beside the kernel's static shared memory (the same for every row type)
  cudaFuncAttributes fa{};
  const cudaError_t fa_err =
      cudaFuncGetAttributes(&fa, paged_quant_scatter_kv_kernel<kF32>);
  if (fa_err != cudaSuccess) return static_cast<int>(fa_err);
  const size_t max_smem =
      static_cast<size_t>(device_attr(1, 232448)) - fa.sharedSizeBytes;
  if (paged_quant_scatter_kv_smem_bytes(1, block_size) > max_smem)
    return static_cast<int>(cudaErrorInvalidValue);
  int slice = R;
  if (paged_quant_scatter_kv_smem_bytes(R, block_size) > max_smem) {
    int lo = 1, hi = R;                     // fits at lo, not at hi
    while (hi - lo > 1) {
      const int mid = lo + (hi - lo) / 2;
      if (paged_quant_scatter_kv_smem_bytes(mid, block_size) <= max_smem)
        lo = mid;
      else
        hi = mid;
    }
    slice = lo;
  }
  const int elem = row_type == kF32 ? 4 : 2;
  const int per = 16 / elem;
  FoldArgs a{};
  void* pool_ptr[2] = {k_pool, v_pool};
  void* scale_ptr[2] = {k_scales, v_scales};
  const void* row_ptr[2] = {k_rows, v_rows};
  for (int q = 0; q < pools; ++q) {
    if (reinterpret_cast<uintptr_t>(pool_ptr[q]) % 4 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    const long long* s = strides + 5 * q;
    bool vec = s[4] == 1 && d % per == 0 &&
               reinterpret_cast<uintptr_t>(row_ptr[q]) % 16 == 0;
    for (int k = 0; k < 4; ++k) vec = vec && s[k] % per == 0;
    a.pool[q] = FoldPool{static_cast<int8_t*>(pool_ptr[q]),
                         static_cast<float*>(scale_ptr[q]), row_ptr[q],
                         s[0], s[1], s[2], s[3], s[4], vec ? 1 : 0};
  }
  a.write_pos = static_cast<const int*>(write_pos);
  a.draft = static_cast<const uint8_t*>(draft);
  a.fresh = static_cast<const int*>(fresh);
  a.t = t;
  a.num_blocks = num_blocks;
  a.num_kv = num_kv;
  a.block_size = block_size;
  a.d = d;
  a.scale_ls = static_cast<int64_t>(num_blocks) * num_kv;
  a.pool_ls = a.scale_ls * block_size * d;
  // enough CTAs for two a streaming multiprocessor: each (kv head, pool,
  // layer) group splits its payload words over `splits` CTAs, one cluster
  const int groups = num_kv * pools * layers;
  const int splits = std::max(
      1, std::min({kMaxSplits, block_size * d / 4,
                   (2 * device_attr(0, 132) + groups - 1) / groups}));
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_kv * splits, pools, layers);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  // the slices in order; the fresh blocks reset in the first
  for (int r0 = 0;; r0 += slice) {
    a.r0 = r0;
    a.R = std::min(slice, R - r0);
    a.n_fresh = r0 > 0 || fresh == nullptr ? 0 : n_fresh;
    a.hash_size = hash_size(a.R);
    const size_t smem = paged_quant_scatter_kv_smem_bytes(a.R, block_size);
    cfg.dynamicSmemBytes = smem;
    cudaError_t err = cudaSuccess;
    switch (row_type) {
#define KV_FOLD_CASE(RT)                                                      \
  case RT:                                                                    \
    err = allow_smem(paged_quant_scatter_kv_kernel<RT>, smem);                \
    if (err == cudaSuccess)                                                   \
      err = cudaLaunchKernelEx(&cfg, paged_quant_scatter_kv_kernel<RT>, a);   \
    break;
      KV_FOLD_CASE(kF32)
      KV_FOLD_CASE(kBF16)
      KV_FOLD_CASE(kF16)
#undef KV_FOLD_CASE
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (r0 + slice >= R) return 0;
  }
}

}  // extern "C"
