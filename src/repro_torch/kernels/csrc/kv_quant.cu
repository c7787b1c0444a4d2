// kv_quant.cu — the quantizing write of an int8 paged KV pool, for Hopper.
//
// No TPU kernel is replaced: the JAX package runs this fold as XLA, a
// lax.fori_loop over the step's rows (`paged_quant_scatter`,
// src/repro/models/attention.py:178). In plain PyTorch on the card that
// loop costs about eight launches per row, per layer, for each of k and v;
// here it is one launch.
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
// with round = sign(v) * floor(|v| + 0.5) (half away from zero).
//
// The design takes the loop apart. A row's scale depends on the rows before
// it only through the running scale, a scalar; the payload element (p, c)
// is rewritten only by the LAST row r* landing at p, and after that only
// requantized at the scale's growth events k > r* (the requant of a step
// whose scale did not grow has ratio 1 and is the identity). So a block
// (one per distinct (block, kv head) of the step):
//
//   1. finds the rows landing in its block, in order (a ballot over
//      32-row groups of the step's write targets, staged in shared memory
//      beside the block's payload);
//   2. takes every such row's amax in parallel, one thread a row (16-byte
//      loads);
//   3. runs the scalar scale recurrence in one thread: the scales s_i, the
//      growth events and their ratios s_{i-1} / s_i;
//   4. finds each position's last writer (shared-memory atomicMax) and
//      stages its values;
//   5. computes every payload element independently from shared memory:
//      round(x_{r*} / s_{r*}), or the old byte where no row landed, then
//      each later event's requant in order; and stores the payload and the
//      scale once.
//
// Every step is the plain version's float operation on the same operands,
// written __fmul_rn / __fadd_rn / __fdiv_rn so nvcc neither contracts an
// FMA nor takes a reciprocal: the pool and the scales equal the plain
// version (kernels/kv_quant.py paged_quant_scatter_ref) bit for bit. Pad
// lanes, steered into the trash block 0, fold there like any other row, as
// in the JAX package.
//
// Grid: (R, num_kv) blocks of kThreads; block (j, kv) works only if row j is
// the first row of the step landing in its block, and the others return
// after one scan of the targets before j.
//
// What bounds it on the H100: the bytes (the rows read once, the step's
// distinct blocks read and written once: about 1 MB, 0.3 us at 3.35 TB/s,
// for a 256-row step at granite's shapes) are few; the time is the latency
// of the dependent steps, each a round of loads or barriers, plus the
// scalar recurrence of the block with the most rows (the trash block, which
// takes every pad lane of the step). The global loads come in three rounds
// (targets; payload, rows' amax; the last writers' values), each issued
// all at once; everything after them runs out of shared memory.

#include "hccs_common.cuh"

using namespace hccs;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;
constexpr float kEps = 1e-6f;                       // KV_QUANT_EPS
constexpr float kInvQmax = 1.0f / 127.0f;           // f32(1/127)

// sign(v) * floor(|v| + 0.5), clipped to the int8 range
__device__ __forceinline__ float round_clip(float v) {
  float r = floorf(__fadd_rn(fabsf(v), 0.5f));
  r = v < 0.0f ? -r : (v > 0.0f ? r : 0.0f);
  return fminf(fmaxf(r, -128.0f), 127.0f);
}

// amax(|x|) of one row of d values at element offset xo: 16-byte loads
// where the row is aligned to them, else one value at a time
template <int RT>
__device__ __forceinline__ float row_amax(const void* rows, int64_t xo, int d,
                                          bool vec) {
  float amax = 0.0f;
  if (vec) {
    using T = typename Elem<RT>::T;
    constexpr int kPer = 16 / sizeof(T);
    const uint4* rp = reinterpret_cast<const uint4*>(
        static_cast<const T*>(rows) + xo);
#pragma unroll 4
    for (int k = 0; k < d / kPer; ++k) {
      const uint4 w = rp[k];
      const T* v = reinterpret_cast<const T*>(&w);
#pragma unroll
      for (int u = 0; u < kPer; ++u)
        amax = fmaxf(amax, fabsf(load_elem<RT>(v, u)));
    }
  } else {
    for (int c = 0; c < d; ++c)
      amax = fmaxf(amax, fabsf(load_elem<RT>(rows, xo + c)));
  }
  return amax;
}

template <int RT>
__global__ void __launch_bounds__(kThreads)
    paged_quant_scatter_kernel(int8_t* __restrict__ pool,
                               float* __restrict__ scales,
                               const void* __restrict__ rows,
                               const int* __restrict__ write_pos,
                               const uint8_t* __restrict__ draft, int R,
                               int num_kv, int block_size, int d) {
  // shared memory (paged_quant_scatter_smem_bytes): the last writers' rows
  // (f32) and the payload, block_size * d each; the targets; per row
  // landing here its row index, candidate scale (negated for a draft row)
  // and scale; the growth events (row order, ratio); each position's last
  // writer
  extern __shared__ int4 smem_raw[];
  const int n = block_size * d;
  float* xs = reinterpret_cast<float*>(smem_raw);            // n
  int8_t* pay = reinterpret_cast<int8_t*>(xs + n);           // n
  int* spos = reinterpret_cast<int*>(pay + n);               // R
  int* ridx = spos + R;                                      // R
  float* cand = reinterpret_cast<float*>(ridx + R);          // R
  float* sc = cand + R;                                      // R
  int* ev_m = reinterpret_cast<int*>(sc + R);                // R
  float* ev_ratio = reinterpret_cast<float*>(ev_m + R);      // R
  int* last = reinterpret_cast<int*>(ev_ratio + R);          // block_size
  __shared__ int n_rows, n_ev;
  __shared__ float s_old;

  const int j = blockIdx.x;
  const int kv = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int i = tid; i <= j; i += kThreads) spos[i] = write_pos[i];
  __syncthreads();
  const int blk = spos[j] / block_size;
  int earlier = 0;
  for (int i = tid; i < j; i += kThreads)
    earlier |= spos[i] / block_size == blk;
  if (__syncthreads_or(earlier)) return;     // row j is not the first

  const int64_t e = static_cast<int64_t>(blk) * num_kv + kv;
  int8_t* gp = pool + e * n;
  // stage the payload, the rest of the targets and the scale
  if (n % 16 == 0 && (reinterpret_cast<uintptr_t>(gp) & 15) == 0) {
    for (int t = tid; t < n / 16; t += kThreads)
      reinterpret_cast<uint4*>(pay)[t] = reinterpret_cast<const uint4*>(gp)[t];
  } else {
    for (int t = tid; t < n; t += kThreads) pay[t] = gp[t];
  }
  for (int i = j + 1 + tid; i < R; i += kThreads) spos[i] = write_pos[i];
  for (int p = tid; p < block_size; p += kThreads) last[p] = -1;
  if (tid == 0) s_old = scales[e];
  __syncthreads();
  // 1. the rows landing in blk, in order
  if (tid < 32) {
    int count = 0;
    for (int base = j; base < R; base += 32) {
      const int i = base + lane;
      const bool hit = i < R && spos[i] / block_size == blk;
      const unsigned ballot = __ballot_sync(kFull, hit);
      if (hit) ridx[count + __popc(ballot & ((1u << lane) - 1u))] = i;
      count += __popc(ballot);
    }
    if (lane == 0) n_rows = count;
  }
  __syncthreads();
  const int nm = n_rows;
  // 2. each row's candidate scale; 4. each position's last writer
  const bool vec = (d * sizeof(typename Elem<RT>::T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(rows) & 15) == 0;
  for (int m = tid; m < nm; m += kThreads) {
    const int i = ridx[m];
    const float amax = row_amax<RT>(
        rows, (static_cast<int64_t>(i) * num_kv + kv) * d, d, vec);
    const float cnd = __fmul_rn(fmaxf(amax, kEps), kInvQmax);
    cand[m] = (draft != nullptr && draft[i] != 0) ? -cnd : cnd;
    atomicMax(&last[spos[i] - blk * block_size], m);
  }
  __syncthreads();
  // stage the last writers' values
  for (int t = tid; t < n; t += kThreads) {
    const int p = t / d;
    const int m = last[p];
    if (m >= 0)
      xs[t] = load_elem<RT>(
          rows, (static_cast<int64_t>(ridx[m]) * num_kv + kv) * d + t - p * d);
  }
  // 3. the scale recurrence and its growth events
  if (tid == 0) {
    float s = s_old;
    int ne = 0;
    for (int m = 0; m < nm; ++m) {
      const float c = cand[m];
      float s_new = fmaxf(s, fabsf(c));
      if (c < 0.0f && s > 0.0f) s_new = s;
      if (s_new != s) {
        ev_m[ne] = m;
        ev_ratio[ne] = __fdiv_rn(s, s_new);
        ++ne;
      }
      sc[m] = s_new;
      s = s_new;
    }
    n_ev = ne;
    scales[e] = s;
  }
  __syncthreads();
  // 5. every payload element: its last write, then the later requants
  const int ne = n_ev;
  for (int t = tid; t < n; t += kThreads) {
    const int m = last[t / d];
    float v = m >= 0 ? round_clip(__fdiv_rn(xs[t], sc[m]))
                     : static_cast<float>(pay[t]);
    for (int k = 0; k < ne; ++k)
      if (ev_m[k] > m) v = round_clip(__fmul_rn(v, ev_ratio[k]));
    gp[t] = static_cast<int8_t>(static_cast<int>(v));
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block for R rows (kv_quant.py
// fold_smem_bytes).
size_t paged_quant_scatter_smem_bytes(int R, int block_size, int d) {
  const size_t n = static_cast<size_t>(block_size) * d;
  return 5 * n + 24 * static_cast<size_t>(R) +
         4 * static_cast<size_t>(block_size);
}

// Fold R rows into the pool in place, on `stream`; allocates nothing.
// Returns the cudaError_t of the launch (0 = success). pool (N, num_kv,
// block_size, d) int8 and scales (N, num_kv) f32, updated in place; rows
// (R, num_kv, d) of `row_type` (f32, bf16 or f16: hccs_common.cuh's pool
// codes); write_pos (R,) int32 flat positions blk * block_size + p, each in
// [0, N * block_size); draft (R,) uint8 or null. block_size * d must be a
// multiple of 4 (the shared arrays after the payload stay aligned).
int paged_quant_scatter_launch(void* pool, void* scales, const void* rows,
                               const void* write_pos, const void* draft,
                               int R, int num_kv, int block_size, int d,
                               int row_type, void* stream) {
  if (R <= 0) return 0;
  if (num_kv < 1 || num_kv > 65535 || block_size < 1 || d < 1 ||
      (block_size * d) % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = paged_quant_scatter_smem_bytes(R, block_size, d);
  const dim3 grid(R, num_kv);
#define KV_QUANT_CASE(RT)                                                     \
  case RT: {                                                                  \
    const cudaError_t err =                                                   \
        allow_smem(paged_quant_scatter_kernel<RT>, smem);                     \
    if (err != cudaSuccess) return static_cast<int>(err);                     \
    paged_quant_scatter_kernel<RT><<<grid, kThreads, smem,                    \
                                     static_cast<cudaStream_t>(stream)>>>(    \
        static_cast<int8_t*>(pool), static_cast<float*>(scales), rows,        \
        static_cast<const int*>(write_pos),                                   \
        static_cast<const uint8_t*>(draft), R, num_kv, block_size, d);        \
    return static_cast<int>(cudaGetLastError());                              \
  }
  switch (row_type) {
    KV_QUANT_CASE(kF32)
    KV_QUANT_CASE(kBF16)
    KV_QUANT_CASE(kF16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef KV_QUANT_CASE
}

}  // extern "C"
