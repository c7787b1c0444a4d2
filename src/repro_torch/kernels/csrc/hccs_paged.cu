// hccs_paged.cu — single-query HCCS decode over a paged KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel `hccs_paged_decode` / `_paged_kernel`
// (src/repro/kernels/decode.py:316): the lockstep paged engine's decode
// step (packed=False, one new token per slot) runs it once per layer. Slot
// b's query runs the split-KV HCCS sweep (hccs_split.cuh) over the pool
// blocks of its block-table row block_table[b], up to its frontier
// lengths[b]; sentinel (-1) entries are skipped without a read, a split
// boundary may fall inside a pool block, and a slot with length 0 writes
// zeros.
//
// What bounds it on the H100: the bytes of the slots' live K and V rows
// (24 MB at granite's shapes, 8 slots of frontiers up to 2048, f32: 7.2 us
// at 3.35 TB/s) and the latency of a short chain of launches, as for
// hccs_arena.cu at the same shapes. The one-block-per-(slot, kv head)
// sweep it ran before put 64 blocks on 132 SMs, each walking up to 2048
// keys twice (0.69 ms a call). The split sweep runs (slot, kv head,
// 128-key split) blocks, each thread looking its key's block-table entry up
// before any copy starts, in three launches from one host call (two under
// static_max). Its row type is a type of its own (PagedRows), so that a
// profile tells the lockstep kernels from the packed ones.
//
// Grid of passes 1-2: B * num_kv * nsplit blocks of kSplitKeys threads; of
// pass 3: B * num_kv blocks of 32 * group threads.

#include "hccs_split.cuh"

using namespace hccs;

namespace {

// Slot b: its frontier, and the element offset of its key `key` in the
// pools, through its block-table row (false for a key in a sentinel block,
// which is never read); int8 pools' dequant scales come through the
// locator.
struct PagedRows {
  const int* block_table;
  const int* lengths;
  const float* k_scales;
  const float* v_scales;
  int num_kv, nblk, block_size, d;
  __device__ __forceinline__ int frontier(int b) const { return lengths[b]; }
  __device__ __forceinline__ bool locate(int b, int kv, int key, int64_t* base,
                                         float* kdq, float* vdq) const {
    const PagedLocator loc{block_table + static_cast<int64_t>(b) * nblk,
                           num_kv, kv, static_cast<int64_t>(block_size) * d,
                           k_scales, v_scales};
    const int j = key / block_size;
    if (!loc(j, base, kdq, vdq)) return false;
    *base += static_cast<int64_t>(key - j * block_size) * d;
    return true;
  }
};

}  // namespace

extern "C" {

// Enqueue every pass on `stream`; allocates nothing. Returns the cudaError_t
// of the first failed launch (0 = success). Shapes: q/out
// (B, num_kv * group, d) f32; pools (N, num_kv, block_size, d) of
// `pool_type`; scales (N, num_kv) f32 (int8 pools only, else null);
// block_table (B, nblk) i32; lengths (B,) i32; scale (H,) f32; theta (H, 3)
// i32; workspace: ws_bytes bytes, at least split_workspace_bytes (decode.py
// workspace_bytes). qint_out, null on the serving path, receives the
// quantized logits (B, H, nblk * block_size) int8 of the live keys for
// on-card testing, and then serves as the q_int scratch.
int hccs_paged_decode_launch(const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scales,
                             const void* v_scales, const void* block_table,
                             const void* lengths, const void* scale,
                             const void* theta, void* out, void* qint_out,
                             void* workspace, size_t ws_bytes, int B,
                             int num_kv, int group, int block_size, int nblk,
                             int d, int pool_type, int mode, int static_max,
                             float sm_denom, void* stream) {
  if (B <= 0) return 0;
  if (!valid_geometry(group, d) || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows rows{static_cast<const int*>(block_table),
                       static_cast<const int*>(lengths),
                       static_cast<const float*>(k_scales),
                       static_cast<const float*>(v_scales),
                       num_kv, nblk, block_size, d};
#define HCCS_PAGED_CASE(PT)                                                   \
  case PT:                                                                    \
    return static_cast<int>(split_launch<PT>(                                 \
        rows, static_cast<const float*>(q), k_pool, v_pool,                   \
        static_cast<const float*>(scale), static_cast<const int*>(theta),     \
        static_cast<float*>(out), static_cast<int8_t*>(qint_out), workspace,  \
        ws_bytes, B, num_kv, group, nblk * block_size, d, mode, static_max,   \
        sm_denom, static_cast<cudaStream_t>(stream)));
  switch (pool_type) {
    HCCS_PAGED_CASE(kF32)
    HCCS_PAGED_CASE(kBF16)
    HCCS_PAGED_CASE(kF16)
    HCCS_PAGED_CASE(kI8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HCCS_PAGED_CASE
}

}  // extern "C"
