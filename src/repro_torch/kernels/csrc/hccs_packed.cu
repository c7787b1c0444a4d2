// hccs_packed.cu — packed, paged, single-query HCCS attention for Hopper.
//
// Replaces the Pallas TPU kernel `hccs_packed_prefill` / `_packed_kernel`
// (src/repro/kernels/decode.py:400): every packed engine step, prefill
// chunks and decode lanes alike, runs it once per layer. Each packed token t
// runs the split-KV HCCS sweep (hccs_split.cuh) over the KV of its owning
// slot, walked through block_table[slot_ids[t]] up to the token's causal
// frontier lengths[t]; sentinel (-1) entries are skipped without a read, a
// split boundary may fall inside a pool block, and pad lanes (slot id -1)
// write zeros.
//
// What bounds it on the H100: at a decode step (width 8) the bytes of the
// slots' live K and V rows and the latency of a short chain of launches, as
// for hccs_arena.cu; at a prefill step (width 256) the QK and PV work of
// every token against its slot's keys, since the tokens of one slot each
// read that slot's K/V again (from L2). The one-block-per-(token, kv head)
// sweep it ran before walked each token's whole frontier twice in one block
// (0.68 ms at width 8, 1.66 ms at width 256). The split sweep runs
// (token, kv head, 128-key split) blocks in three launches from one host
// call (two under static_max); each thread looks its key's block-table
// entry up before any copy starts, and each warp's rows are in flight
// while the block stages the queries. Sharing a K/V tile across a slot's
// tokens is later work.
//
// Grid of passes 1-2: T * num_kv * nsplit blocks of kSplitKeys threads; of
// pass 3: T * num_kv blocks of 32 * group threads.

#include "hccs_split.cuh"

using namespace hccs;

namespace {

// Packed token t: its frontier (0 for a pad lane), and the element offset
// of its key `key` in the pools, through the block-table row of its owning
// slot (false for a key in a sentinel block, which is never read).
struct PackedRows {
  const int* block_table;
  const int* slot_ids;
  const int* lengths;
  const float* k_scales;
  const float* v_scales;
  int num_kv, nblk, block_size, d;
  __device__ __forceinline__ int frontier(int t) const {
    return slot_ids[t] < 0 ? 0 : lengths[t];
  }
  __device__ __forceinline__ bool locate(int t, int kv, int key, int64_t* base,
                                         float* kdq, float* vdq) const {
    const PagedLocator loc{
        block_table + static_cast<int64_t>(max(slot_ids[t], 0)) * nblk,
        num_kv, kv, static_cast<int64_t>(block_size) * d, k_scales, v_scales};
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
// (T, num_kv * group, d) f32; pools (N, num_kv, block_size, d) of
// `pool_type`; scales (N, num_kv) f32 (int8 pools only, else null);
// block_table (B, nblk) i32; slot_ids/lengths (T,) i32; scale (H,) f32;
// theta (H, 3) i32; workspace: ws_bytes bytes, at least
// split_workspace_bytes (decode.py workspace_bytes). qint_out, null on the
// serving path, receives the quantized logits (T, H, nblk * block_size)
// int8 of the live keys for on-card testing, and then serves as the q_int
// scratch.
int hccs_packed_prefill_launch(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scales,
                               const void* v_scales, const void* block_table,
                               const void* slot_ids, const void* lengths,
                               const void* scale, const void* theta, void* out,
                               void* qint_out, void* workspace,
                               size_t ws_bytes, int T, int num_kv, int group,
                               int block_size, int nblk, int d, int pool_type,
                               int mode, int static_max, float sm_denom,
                               void* stream) {
  if (T <= 0) return 0;
  if (!valid_geometry(group, d) || block_size <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const PackedRows rows{static_cast<const int*>(block_table),
                        static_cast<const int*>(slot_ids),
                        static_cast<const int*>(lengths),
                        static_cast<const float*>(k_scales),
                        static_cast<const float*>(v_scales),
                        num_kv, nblk, block_size, d};
#define HCCS_PACKED_CASE(PT)                                                  \
  case PT:                                                                    \
    return static_cast<int>(split_launch<PT>(                                 \
        rows, static_cast<const float*>(q), k_pool, v_pool,                   \
        static_cast<const float*>(scale), static_cast<const int*>(theta),     \
        static_cast<float*>(out), static_cast<int8_t*>(qint_out), workspace,  \
        ws_bytes, T, num_kv, group, nblk * block_size, d, mode, static_max,   \
        sm_denom, static_cast<cudaStream_t>(stream)));
  switch (pool_type) {
    HCCS_PACKED_CASE(kF32)
    HCCS_PACKED_CASE(kBF16)
    HCCS_PACKED_CASE(kF16)
    HCCS_PACKED_CASE(kI8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HCCS_PACKED_CASE
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
