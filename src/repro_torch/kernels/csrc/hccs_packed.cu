// hccs_packed.cu — packed, paged, single-query HCCS attention for Hopper.
//
// Replaces the Pallas TPU kernel `hccs_packed_prefill` / `_packed_kernel`
// (src/repro/kernels/decode.py:400): every packed engine step, prefill
// chunks and decode lanes alike, runs it once per layer. Each packed token t
// runs the HCCS sweep over the KV of its owning slot, walked through
// block_table[slot_ids[t]] up to the token's causal frontier lengths[t];
// sentinel (-1) entries are skipped without a read, a split boundary may
// fall inside a pool block, and pad lanes (slot id -1) write zeros.
//
// It runs the query-tiled sweep (hccs_tiled.cuh): the tokens of a slot
// segment are cut into tiles of 64 / group tokens, and a block stages a
// 128-key split of the slot's K (then V) once for the whole tile, instead
// of once per token as the split sweep (hccs_split.cuh) did. The tile list
// is built on the card from slot_ids in the same call, so the host adds no
// copy and no wait. A call of at most kSplitSweepTokens tokens (128) runs
// the split sweep itself, chosen from T: at such widths a serving step is
// one-token decode lanes, which a tile cannot share a split across, and
// the tile list and the tiled passes' launches made granite's 64-lane
// all-decode step 14% slower than the split sweep (0.2475 against 0.2168
// ms, H100).
//
// What bounds it on the H100: at a prefill step the QK and PV products on
// the f32 CUDA cores (67 TFLOP/s; the tensor cores would move q_int at
// near-ties), each slot's K/V read about once per tile; at a decode step
// (the split sweep) the bytes of the slots' live K and V rows and the
// latency of a short chain of launches. The split sweep at every width
// read a slot's K/V once per token (from L2) and ran at 2.3-2.9% of the
// benchmark's roofline at 2,048-lane prefill steps; before it, one block
// per (token, kv head) walked each token's whole frontier twice.
//
// Launches (tiled): the tile list (one block), passes 1-2 (persistent
// grids of kTileThreads-thread blocks over the (tile, split, kv head)
// items), pass 3 (T * num_kv blocks of 32 * group threads).

#include "hccs_tiled.cuh"

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
// tiled_workspace_bytes (decode.py workspace_bytes with tiles), or
// split_workspace_bytes for T <= kSplitSweepTokens. qint_out,
// null on the serving path, receives the quantized logits
// (T, H, nblk * block_size) int8 of the live keys for on-card testing, and
// then serves as the q_int scratch.
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
  const float* qf = static_cast<const float*>(q);
  const float* sc = static_cast<const float*>(scale);
  const int* th = static_cast<const int*>(theta);
  float* o = static_cast<float*>(out);
  int8_t* qo = static_cast<int8_t*>(qint_out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define HCCS_PACKED_CASE(PT)                                                  \
  case PT:                                                                    \
    return static_cast<int>(                                                  \
        T <= kSplitSweepTokens                                                \
            ? split_launch<PT>(rows, qf, k_pool, v_pool, sc, th, o, qo,       \
                               workspace, ws_bytes, T, num_kv, group,         \
                               nblk * block_size, d, mode, static_max,        \
                               sm_denom, st)                                  \
            : tiled_launch<PT>(rows, static_cast<const int*>(slot_ids), qf,   \
                               k_pool, v_pool, sc, th, o, qo, workspace,      \
                               ws_bytes, T, num_kv, group, nblk * block_size, \
                               d, mode, static_max, sm_denom, st));
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
