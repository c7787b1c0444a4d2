// hccs_arena.cu — single-query HCCS decode over a contiguous slot arena, for
// Hopper.
//
// Replaces the Pallas TPU kernel `hccs_decode` / `_decode_kernel`
// (src/repro/kernels/decode.py:254): the slot-arena engines' decode step
// (the wave ServeEngine and the ContinuousEngine, one new token per slot)
// runs it once per layer. Slot b's query runs the split-KV HCCS sweep
// (hccs_split.cuh) over rows [0, lengths[b]) of its (Tmax, d) slab of the
// (B, Hkv, Tmax, d) K/V arena; rows past the frontier are never read (the
// TPU kernel's dead-block skip), the last split is cut at the frontier
// whatever Tmax is, and a slot with length 0 writes zeros.
//
// What bounds it on the H100: the bytes of the live K and V rows (24 MB at
// granite's shapes, 8 slots of frontiers up to 2048, f32: 7.2 us at
// 3.35 TB/s) and the latency of a short chain of launches. The one-block-
// per-(slot, kv head) sweep it ran before put 64 blocks of 4 warps on 132
// SMs, each walking up to 2048 keys twice (0.73 ms a call). The split sweep
// runs (slot, kv head, 128-key split) blocks, each with its split's rows in
// flight at once, in three launches from one host call (two under
// static_max).
//
// Grid of passes 1-2: B * num_kv * nsplit blocks of kSplitKeys threads; of
// pass 3: B * num_kv blocks of 32 * group threads.

#include "hccs_split.cuh"

using namespace hccs;

namespace {

// Slot b of the arena: its frontier, and the element offset of its key
// `key` in the (B, num_kv, tmax, d) K/V (every key before the frontier is
// live; no dequant scales).
struct ArenaRows {
  const int* lengths;
  int num_kv, tmax, d;
  __device__ __forceinline__ int frontier(int b) const { return lengths[b]; }
  __device__ __forceinline__ bool locate(int b, int kv, int key, int64_t* base,
                                         float*, float*) const {
    *base = ((static_cast<int64_t>(b) * num_kv + kv) * tmax + key) * d;
    return true;
  }
};

}  // namespace

extern "C" {

// Enqueue every pass on `stream`; allocates nothing. Returns the cudaError_t
// of the first failed launch (0 = success). Shapes: q/out
// (B, num_kv * group, d) f32; k/v (B, num_kv, tmax, d) of `pool_type` (f32,
// bf16 or f16); lengths (B,) i32; scale (H,) f32; theta (H, 3) i32;
// workspace: ws_bytes bytes, at least split_workspace_bytes (decode.py
// workspace_bytes). qint_out, null on the serving path, receives the
// quantized logits (B, H, tmax) int8 of the live keys for on-card testing,
// and then serves as the q_int scratch.
int hccs_decode_launch(const void* q, const void* k, const void* v,
                       const void* lengths, const void* scale,
                       const void* theta, void* out, void* qint_out,
                       void* workspace, size_t ws_bytes, int B, int num_kv,
                       int group, int tmax, int d, int pool_type, int mode,
                       int static_max, float sm_denom, void* stream) {
  if (B <= 0) return 0;
  if (!valid_geometry(group, d)) return static_cast<int>(cudaErrorInvalidValue);
  const ArenaRows rows{static_cast<const int*>(lengths), num_kv, tmax, d};
#define HCCS_ARENA_CASE(PT)                                                   \
  case PT:                                                                    \
    return static_cast<int>(split_launch<PT>(                                 \
        rows, static_cast<const float*>(q), k, v,                             \
        static_cast<const float*>(scale), static_cast<const int*>(theta),     \
        static_cast<float*>(out), static_cast<int8_t*>(qint_out), workspace,  \
        ws_bytes, B, num_kv, group, tmax, d, mode, static_max, sm_denom,      \
        static_cast<cudaStream_t>(stream)));
  switch (pool_type) {
    HCCS_ARENA_CASE(kF32)
    HCCS_ARENA_CASE(kBF16)
    HCCS_ARENA_CASE(kF16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef HCCS_ARENA_CASE
}

}  // extern "C"
