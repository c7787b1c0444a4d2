// hccs_arena.cu — single-query HCCS decode over a contiguous slot arena, for
// Hopper.
//
// Replaces the Pallas TPU kernel `hccs_decode` / `_decode_kernel`
// (src/repro/kernels/decode.py:254): the slot-arena engines' decode step
// (the wave ServeEngine and the ContinuousEngine, one new token per slot)
// runs it once per layer. Slot b's query runs one single-query HCCS sweep
// (hccs_sweep.cuh) over rows [0, lengths[b]) of its (Tmax, d) slab of the
// (B, Hkv, Tmax, d) K/V arena, in tiles of kTile rows; tiles past the
// frontier are never read (the TPU kernel's dead-block skip), the last tile
// is cut at the frontier whatever Tmax is, and a slot with length 0 writes
// zeros.
//
// Grid: B * num_kv blocks (slot-major); block: 32 * group threads.

#include "hccs_sweep.cuh"

using namespace hccs;

namespace {

constexpr int kTile = 32;   // arena rows staged per tile

template <int PT>
__global__ void __launch_bounds__(1024)
hccs_arena_kernel(const float* __restrict__ q, const void* __restrict__ k,
                  const void* __restrict__ v, const int* __restrict__ lengths,
                  const float* __restrict__ scale,
                  const int* __restrict__ theta, float* __restrict__ out,
                  int8_t* __restrict__ qint_out, int num_kv, int group,
                  int tmax, int d, int mode, int static_max, float sm_denom) {
  const int b = blockIdx.x / num_kv;
  const int kv = blockIdx.x - b * num_kv;
  const int num_heads = num_kv * group;
  const int64_t row_off = static_cast<int64_t>(b) * num_heads;
  ArenaLocator loc{(static_cast<int64_t>(b) * num_kv + kv) * tmax * d,
                   static_cast<int64_t>(kTile) * d};
  sweep<PT>(loc, q + (row_off + kv * group) * d, k, v, scale, theta,
            out + row_off * d,
            qint_out == nullptr ? nullptr : qint_out + row_off * tmax,
            lengths[b], kTile, tmax, kv, group, d, mode, static_max,
            sm_denom);
}

template <int PT>
cudaError_t launch(const float* q, const void* k, const void* v,
                   const int* lengths, const float* scale, const int* theta,
                   float* out, int8_t* qint_out, int B, int num_kv, int group,
                   int tmax, int d, int mode, int static_max, float sm_denom,
                   cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes(group, d, kTile, tmax);
  cudaError_t e = allow_smem(hccs_arena_kernel<PT>, smem);
  if (e != cudaSuccess) return e;
  hccs_arena_kernel<PT><<<B * num_kv, 32 * group, smem, stream>>>(
      q, k, v, lengths, scale, theta, out, qint_out, num_kv, group, tmax, d,
      mode, static_max, sm_denom);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; allocates nothing. Returns the cudaError_t of the
// launch (0 = success). Shapes: q/out (B, num_kv * group, d) f32; k/v
// (B, num_kv, tmax, d) of `pool_type` (f32, bf16 or f16); lengths (B,) i32;
// scale (H,) f32; theta (H, 3) i32. qint_out, null on the serving path,
// receives the quantized logits (B, H, tmax) int8 of the live keys for
// on-card testing.
int hccs_decode_launch(const void* q, const void* k, const void* v,
                       const void* lengths, const void* scale,
                       const void* theta, void* out, void* qint_out, int B,
                       int num_kv, int group, int tmax, int d, int pool_type,
                       int mode, int static_max, float sm_denom,
                       void* stream) {
  if (B <= 0) return 0;
  if (!valid_geometry(group, d)) return static_cast<int>(cudaErrorInvalidValue);
#define HCCS_ARENA_CASE(PT)                                                   \
  case PT:                                                                    \
    return static_cast<int>(launch<PT>(                                       \
        static_cast<const float*>(q), k, v, static_cast<const int*>(lengths), \
        static_cast<const float*>(scale), static_cast<const int*>(theta),     \
        static_cast<float*>(out), static_cast<int8_t*>(qint_out), B, num_kv,  \
        group, tmax, d, mode, static_max, sm_denom,                           \
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
