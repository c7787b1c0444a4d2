// hccs_paged.cu — single-query HCCS decode over a paged KV pool, for Hopper.
//
// Replaces the Pallas TPU kernel `hccs_paged_decode` / `_paged_kernel`
// (src/repro/kernels/decode.py:316): the lockstep paged engine's decode
// step (packed=False, one new token per slot) runs it once per layer. Slot
// b's query runs one single-query HCCS sweep (hccs_sweep.cuh) over the pool
// blocks of its block-table row block_table[b], up to its frontier
// lengths[b]; sentinel (-1) entries are skipped without a read, and a slot
// with length 0 writes zeros.
//
// Grid: B * num_kv blocks (slot-major); block: 32 * group threads.

#include "hccs_sweep.cuh"

using namespace hccs;

namespace {

template <int PT>
__global__ void __launch_bounds__(1024)
hccs_paged_kernel(const float* __restrict__ q, const void* __restrict__ k_pool,
                  const void* __restrict__ v_pool,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ block_table,
                  const int* __restrict__ lengths,
                  const float* __restrict__ scale,
                  const int* __restrict__ theta, float* __restrict__ out,
                  int8_t* __restrict__ qint_out, int num_kv, int group,
                  int block_size, int nblk, int d, int mode, int static_max,
                  float sm_denom) {
  const int b = blockIdx.x / num_kv;
  const int kv = blockIdx.x - b * num_kv;
  const int num_heads = num_kv * group;
  const int max_len = nblk * block_size;
  const int64_t row_off = static_cast<int64_t>(b) * num_heads;
  PagedLocator loc{block_table + static_cast<int64_t>(b) * nblk, num_kv, kv,
                   static_cast<int64_t>(block_size) * d, k_scales, v_scales};
  sweep<PT>(loc, q + (row_off + kv * group) * d, k_pool, v_pool, scale, theta,
            out + row_off * d,
            qint_out == nullptr ? nullptr : qint_out + row_off * max_len,
            lengths[b], block_size, max_len, kv, group, d, mode, static_max,
            sm_denom);
}

template <int PT>
cudaError_t launch(const float* q, const void* k_pool, const void* v_pool,
                   const float* k_scales, const float* v_scales,
                   const int* block_table, const int* lengths,
                   const float* scale, const int* theta, float* out,
                   int8_t* qint_out, int B, int num_kv, int group,
                   int block_size, int nblk, int d, int mode, int static_max,
                   float sm_denom, cudaStream_t stream) {
  const size_t smem = sweep_smem_bytes(group, d, block_size, nblk * block_size);
  cudaError_t e = allow_smem(hccs_paged_kernel<PT>, smem);
  if (e != cudaSuccess) return e;
  hccs_paged_kernel<PT><<<B * num_kv, 32 * group, smem, stream>>>(
      q, k_pool, v_pool, k_scales, v_scales, block_table, lengths, scale,
      theta, out, qint_out, num_kv, group, block_size, nblk, d, mode,
      static_max, sm_denom);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; allocates nothing. Returns the cudaError_t of the
// launch (0 = success). Shapes: q/out (B, num_kv * group, d) f32; pools
// (N, num_kv, block_size, d) of `pool_type`; scales (N, num_kv) f32 (int8
// pools only, else null); block_table (B, nblk) i32; lengths (B,) i32;
// scale (H,) f32; theta (H, 3) i32. qint_out, null on the serving path,
// receives the quantized logits (B, H, nblk * block_size) int8 of the live
// keys for on-card testing.
int hccs_paged_decode_launch(const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scales,
                             const void* v_scales, const void* block_table,
                             const void* lengths, const void* scale,
                             const void* theta, void* out, void* qint_out,
                             int B, int num_kv, int group, int block_size,
                             int nblk, int d, int pool_type, int mode,
                             int static_max, float sm_denom, void* stream) {
  if (B <= 0) return 0;
  if (!valid_geometry(group, d)) return static_cast<int>(cudaErrorInvalidValue);
#define HCCS_PAGED_CASE(PT)                                                   \
  case PT:                                                                    \
    return static_cast<int>(launch<PT>(                                       \
        static_cast<const float*>(q), k_pool, v_pool,                         \
        static_cast<const float*>(k_scales),                                  \
        static_cast<const float*>(v_scales),                                  \
        static_cast<const int*>(block_table),                                 \
        static_cast<const int*>(lengths), static_cast<const float*>(scale),   \
        static_cast<const int*>(theta), static_cast<float*>(out),             \
        static_cast<int8_t*>(qint_out), B, num_kv, group, block_size, nblk,   \
        d, mode, static_max, sm_denom, static_cast<cudaStream_t>(stream)));
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
