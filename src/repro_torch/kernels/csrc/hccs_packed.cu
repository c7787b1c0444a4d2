// hccs_packed.cu — packed, paged, single-query HCCS attention for Hopper.
//
// Replaces the Pallas TPU kernel `hccs_packed_prefill` / `_packed_kernel`
// (src/repro/kernels/decode.py:400, body `_decode_tile`): every packed
// engine step, prefill chunks and decode lanes alike, runs it once per
// layer. Each packed token t runs one single-query HCCS sweep over the KV
// of its owning slot, walked through block_table[slot_ids[t]] up to the
// token's causal frontier lengths[t]:
//
//   l     = dot(q, k) / sqrt(d)                          true f32 division
//   q_int = clip(rint(l / scale[h]), -128, 127)          half to even
//   m     = max q_int over live keys (127 with static_max)       Stage 1
//   s     = B - S * min(m - q_int, D)   (int32; 0 on dead keys)  Stages 2-3
//   Z     = sum s,  acc = sum s * v     (f32)                    Stage 4
//   out   = acc * mode_inv(max(Z, 1))                            Stage 5
//
// What bounds it on the H100: memory. Each (token, kv-head) reads its
// slot's live K and V rows once, about 2 * d flops per element read — far
// below the ~20 flops/byte where the f32 pipes would take over — so the
// bound is the bytes of KV read (and, across the tokens of one prefill
// chunk that re-read the same slot, L2 traffic rather than HBM).
//
// What the design does about it: one thread block per (token, kv-head), one
// warp per query head of the GQA group, so every K/V tile is read from
// global memory once per group, not once per head (the TPU kernel's
// grouping). The TPU kernel sweeps K twice for the row-max variant; here the
// first sweep keeps each head's int8 q_int row in shared memory, so the
// second sweep reads V only and never recomputes a QK product — K and V are
// each read exactly once, with or without static_max. Tiles of one pool
// block (block_size rows) are staged in shared memory with a padded row
// stride so the lanes' per-key dot products do not bank-conflict. Pad lanes,
// sentinel (-1) table entries and rows past the frontier are skipped without
// a read. Making it faster (several tokens of one slot per block so a
// prefill chunk reads its KV once, async copies, tensor cores) is later work.
//
// Numerics that must match the JAX kernel bit for bit on exact inputs: both
// divisions are true IEEE divisions (__fdiv_rn; never build with fast math),
// rounding is rintf (half to even, as jnp.round), Z is a float sum of
// integers (exact below 2^24), and Stage 5 evaluates the same float formulas
// as repro/core/hccs.py hccs_mode_inv.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNegBig = -(1 << 30);
constexpr int kMaxColsPerLane = 8;  // head_dim <= 256
constexpr int kStaticMax = 127;

enum PoolType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };
enum Mode { kWide = 0, kI16Div = 1, kI16Clb = 2 };

template <int PT>
__device__ __forceinline__ float load_elem(const void* p, int64_t i);
template <>
__device__ __forceinline__ float load_elem<kF32>(const void* p, int64_t i) {
  return static_cast<const float*>(p)[i];
}
template <>
__device__ __forceinline__ float load_elem<kBF16>(const void* p, int64_t i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}
template <>
__device__ __forceinline__ float load_elem<kF16>(const void* p, int64_t i) {
  return __half2float(static_cast<const __half*>(p)[i]);
}
template <>
__device__ __forceinline__ float load_elem<kI8>(const void* p, int64_t i) {
  return static_cast<float>(static_cast<const int8_t*>(p)[i]);
}

__device__ __forceinline__ int warp_max(int v) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Stage 5 reciprocal, the float formulas of hccs_mode_inv (z >= 1)
__device__ __forceinline__ float mode_inv(float z, int mode) {
  const float t = 32767.0f;
  if (mode == kI16Div) return __fdiv_rn(floorf(__fdiv_rn(t, z)), t);
  if (mode == kI16Clb)
    return __fdiv_rn(floorf(t * exp2f(-floorf(log2f(z)))), t);
  return __fdiv_rn(1.0f, z);
}

// Stage rows [0, rows) of pool block `entry`, kv head `kv`, into `tile`
// (row stride d + 1) as f32, dequantized by `dq` for int8 pools.
template <int PT>
__device__ __forceinline__ void stage_tile(float* tile, const void* pool,
                                           int64_t base, int rows, int d,
                                           float dq) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - r * d;
    float x = load_elem<PT>(pool, base + i);
    if (PT == kI8) x = x * dq;
    tile[r * (d + 1) + c] = x;
  }
}

// grid: T * num_kv blocks (token-major); block: 32 * group threads.
template <int PT>
__global__ void __launch_bounds__(1024)
hccs_packed_kernel(const float* __restrict__ q, const void* __restrict__ k_pool,
                   const void* __restrict__ v_pool,
                   const float* __restrict__ k_scales,
                   const float* __restrict__ v_scales,
                   const int* __restrict__ block_table,
                   const int* __restrict__ slot_ids,
                   const int* __restrict__ lengths,
                   const float* __restrict__ scale,
                   const int* __restrict__ theta, float* __restrict__ out,
                   int8_t* __restrict__ qint_out, int num_kv, int group,
                   int block_size, int nblk, int d, int mode, int static_max,
                   float sm_denom) {
  extern __shared__ float smem[];
  const int tok = blockIdx.x / num_kv;
  const int kv = blockIdx.x - tok * num_kv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int num_heads = num_kv * group;
  const int h = kv * group + warp;           // this warp's query head
  float* out_row = out + (static_cast<int64_t>(tok) * num_heads + h) * d;

  const int slot = slot_ids[tok];
  const int max_len = nblk * block_size;
  const int nk = min(lengths[tok], max_len);
  if (slot < 0 || nk <= 0) {                 // pad lane / empty row: zeros
    for (int c = lane; c < d; c += 32) out_row[c] = 0.0f;
    return;                                  // uniform across the block
  }

  float* qs = smem;                                   // group * d
  float* tile = qs + group * d;                       // block_size * (d + 1)
  int8_t* qi = reinterpret_cast<int8_t*>(tile + block_size * (d + 1));
  int8_t* qi_row = qi + warp * max_len;               // this head's q_int

  const float* qsrc = q + (static_cast<int64_t>(tok) * num_heads + kv * group) * d;
  for (int i = threadIdx.x; i < group * d; i += blockDim.x) qs[i] = qsrc[i];

  const float scale_h = scale[h];
  const int B = theta[3 * h], S = theta[3 * h + 1], D = theta[3 * h + 2];
  const int* row = block_table + static_cast<int64_t>(slot) * nblk;
  const int nb = (nk + block_size - 1) / block_size;
  const int64_t head_stride = static_cast<int64_t>(block_size) * d;

  // sweep 1: quantized logits of every live key, kept in shared memory;
  // running max for Stage 1
  int m_lane = kNegBig;
  const float* qh = qs + warp * d;
  for (int j = 0; j < nb; ++j) {
    const int entry = row[j];
    if (entry < 0) continue;                 // sentinel: dead, never read
    const int col0 = j * block_size;
    const int rows = min(block_size, nk - col0);
    const int64_t base = (static_cast<int64_t>(entry) * num_kv + kv) * head_stride;
    const float dq = (PT == kI8) ? k_scales[static_cast<int64_t>(entry) * num_kv + kv] : 1.0f;
    __syncthreads();                         // previous tile fully consumed
    stage_tile<PT>(tile, k_pool, base, rows, d, dq);
    __syncthreads();
    for (int r = lane; r < rows; r += 32) {
      const float* kr = tile + r * (d + 1);
      float acc = 0.0f;
      for (int c = 0; c < d; ++c) acc = fmaf(qh[c], kr[c], acc);
      const float l = __fdiv_rn(acc, sm_denom);
      float x = rintf(__fdiv_rn(l, scale_h));
      x = fminf(fmaxf(x, -128.0f), 127.0f);
      const int qv = static_cast<int>(x);
      qi_row[col0 + r] = static_cast<int8_t>(qv);
      if (qint_out != nullptr)                 // testing hook (chip_smoke.py)
        qint_out[(static_cast<int64_t>(tok) * num_heads + h) * max_len + col0 + r] =
            static_cast<int8_t>(qv);
      m_lane = max(m_lane, qv);
    }
  }
  const int m = static_max ? kStaticMax : warp_max(m_lane);

  // sweep 2: Stages 2-4 against V, each lane owning columns lane + 32u
  float acc[kMaxColsPerLane];
#pragma unroll
  for (int u = 0; u < kMaxColsPerLane; ++u) acc[u] = 0.0f;
  float z = 0.0f;
  for (int j = 0; j < nb; ++j) {
    const int entry = row[j];
    if (entry < 0) continue;
    const int col0 = j * block_size;
    const int rows = min(block_size, nk - col0);
    const int64_t base = (static_cast<int64_t>(entry) * num_kv + kv) * head_stride;
    const float dq = (PT == kI8) ? v_scales[static_cast<int64_t>(entry) * num_kv + kv] : 1.0f;
    __syncthreads();
    stage_tile<PT>(tile, v_pool, base, rows, d, dq);
    __syncthreads();
    for (int r = 0; r < rows; ++r) {
      const int qv = qi_row[col0 + r];
      const float s = static_cast<float>(B - S * min(m - qv, D));
      z += s;
      const float* vr = tile + r * (d + 1);
#pragma unroll
      for (int u = 0; u < kMaxColsPerLane; ++u) {
        const int c = lane + 32 * u;
        if (c < d) acc[u] = fmaf(s, vr[c], acc[u]);
      }
    }
  }
  const float inv = mode_inv(fmaxf(z, 1.0f), mode);
#pragma unroll
  for (int u = 0; u < kMaxColsPerLane; ++u) {
    const int c = lane + 32 * u;
    if (c < d) out_row[c] = acc[u] * inv;
  }
}

template <int PT>
cudaError_t launch(const float* q, const void* k_pool, const void* v_pool,
                   const float* k_scales, const float* v_scales,
                   const int* block_table, const int* slot_ids,
                   const int* lengths, const float* scale, const int* theta,
                   float* out, int8_t* qint_out, int T, int num_kv,
                   int group, int block_size, int nblk, int d, int mode,
                   int static_max, float sm_denom, size_t smem,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        hccs_packed_kernel<PT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  hccs_packed_kernel<PT><<<T * num_kv, 32 * group, smem, stream>>>(
      q, k_pool, v_pool, k_scales, v_scales, block_table, slot_ids, lengths,
      scale, theta, out, qint_out, num_kv, group, block_size, nblk, d, mode,
      static_max, sm_denom);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; allocates nothing. Returns the cudaError_t of the
// launch (0 = success). Shapes: q/out (T, num_kv * group, d) f32; pools
// (N, num_kv, block_size, d) of `pool_type`; scales (N, num_kv) f32 (int8
// pools only, else null); block_table (B, nblk) i32; slot_ids/lengths (T,)
// i32; scale (H,) f32; theta (H, 3) i32. qint_out, null on the serving
// path, receives the quantized logits (T, H, nblk * block_size) int8 of the
// live keys for on-card testing.
int hccs_packed_prefill_launch(const void* q, const void* k_pool,
                               const void* v_pool, const void* k_scales,
                               const void* v_scales, const void* block_table,
                               const void* slot_ids, const void* lengths,
                               const void* scale, const void* theta, void* out,
                               void* qint_out, int T, int num_kv, int group, int block_size,
                               int nblk, int d, int pool_type, int mode,
                               int static_max, float sm_denom, void* stream) {
  if (T <= 0) return 0;
  if (group < 1 || group > 32 || d < 1 || d > 32 * kMaxColsPerLane)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t floats = static_cast<size_t>(group) * d +
                        static_cast<size_t>(block_size) * (d + 1);
  const size_t qi_bytes = (static_cast<size_t>(group) * nblk * block_size + 15) / 16 * 16;
  const size_t smem = floats * 4 + qi_bytes;
  auto st = static_cast<cudaStream_t>(stream);
  auto qf = static_cast<const float*>(q);
  auto ks = static_cast<const float*>(k_scales);
  auto vs = static_cast<const float*>(v_scales);
  auto bt = static_cast<const int*>(block_table);
  auto sid = static_cast<const int*>(slot_ids);
  auto len = static_cast<const int*>(lengths);
  auto sc = static_cast<const float*>(scale);
  auto th = static_cast<const int*>(theta);
  auto o = static_cast<float*>(out);
  auto qo = static_cast<int8_t*>(qint_out);
  cudaError_t e;
  switch (pool_type) {
    case kF32:
      e = launch<kF32>(qf, k_pool, v_pool, ks, vs, bt, sid, len, sc, th, o, qo, T,
                       num_kv, group, block_size, nblk, d, mode, static_max,
                       sm_denom, smem, st);
      break;
    case kBF16:
      e = launch<kBF16>(qf, k_pool, v_pool, ks, vs, bt, sid, len, sc, th, o, qo, T,
                        num_kv, group, block_size, nblk, d, mode, static_max,
                        sm_denom, smem, st);
      break;
    case kF16:
      e = launch<kF16>(qf, k_pool, v_pool, ks, vs, bt, sid, len, sc, th, o, qo, T,
                       num_kv, group, block_size, nblk, d, mode, static_max,
                       sm_denom, smem, st);
      break;
    case kI8:
      e = launch<kI8>(qf, k_pool, v_pool, ks, vs, bt, sid, len, sc, th, o, qo, T,
                      num_kv, group, block_size, nblk, d, mode, static_max,
                      sm_denom, smem, st);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
