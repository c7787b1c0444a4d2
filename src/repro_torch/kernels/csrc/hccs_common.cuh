// hccs_common.cuh — pieces shared by the port's single-query HCCS kernels
// (the split-KV sweep hccs_split.cuh, run by hccs_arena.cu, hccs_packed.cu
// and hccs_paged.cu) and the fused kernel (hccs_fused.cu).
//
// Element types and loads of the four pool types, 16-byte cp.async, the
// warp max, the Stage 5 reciprocal (the float formulas of
// repro/core/hccs.py hccs_mode_inv), how a block of a paged pool is located
// through a block-table row, the shared memory opt-in, the device's
// attributes and a kernel's resident blocks (each read once), and the
// launch geometry check.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace hccs {

constexpr int kNegBig = -(1 << 30);
constexpr int kMaxColsPerLane = 8;  // head_dim <= 256
constexpr int kStaticMax = 127;

enum PoolType { kF32 = 0, kBF16 = 1, kF16 = 2, kI8 = 3 };
enum Mode { kWide = 0, kI16Div = 1, kI16Clb = 2 };

template <int PT> struct Elem;
template <> struct Elem<kF32> { using T = float; };
template <> struct Elem<kBF16> { using T = uint16_t; };
template <> struct Elem<kF16> { using T = uint16_t; };
template <> struct Elem<kI8> { using T = int8_t; };

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

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

// A tile of a paged pool: entry = row[j]; -1 is a sentinel (dead, unread).
struct PagedLocator {
  const int* row;          // this row's block-table row (nblk entries)
  int num_kv, kv;
  int64_t head_stride;     // block_size * d
  const float* k_scales;   // (N, num_kv), int8 pools only
  const float* v_scales;
  __device__ __forceinline__ bool operator()(int j, int64_t* base, float* kdq,
                                             float* vdq) const {
    const int entry = row[j];
    if (entry < 0) return false;
    const int64_t e = static_cast<int64_t>(entry) * num_kv + kv;
    *base = e * head_stride;
    if (k_scales != nullptr) { *kdq = k_scales[e]; *vdq = v_scales[e]; }
    return true;
  }
};

// Raise the block's dynamic shared memory cap when a launch needs more than
// the default 48 KB.
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// An attribute of the current device (slot 0: its streaming
// multiprocessors, 1: the shared memory a block can opt in to), read once a
// device; `fallback` (the H100's) where it cannot be read.
inline int device_attr(int slot, int fallback) {
  static int cached[2][64] = {};
  const cudaDeviceAttr attr[2] = {cudaDevAttrMultiProcessorCount,
                                  cudaDevAttrMaxSharedMemoryPerBlockOptin};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return fallback;
  if (cached[slot][dev] == 0 &&
      cudaDeviceGetAttribute(&cached[slot][dev], attr[slot], dev) !=
          cudaSuccess)
    return fallback;
  return cached[slot][dev];
}

// The blocks of `kernel` (`threads` a block, `smem` bytes of dynamic shared
// memory) an SM holds at once, with its shared memory cap raised (to the
// largest smem seen) and its carveout set to the most shared memory. Both
// are set, and the count read, once a (kernel, device, smem); later calls
// read the cached count and make no runtime call but cudaGetDevice.
template <class Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, size_t smem,
                                   int* per_sm) {
  struct Seen {
    const void* fn;
    int dev;
    size_t smem;
    int per_sm;
  };
  static std::mutex mu;
  static std::vector<Seen> seen;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = reinterpret_cast<const void*>(kernel);
  std::lock_guard<std::mutex> lock(mu);
  size_t cap = smem;  // never below a size an earlier launch still uses
  for (const Seen& s : seen) {
    if (s.fn != fn || s.dev != dev) continue;
    if (s.smem == smem) {
      *per_sm = s.per_sm;
      return cudaSuccess;
    }
    if (s.smem > cap) cap = s.smem;
  }
  err = allow_smem(kernel, cap);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kernel,
                                                        threads, smem);
  if (err == cudaSuccess) seen.push_back(Seen{fn, dev, smem, *per_sm});
  return err;
}

inline bool valid_geometry(int group, int d) {
  return group >= 1 && group <= 32 && d >= 1 && d <= 32 * kMaxColsPerLane;
}

}  // namespace hccs
