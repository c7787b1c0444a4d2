// softmax_bf16.cu — the exp-based row softmax, the paper's baseline, for
// Hopper.
//
// Replaces the Pallas TPU kernel `softmax_bf16` / `_softmax_kernel`
// (src/repro/kernels/softmax_bf16.py:32). Per row, in f32 whatever the
// input type (bf16 or f32):
//
//   m = max x;  e = expf(x - m);  z = sum e;  out = e / z   (true division)
//
// cast back to the input's type (bf16 rounds to nearest even). expf is the
// accurate library function, not __expf, and the build uses no fast math,
// so each e is what torch's CUDA exp gives; only the order of the sum
// differs from torch.softmax and from the plain version.
//
// Grid: one warp per row, kWarps rows per block; each lane walks columns
// lane, lane + 32, ... of any width C. The row is read three times (max,
// sum, output), the second and third from L1/L2, and expf is evaluated
// twice per element rather than keeping e.
//
// What bounds it on the H100: memory (bf16: 2C bytes in, 2C out per row,
// about 20 operations per element). Making it faster (vector loads, the
// row kept in registers) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(32 * kWarps)
softmax_rows_kernel(const T* __restrict__ x, T* __restrict__ out, int n_rows,
                    int cols) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;                       // uniform per warp
  const T* xr = x + static_cast<int64_t>(row) * cols;
  T* orow = out + static_cast<int64_t>(row) * cols;

  float m = -INFINITY;
  for (int c = lane; c < cols; c += 32) m = fmaxf(m, to_f32(xr[c]));
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));

  float z = 0.0f;
  for (int c = lane; c < cols; c += 32) z += expf(to_f32(xr[c]) - m);
  for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);

  for (int c = lane; c < cols; c += 32)
    orow[c] = from_f32<T>(__fdiv_rn(expf(to_f32(xr[c]) - m), z));
}

template <typename T>
cudaError_t launch(const void* x, void* out, int n_rows, int cols,
                   cudaStream_t stream) {
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  softmax_rows_kernel<T><<<blocks, 32 * kWarps, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), n_rows, cols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; allocates nothing. Returns the cudaError_t of the
// launch (0 = success). x and out (n_rows, cols), contiguous, of `dtype`
// (0 = f32, 1 = bf16).
int softmax_bf16_launch(const void* x, void* out, int n_rows, int cols,
                        int dtype, void* stream) {
  if (n_rows <= 0) return 0;
  if (cols < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return static_cast<int>(launch<float>(x, out, n_rows, cols, s));
    case kBF16:
      return static_cast<int>(launch<__nv_bfloat16>(x, out, n_rows, cols, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
