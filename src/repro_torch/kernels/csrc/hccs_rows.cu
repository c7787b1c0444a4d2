// hccs_rows.cu — the standalone HCCS row softmax (Algorithm 1) for Hopper.
//
// Replaces the Pallas TPU kernel `hccs_rows` / `_hccs_kernel`
// (src/repro/kernels/hccs.py:79). Rows of int8 logits x, each with its own
// theta = (B, S, D), in int32 lanes:
//
//   m = max x;  s = B - S * min(m - x, D);  Z = max(sum s, 1)    Stages 1-4
//   i16_div  p = s * (32767 / Z)                                 Stage 5
//   i16_clb  p = min(s * (32767 >> lb(Z)), 32767)
//   i8_div   p = min((s * ((255 << 15) / Z)) >> 15, 255)
//   i8_clb   p = min((s * ((255 << 15) >> lb(Z))) >> 15, 255)
//
// lb(Z) = floor(log2 Z) = 31 - __clz(Z | 1), equal to the JAX kernel's
// shift cascade for every Z >= 0 (tests/test_torch_kernels.py proves it at
// 2^k - 1, 2^k and 2^k + 1). Every product, difference and sum wraps in
// 32 bits as XLA's and torch's int32 do (done in unsigned arithmetic: signed
// overflow is undefined in C++), and >> on a negative int32 is arithmetic,
// so the kernel equals its plain version bit for bit on every input.
//
// Grid: one warp per row, kWarps rows per block; each lane walks columns
// lane, lane + 32, ... of any width C (nothing is padded, the loop bound
// masks). The row is read three times (max, sum, output); the second and
// third reads of its C bytes hit L1/L2.
//
// What bounds it on the H100: memory. A row moves C bytes in and 4C bytes
// out for about ten integer operations per element. Making it faster
// (vector loads and stores, the row kept in registers) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kT16 = 32767;
constexpr int kT8 = 255;
constexpr int kInvShift = 15;   // R of the paper's eq. (8)
constexpr int kOutShift = 0;

enum Mode { kI16Div = 0, kI16Clb = 1, kI8Div = 2, kI8Clb = 3 };

__device__ __forceinline__ int wrap_mul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}

__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}

__device__ __forceinline__ int leading_bit(int z) { return 31 - __clz(z | 1); }

__device__ __forceinline__ int score(int x, int m, int B, int S, int D) {
  return wrap_sub(B, wrap_mul(S, min(m - x, D)));
}

__global__ void __launch_bounds__(32 * kWarps)
hccs_rows_kernel(const int8_t* __restrict__ x, const int* __restrict__ theta,
                 int* __restrict__ out, int n_rows, int cols, int mode) {
  const int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;                       // uniform per warp
  const int8_t* xr = x + static_cast<int64_t>(row) * cols;
  int* orow = out + static_cast<int64_t>(row) * cols;

  int m = -128;                                    // Stage 1 (cols >= 1)
  for (int c = lane; c < cols; c += 32) m = max(m, static_cast<int>(xr[c]));
  for (int o = 16; o > 0; o >>= 1)
    m = max(m, __shfl_xor_sync(0xffffffffu, m, o));

  const int B = theta[3 * row], S = theta[3 * row + 1], D = theta[3 * row + 2];
  unsigned zsum = 0;                               // Stages 2-4
  for (int c = lane; c < cols; c += 32)
    zsum += static_cast<unsigned>(score(xr[c], m, B, S, D));
  for (int o = 16; o > 0; o >>= 1)
    zsum += __shfl_xor_sync(0xffffffffu, zsum, o);
  const int z = max(static_cast<int>(zsum), 1);

  int rho;                                         // Stage 5
  switch (mode) {
    case kI16Div: rho = kT16 / z; break;
    case kI16Clb: rho = kT16 >> leading_bit(z); break;
    case kI8Div: rho = (kT8 << kInvShift) / z; break;
    default: rho = (kT8 << kInvShift) >> leading_bit(z); break;
  }
  for (int c = lane; c < cols; c += 32) {
    const int p = wrap_mul(score(xr[c], m, B, S, D), rho);
    int o;
    switch (mode) {
      case kI16Div: o = p; break;
      case kI16Clb: o = min(p, kT16); break;
      default: o = min(p >> (kInvShift + kOutShift), kT8); break;
    }
    orow[c] = o;
  }
}

}  // namespace

extern "C" {

// Launch on `stream`; allocates nothing. Returns the cudaError_t of the
// launch (0 = success). x (n_rows, cols) int8, theta (n_rows, 3) int32,
// out (n_rows, cols) int32, all contiguous; mode 0-3 = i16_div, i16_clb,
// i8_div, i8_clb.
int hccs_rows_launch(const void* x, const void* theta, void* out, int n_rows,
                     int cols, int mode, void* stream) {
  if (n_rows <= 0) return 0;
  if (cols < 1 || mode < kI16Div || mode > kI8Clb)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (n_rows + kWarps - 1) / kWarps;
  hccs_rows_kernel<<<blocks, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int*>(theta),
      static_cast<int*>(out), n_rows, cols, mode);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
