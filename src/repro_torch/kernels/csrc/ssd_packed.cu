// ssd_packed.cu — the Mamba-2 mixer's depthwise conv and SSD over a packed
// step's ragged slot segments, from and back to per-slot state, for Hopper.
//
// Replaces no Pallas kernel: the JAX package serves no SSM through its
// paged engine. The port's interleaved family (granite-4.0-h-micro) does,
// and each Mamba-2 layer of a packed step makes this one C call
// (kernels/ssd.py ssd_packed_scan, whose plain PyTorch version it equals up
// to the order of float32 sums). Per slot b with a segment of len tokens
// at lanes s0 .. s0 + len - 1, per head h (hp = 64 columns, n = 128 state
// rows, one group of B and C shared by every head):
//
//   xBC_t = silu(bias + sum_k w_k raw_{t-3+k})    the window before the
//                                                 segment: conv_state[b]
//   dt_t = softplus(dt_raw_t + dt_bias[h]),  da_t = exp(-exp(A_log[h]) dt_t)
//   S_t = da_t S_{t-1} + dt_t B_t x_t^T           S_{-1} = ssm_state[b, h]
//   y_t = S_t^T C_t + D[h] x_t
//
// with the stored window and state read as zeros where the segment starts
// at position 0 (seg_pos0[b] == 0). S and the last K-1 raw inputs are
// written back in place.
//
// What bounds it on the H100: memory. A scheduled slot's state is 32 KiB a
// head, 2 MiB a layer, read once and written once; 256 live slots move
// 1 GiB a layer, about 0.32 ms at 3.35 TB/s. The token-by-token recurrence
// of a prefill segment (64 FMAs a thread a token) is small beside it.
//
// Design. Grid (slots + 1, heads); block (b, h) of 256 threads scans slot
// b's segment for head h and exits at once where b has no tokens, so the
// launches of a step do not depend on how many slots are live. (A grid of
// heads by slots, every head of a slot side by side and the longest
// segments first, ran 24% slower on the benchmark cell's step.) The
// segment goes in tiles of kTile tokens. Phase A stages a tile in shared
// memory: the block loads the raw inputs of the head's 320 conv channels
// (its 64 x channels, then B and C) for the whole tile, then each thread
// runs the conv of one or two channels along the tile with the previous
// three raw inputs in registers; dt and
// da of each token come from one thread each. Phase B runs the recurrence
// from shared memory with the head's state in registers: thread (warp w,
// lane l) holds rows n = 8i + (l & 7), i < 16, of columns p = 2(4w + l/8)
// and p + 1; y's sum over n is three xor-shuffles inside each 8-lane
// group. Block (slots, h) writes y = 0 on head h's columns of the pad
// lanes. A second kernel, one block a slot, then writes each scheduled
// slot's new conv window, after the scan has read the old one (stream
// order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kN = 128;                 // state rows
constexpr int kP = 64;                  // head columns
constexpr int kRows = kN / 8;           // state rows a thread holds
constexpr int kCh = kP + 2 * kN;        // conv channels a head reads
constexpr int kTile = 32;               // tokens a tile
constexpr int kConv = 4;                // conv taps
constexpr int kWin = kConv - 1;         // raw inputs the conv keeps

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float silu(float x) {
  return x / (1.0f + expf(-x));
}

__device__ __forceinline__ float softplus(float x) {   // logaddexp(x, 0)
  return fmaxf(x, 0.0f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ zx, const T* __restrict__ conv_w,
                const T* __restrict__ conv_b, const T* __restrict__ conv_state,
                float* __restrict__ ssm_state,
                const float* __restrict__ A_log,
                const float* __restrict__ dt_bias,
                const float* __restrict__ Dp,
                const int* __restrict__ seg_start,
                const int* __restrict__ seg_len,
                const int* __restrict__ seg_pos0,
                const int* __restrict__ slot_ids, T* __restrict__ out,
                int width, int slots, int nh, int di) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int C = di + 2 * kN;                    // conv channels of a slot
  const int64_t stride = 2 * static_cast<int64_t>(di) + 2 * kN + nh;
  if (b == slots) {                             // pad lanes: y = 0
    for (int t = tid / kP; t < width; t += kThreads / kP)
      if (slot_ids[t] < 0)
        st(out + static_cast<int64_t>(t) * di + h * kP + tid % kP, 0.0f);
    return;
  }
  const int len = seg_len[b];
  if (len == 0) return;
  const int s0 = seg_start[b];
  const bool fresh = seg_pos0[b] == 0;
  __shared__ __align__(16) float act[kTile][kCh];
  __shared__ float dts[kTile], das[kTile];

  // phase A's channels: lc = tid and tid + 256 (< kCh)
  float w[2][kConv], bias[2], win[2][kWin];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int lc = tid + r * kThreads;
    const int gc = lc < kP ? h * kP + lc : di + (lc - kP);
    const bool mine = lc < kCh;
#pragma unroll
    for (int k = 0; k < kConv; ++k)             // tap k reads raw t-3+k
      w[r][k] = mine ? ld(conv_w + static_cast<int64_t>(gc) * kConv + k)
                     : 0.0f;
    bias[r] = mine ? ld(conv_b + gc) : 0.0f;
#pragma unroll
    for (int j = 0; j < kWin; ++j)              // the stored 3 inputs
      win[r][j] = (mine && !fresh)
                      ? ld(conv_state + (static_cast<int64_t>(b) * kWin +
                                         j) * C + gc)
                      : 0.0f;
  }

  // phase B's state: rows n = 8i + ng, columns p0, p0 + 1
  const int lane = tid & 31, warp = tid >> 5;
  const int ng = lane & 7;
  const int p0 = 2 * (4 * warp + (lane >> 3));
  float S[kRows][2];
  float* st_ptr = ssm_state + (static_cast<int64_t>(b) * nh + h) * kN * kP;
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (fresh) {
      S[i][0] = S[i][1] = 0.0f;
    } else {
      const float2 v = *reinterpret_cast<const float2*>(
          st_ptr + (8 * i + ng) * kP + p0);
      S[i][0] = v.x;
      S[i][1] = v.y;
    }
  }
  const float a_neg = -expf(A_log[h]);
  const float dtb = dt_bias[h], dskip = Dp[h];
  for (int t0 = 0; t0 < len; t0 += kTile) {
    const int tl = min(kTile, len - t0);
    const int64_t row0 = static_cast<int64_t>(s0 + t0) * stride;
    // phase A: the tile's raw inputs, every thread loading (token,
    // channel) pairs, independent loads; then the conv along the tile, a
    // thread a channel, the window in registers
#pragma unroll 4
    for (int e = tid; e < tl * kCh; e += kThreads) {
      const int tt = e / kCh, lc = e - tt * kCh;
      act[tt][lc] = ld(zx + row0 + tt * stride + di +
                       (lc < kP ? h * kP + lc : di + (lc - kP)));
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int lc = tid + r * kThreads;
      if (lc >= kCh) continue;
      for (int tt = 0; tt < tl; ++tt) {
        const float v = act[tt][lc];
        float acc = bias[r];
#pragma unroll
        for (int k = 0; k < kWin; ++k) acc = fmaf(w[r][k], win[r][k], acc);
        acc = fmaf(w[r][kWin], v, acc);
#pragma unroll
        for (int k = 0; k + 1 < kWin; ++k) win[r][k] = win[r][k + 1];
        win[r][kWin - 1] = v;
        act[tt][lc] = silu(acc);
      }
    }
    if (tid < tl) {
      const float dt = softplus(ld(zx + row0 + tid * stride + di + C + h) +
                                dtb);
      dts[tid] = dt;
      das[tid] = expf(a_neg * dt);
    }
    __syncthreads();
    // phase B: the recurrence, token by token
    for (int tt = 0; tt < tl; ++tt) {
      const float dt = dts[tt], da = das[tt];
      const float2 xv = *reinterpret_cast<const float2*>(&act[tt][p0]);
      const float dx0 = dt * xv.x, dx1 = dt * xv.y;
      float y0 = 0.0f, y1 = 0.0f;
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float bn = act[tt][kP + 8 * i + ng];
        const float cn = act[tt][kP + kN + 8 * i + ng];
        S[i][0] = fmaf(da, S[i][0], dx0 * bn);
        S[i][1] = fmaf(da, S[i][1], dx1 * bn);
        y0 = fmaf(cn, S[i][0], y0);
        y1 = fmaf(cn, S[i][1], y1);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        y0 += __shfl_xor_sync(0xffffffffu, y0, o);
        y1 += __shfl_xor_sync(0xffffffffu, y1, o);
      }
      if (ng == 0) {
        T* dst = out + static_cast<int64_t>(s0 + t0 + tt) * di + h * kP + p0;
        st(dst, fmaf(dskip, xv.x, y0));
        st(dst + 1, fmaf(dskip, xv.y, y1));
      }
    }
    __syncthreads();                            // act is rewritten next tile
  }
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    *reinterpret_cast<float2*>(st_ptr + (8 * i + ng) * kP + p0) =
        make_float2(S[i][0], S[i][1]);
}

// Each scheduled slot's new window: its last 3 raw inputs, from the old
// window and the segment's lanes. One block a slot; a thread reads its
// channel's old window into registers before it writes.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_window_kernel(const T* __restrict__ zx, T* __restrict__ conv_state,
                  const int* __restrict__ seg_start,
                  const int* __restrict__ seg_len,
                  const int* __restrict__ seg_pos0, int nh, int di) {
  const int b = blockIdx.x;
  const int len = seg_len[b];
  if (len == 0) return;
  const int s0 = seg_start[b];
  const bool fresh = seg_pos0[b] == 0;
  const int C = di + 2 * kN;
  const int64_t stride = 2 * static_cast<int64_t>(di) + 2 * kN + nh;
  T* win = conv_state + static_cast<int64_t>(b) * kWin * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float old[kWin], now[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j)
      old[j] = fresh ? 0.0f : ld(win + j * C + c);
#pragma unroll
    for (int j = 0; j < kWin; ++j) {
      const int e = len + j;                    // in [old | segment]
      now[j] = e < kWin ? old[e]
                        : ld(zx + static_cast<int64_t>(s0 + e - kWin) *
                                      stride + di + c);
    }
#pragma unroll
    for (int j = 0; j < kWin; ++j) st(win + j * C + c, now[j]);
  }
}

template <typename T>
int launch_all(const void* zx, const void* conv_w, const void* conv_b,
               void* conv_state, void* ssm_state, const void* A_log,
               const void* dt_bias, const void* Dp, const void* seg_start,
               const void* seg_len, const void* seg_pos0,
               const void* slot_ids, void* out, int width, int slots, int nh,
               int di, cudaStream_t stream) {
  const int* ss = static_cast<const int*>(seg_start);
  const int* sl = static_cast<const int*>(seg_len);
  const int* sp = static_cast<const int*>(seg_pos0);
  ssd_scan_kernel<T><<<dim3(slots + 1, nh), kThreads, 0, stream>>>(
      static_cast<const T*>(zx), static_cast<const T*>(conv_w),
      static_cast<const T*>(conv_b), static_cast<const T*>(conv_state),
      static_cast<float*>(ssm_state), static_cast<const float*>(A_log),
      static_cast<const float*>(dt_bias), static_cast<const float*>(Dp), ss,
      sl, sp, static_cast<const int*>(slot_ids), static_cast<T*>(out), width,
      slots, nh, di);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_window_kernel<T><<<slots, kThreads, 0, stream>>>(
      static_cast<const T*>(zx), static_cast<T*>(conv_state), ss, sl, sp, nh,
      di);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Launch on `stream`; allocates nothing. Returns the cudaError_t of the
// launches (0 = success). zxbcdt (width, 2 di + 2*128 + nh), conv_w
// (di + 256, 4), conv_b (di + 256), conv_state (slots, 3, di + 256) and
// out (width, di) of one element type (elem 0 float32, 1 bfloat16);
// ssm_state (slots, nh, 128, 64), A_log, dt_bias, D (nh) float32;
// seg_start, seg_len, seg_pos0 (slots) and slot_ids (width) int32; all
// contiguous. di = 64 nh.
int ssd_packed_launch(const void* zx, const void* conv_w, const void* conv_b,
                      void* conv_state, void* ssm_state, const void* A_log,
                      const void* dt_bias, const void* Dp,
                      const void* seg_start, const void* seg_len,
                      const void* seg_pos0, const void* slot_ids, void* out,
                      int width, int slots, int nh, int di, int elem,
                      void* stream) {
  if (width <= 0) return 0;
  if (slots < 1 || nh < 1 || di != nh * kP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem == 0)
    return launch_all<float>(zx, conv_w, conv_b, conv_state, ssm_state,
                             A_log, dt_bias, Dp, seg_start, seg_len, seg_pos0,
                             slot_ids, out, width, slots, nh, di, s);
  if (elem == 1)
    return launch_all<__nv_bfloat16>(zx, conv_w, conv_b, conv_state,
                                     ssm_state, A_log, dt_bias, Dp, seg_start,
                                     seg_len, seg_pos0, slot_ids, out, width,
                                     slots, nh, di, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
