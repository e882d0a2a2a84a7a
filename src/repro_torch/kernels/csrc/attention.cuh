// Pieces shared by the two attention kernels (decode_attention.cu,
// flash_prefill.cu): element conversion, the position mask, warp
// reductions and the 16-byte tile loader.
//
// The mask and the sentinel follow the TPU kernels exactly. A masked
// score is the finite -1e30 (NEG_INF in src/repro/kernels/*.py), not -inf:
// a query row whose keys are all masked then gets p = exp(0) = 1 for every
// walked key, i.e. the uniform mean of V, where -inf would give NaN. Both
// kernels therefore start each row's running max at kNegInf and never skip
// a tile that such a row still needs.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace attn {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Floor division for b > 0 (Python's //); C's / truncates toward zero.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// Is key position kp visible from query position qp? kp < 0 marks an empty
// ring entry and is tested first, so the chunk index kp / window below only
// ever sees kp >= 0, where C's truncating / equals floor division. window <= 0
// means no window.
__device__ __forceinline__ bool key_valid(int qp, int kp, bool causal, int window,
                                          bool chunked) {
  if (kp < 0) return false;
  if (causal && kp > qp) return false;
  if (window > 0) {
    if (chunked) return floor_div(qp, window) == kp / window;
    return qp - kp < window;
  }
  return true;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Copy rows [0, n) of a [n, HD] tile into shared memory as f32, row r from
// src + r * row_stride, to dst + r * dst_stride. 16-byte vector loads,
// neighbouring threads on neighbouring addresses; each element read once.
// With scale (int8 K/V), row r is multiplied by scale[r * scale_stride] as
// it lands: the dequantised tile exists only in shared memory.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int64_t row_stride,
                                          int n, float* dst, int dst_stride,
                                          const float* __restrict__ scale = nullptr,
                                          int64_t scale_stride = 0) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  static_assert(HD % kVec == 0, "head dim must fill whole 16-byte vectors");
  for (int i = threadIdx.x; i < n * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int j = (i % kVecPerRow) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + j);
    const T* e = reinterpret_cast<const T*>(&raw);
    const float sc = scale != nullptr ? scale[r * scale_stride] : 1.0f;
    float* d = dst + r * dst_stride + j;
#pragma unroll
    for (int u = 0; u < kVec; ++u) d[u] = to_f(e[u]) * sc;
  }
}

// Opt a kernel into more than 48 KiB of dynamic shared memory when it needs
// it; refuse what one block cannot have (227 KiB on Hopper).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > 232448) return cudaErrorInvalidValue;
  if (bytes <= static_cast<size_t>(kStaticSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace attn
