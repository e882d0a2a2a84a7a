// Pieces shared by the two attention kernels (decode_attention.cu,
// flash_prefill.cu): element conversion, the position mask, warp
// reductions, the f32 tile loader of the scalar prefill template, and
// inline PTX for Hopper's asynchronous copies (cp.async), shared-memory
// matrix loads (ldmatrix) and bf16 tensor-core products (mma.sync); the
// SGMV kernels (sgmv.cu) use the inline PTX too.
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
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, int64_t row_stride,
                                          int n, float* dst, int dst_stride) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kVecPerRow = HD / kVec;
  static_assert(HD % kVec == 0, "head dim must fill whole 16-byte vectors");
  for (int i = threadIdx.x; i < n * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int j = (i % kVecPerRow) * kVec;
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + j);
    const T* e = reinterpret_cast<const T*>(&raw);
    float* d = dst + r * dst_stride + j;
#pragma unroll
    for (int u = 0; u < kVec; ++u) d[u] = to_f(e[u]);
  }
}

// ---- inline PTX ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes < 16 fills the rest
// of the 16 bytes with zeros (0: a row past a ragged edge, src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte asynchronous copy (a scale of int8 K/V; strided, so not 16-byte)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are still in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l % 8 of matrix l / 8, and r[i] holds matrix i in mma fragment order
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// the same, each matrix transposed (V read as the B operand of P.V)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// c[16x8] += a[16x16] . b[16x8], bf16 in, f32 accumulate (one warp)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 rounded to bf16 and packed, lo in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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
