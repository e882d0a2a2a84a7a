// SGMV (segmented gather matrix-vector) kernels for Hopper: the paper's
// Batch LoRA Inference hot loop, as hand-written CUDA.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/sgmv.py:
//   sgmv_shrink (_shrink_kernel):  s[T, r]     = x[T, d_in] · A[slot]ᵀ  (f32 out)
//   sgmv_expand (_expand_kernel):  y[T, d_out] = s[T, r]    · B[slot]ᵀ  (f32 out)
// Tokens arrive pre-sorted into adapter-homogeneous blocks of blk_t rows
// (repro_torch/kernels/ops.py plan_grouping); block_slots[i] names the pool
// slot that owns block i. On the TPU a scalar-prefetched block_slots steered
// the weight DMA; here each CTA reads its own block_slots entry.
//
// What bounds them on an H100: bytes. The LoRA rank r (4..64) makes both
// products thin -- shrink does 2·r FLOPs per x element it reads and one
// row-block of A per token block, expand 2·r FLOPs per output element --
// far below the ~295 FLOP/byte the tensor cores need. The design therefore
// spends no effort on tensor cores: plain FMA on CUDA cores from shared
// memory, with coalesced loads along the contiguous axis (d_in for x and A,
// the flattened [d_out, r] rows for B). At decode (T = a few slots) there are
// only ~R token blocks, so shrink splits d_in across CTAs to fill the card
// and a second, fixed-order pass sums the partial products (deterministic,
// no atomics). Ragged d_in / d_out edges are masked, not padded.
//
// The adapter pool is f32 (the serving pool's dtype) whatever the type of x:
// each weight element is rounded to the activation type on load -- the same
// numbers the reference gets by casting the whole pool to x.dtype first,
// without re-materialising the pool on every call.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/sgmv.py). Each entry
// point launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kShrinkKT = 32;       // d_in tile staged through shared memory
constexpr int kShrinkMaxOut = 32;   // accumulators per thread: blk_t·r <= 8192
constexpr int kExpandDT = 128;      // d_out columns per CTA

enum DType { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Round a weight to the activation type T (identity for f32).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// grid (n_blocks, splits). CTA (i, j) computes the partial product of token
// block i over d_in range [j·chunk, min((j+1)·chunk, d_in)) and writes it to
// out + j·T_pad·r (splits > 1: a partial buffer; splits == 1: the result).
// Each thread owns up to OUT of the block's blk_t·r outputs; OUT is the
// smallest power of two that covers them, so no thread issues work for
// accumulators it does not own.
template <typename T, int OUT>
__global__ void __launch_bounds__(kThreads)
sgmv_shrink_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const int* __restrict__ block_slots, float* __restrict__ out,
                   int d_in, int r, int n_slots, int blk_t, int chunk) {
  extern __shared__ float smem[];
  constexpr int ld = kShrinkKT + 1;  // padded rows: conflict-free column reads
  float* xs = smem;                  // [blk_t][ld]
  float* as = smem + blk_t * ld;     // [r][ld]

  const int blk = blockIdx.x;
  const int slot = block_slots[blk];
  if (slot < 0 || slot >= n_slots) __trap();
  const int d0 = blockIdx.y * chunk;
  const int d1 = min(d_in, d0 + chunk);
  const T* xb = x + static_cast<size_t>(blk) * blk_t * d_in;
  const float* ab = a + static_cast<size_t>(slot) * r * d_in;
  const int n_out = blk_t * r;

  float acc[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) acc[i] = 0.f;

  for (int k0 = d0; k0 < d1; k0 += kShrinkKT) {
    for (int e = threadIdx.x; e < blk_t * kShrinkKT; e += kThreads) {
      const int t = e / kShrinkKT, k = e % kShrinkKT, kk = k0 + k;
      xs[t * ld + k] = kk < d1 ? to_f(xb[static_cast<size_t>(t) * d_in + kk]) : 0.f;
    }
    for (int e = threadIdx.x; e < r * kShrinkKT; e += kThreads) {
      const int c = e / kShrinkKT, k = e % kShrinkKT, kk = k0 + k;
      as[c * ld + k] =
          kk < d1 ? round_to<T>(ab[static_cast<size_t>(c) * d_in + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      const int o = threadIdx.x + i * kThreads;
      if (o < n_out) {
        const float* xr = xs + (o / r) * ld;
        const float* ar = as + (o % r) * ld;
        float s = acc[i];
#pragma unroll
        for (int k = 0; k < kShrinkKT; ++k) s = fmaf(xr[k], ar[k], s);
        acc[i] = s;
      }
    }
    __syncthreads();
  }

  float* ob = out + (static_cast<size_t>(blockIdx.y) * gridDim.x + blk) * blk_t * r;
#pragma unroll
  for (int i = 0; i < OUT; ++i) {
    const int o = threadIdx.x + i * kThreads;
    if (o < n_out) ob[o] = acc[i];
  }
}

// out[i] = sum over j of partial[j][i], j in order (deterministic).
__global__ void sgmv_shrink_reduce_kernel(const float* __restrict__ partial,
                                          float* __restrict__ out, int n, int splits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int j = 0; j < splits; ++j) s += partial[static_cast<size_t>(j) * n + i];
  out[i] = s;
}

// grid (n_blocks, ceil(d_out / kExpandDT)). CTA (i, j) computes rows of
// token block i for output columns [j·kExpandDT, (j+1)·kExpandDT).
template <typename T>
__global__ void __launch_bounds__(kThreads)
sgmv_expand_kernel(const float* __restrict__ s, const float* __restrict__ b,
                   const int* __restrict__ block_slots, float* __restrict__ y,
                   int d_out, int r, int n_slots, int blk_t) {
  extern __shared__ float smem[];
  const int ldb = r + 1;
  float* ss = smem;               // [blk_t][r]   (row reads are broadcasts)
  float* bs = smem + blk_t * r;   // [kExpandDT][r + 1]

  const int blk = blockIdx.x;
  const int slot = block_slots[blk];
  if (slot < 0 || slot >= n_slots) __trap();
  const int c0 = blockIdx.y * kExpandDT;
  const int ncols = min(kExpandDT, d_out - c0);
  const float* sb = s + static_cast<size_t>(blk) * blk_t * r;
  const float* bb = b + (static_cast<size_t>(slot) * d_out + c0) * r;

  for (int e = threadIdx.x; e < blk_t * r; e += kThreads) ss[e] = sb[e];
  for (int e = threadIdx.x; e < kExpandDT * r; e += kThreads) {
    const int c = e / r, k = e % r;
    bs[c * ldb + k] = c < ncols ? round_to<T>(bb[e]) : 0.f;
  }
  __syncthreads();

  for (int o = threadIdx.x; o < blk_t * kExpandDT; o += kThreads) {
    const int t = o / kExpandDT, c = o % kExpandDT;
    if (c < ncols) {
      const float* sr = ss + t * r;
      const float* br = bs + c * ldb;
      float acc = 0.f;
      for (int k = 0; k < r; ++k) acc = fmaf(sr[k], br[k], acc);
      y[(static_cast<size_t>(blk) * blk_t + t) * d_out + c0 + c] = acc;
    }
  }
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, int OUT>
cudaError_t launch_shrink_main(const void* x, const float* a, const int* slots,
                               float* dst, int n_blocks, int blk_t, int d_in, int r,
                               int n_slots, int splits, int chunk, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(blk_t + r) * (kShrinkKT + 1) * sizeof(float);
  auto kernel = sgmv_shrink_kernel<T, OUT>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_blocks, splits), kThreads, smem, stream>>>(
      static_cast<const T*>(x), a, slots, dst, d_in, r, n_slots,
      blk_t, chunk);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_shrink(const void* x, const float* a, const int* slots, float* out,
                          float* partial, int n_blocks, int blk_t, int d_in, int r,
                          int n_slots, int splits, int chunk, cudaStream_t stream) {
  float* dst = splits > 1 ? partial : out;
  const int per = (blk_t * r + kThreads - 1) / kThreads;
  cudaError_t err;
  if (per <= 1)
    err = launch_shrink_main<T, 1>(x, a, slots, dst, n_blocks, blk_t, d_in, r, n_slots,
                                   splits, chunk, stream);
  else if (per <= 2)
    err = launch_shrink_main<T, 2>(x, a, slots, dst, n_blocks, blk_t, d_in, r, n_slots,
                                   splits, chunk, stream);
  else if (per <= 4)
    err = launch_shrink_main<T, 4>(x, a, slots, dst, n_blocks, blk_t, d_in, r, n_slots,
                                   splits, chunk, stream);
  else if (per <= 8)
    err = launch_shrink_main<T, 8>(x, a, slots, dst, n_blocks, blk_t, d_in, r, n_slots,
                                   splits, chunk, stream);
  else if (per <= 16)
    err = launch_shrink_main<T, 16>(x, a, slots, dst, n_blocks, blk_t, d_in, r, n_slots,
                                    splits, chunk, stream);
  else
    err = launch_shrink_main<T, kShrinkMaxOut>(x, a, slots, dst, n_blocks, blk_t, d_in, r,
                                               n_slots, splits, chunk, stream);
  if (err != cudaSuccess || splits == 1) return err;
  const int n = n_blocks * blk_t * r;
  sgmv_shrink_reduce_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, out, n, splits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_expand(const float* s, const float* b, const int* slots, float* y,
                          int n_blocks, int blk_t, int d_out, int r, int n_slots,
                          cudaStream_t stream) {
  const size_t smem =
      (static_cast<size_t>(blk_t) * r + static_cast<size_t>(kExpandDT) * (r + 1)) *
      sizeof(float);
  auto kernel = sgmv_expand_kernel<T>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blocks, (d_out + kExpandDT - 1) / kExpandDT);
  kernel<<<grid, kThreads, smem, stream>>>(s, b, slots, y, d_out, r, n_slots, blk_t);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Limits the Python wrapper checks before launching.
int sgmv_shrink_max_outputs() { return kThreads * kShrinkMaxOut; }
int sgmv_shrink_tile() { return kShrinkKT; }

// x: [n_blocks·blk_t, d_in] (x_dtype); a: [n_slots, r, d_in] f32;
// block_slots: [n_blocks] int32; out: [n_blocks·blk_t, r] f32;
// partial: [splits, n_blocks·blk_t, r] f32 scratch (unused when splits == 1).
// x_dtype is also the type weights are rounded to. dtype codes: 0 f32, 1 bf16.
int sgmv_shrink_launch(const void* x, const void* a, const void* block_slots, void* out,
                       void* partial, int n_blocks, int blk_t, int d_in, int r,
                       int n_slots, int splits, int chunk, int x_dtype, void* stream) {
  const float* ap = static_cast<const float*>(a);
  const int* slots = static_cast<const int*>(block_slots);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blk_t * r > kThreads * kShrinkMaxOut || chunk % kShrinkKT != 0)
    return cudaErrorInvalidValue;
  if (x_dtype == kF32)
    return launch_shrink<float>(x, ap, slots, o, p, n_blocks, blk_t, d_in, r, n_slots,
                                splits, chunk, st);
  if (x_dtype == kBF16)
    return launch_shrink<__nv_bfloat16>(x, ap, slots, o, p, n_blocks, blk_t, d_in, r,
                                        n_slots, splits, chunk, st);
  return cudaErrorInvalidValue;
}

// s: [n_blocks·blk_t, r] f32; b: [n_slots, d_out, r] f32;
// block_slots: [n_blocks] int32; y: [n_blocks·blk_t, d_out] f32.
// round_dtype: the type weights are rounded to before the f32 product.
int sgmv_expand_launch(const void* s, const void* b, const void* block_slots, void* y,
                       int n_blocks, int blk_t, int d_out, int r, int n_slots,
                       int round_dtype, void* stream) {
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  const int* slots = static_cast<const int*>(block_slots);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (round_dtype == kF32)
    return launch_expand<float>(sp, bp, slots, yp, n_blocks, blk_t, d_out, r, n_slots, st);
  if (round_dtype == kBF16)
    return launch_expand<__nv_bfloat16>(sp, bp, slots, yp, n_blocks, blk_t, d_out, r,
                                        n_slots, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
