// Flash-attention prefill for Hopper: tiled causal / sliding-window /
// chunked-local attention with an online softmax in f32, GQA.
//
// Replaces the Pallas TPU kernel flash_prefill in
// src/repro/kernels/flash_prefill.py, which folds the GQA groups into the
// batch by repeating K and V g times, walks the KV tiles on a sequential
// grid axis with (m, l, acc) in VMEM scratch, and takes positions 0..S-1.
//
//   q        [B, Sq, H, hd]    f32 or bf16
//   k, v     [B, Skv, KH, hd]  q's type; head h reads kv head h / (H / KH)
//   qpos     [Sq] int32 or null (= 0..Sq-1)
//   kpos     [Skv] int32 or null (= 0..Skv-1)
//   out      [B, Sq, H, hd]    q's type
//
// Explicit positions let a suffix or chunked prefill attend over the cached
// prefix followed by the fresh suffix (Sq != Skv). A key is visible iff
// kpos >= 0, kpos <= qpos when causal, and it lies in the window or chunk
// when one is set. Masked scores are the finite -1e30, as in the TPU kernel.
//
// What bounds it on an H100: at the main path's prefill shapes (S <= 256,
// hd 128) bytes, just: each q, k, v and out element moves once and does
// ~S/2 multiply-adds per query head of its group. The design: one CTA per
// (q tile of 4096 / hd rows, q head, b) stages its q tile in shared memory
// as f32 and walks the KV tiles of kv head h / g (32 keys each, 16-byte
// vector loads, no K/V copies for GQA); scores, the row-wise online
// softmax (one warp lane per key) and the PV product run on CUDA cores in
// f32 with acc in registers. A KV tile in which no (query, key) pair of the
// CTA is visible is skipped, but only once every query row of the tile has
// met a visible key: from then on such a tile adds exactly nothing (p = 0),
// while a row with no visible key yet must still take the tile into its
// sentinel mean, as the TPU kernel does. Ragged Sq and Skv are masked (no
// divisibility requirement): rows past Sq are not written and entries past
// Skv are not keys.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/flash_prefill.py).
// The entry point launches on the caller's stream and returns a CUDA error
// code (0 on success).

#include "attention.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;
using attn::kWarps;

constexpr int kKeys = 32;  // keys per KV tile: one per warp lane in the softmax

template <int HD> struct PrefillTile {
  static constexpr int kRows = 4096 / HD;               // query rows per CTA
  static constexpr int kKStride = HD + 1;               // padded K rows
  static constexpr int kAcc = kRows * HD / kThreads;    // acc registers per thread
  static constexpr size_t kSmem =
      sizeof(float) * (kRows * HD + kKeys * kKStride + kKeys * HD + kRows * kKeys +
                       3 * kRows) +
      sizeof(int) * (kRows + kKeys);
};

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, T* __restrict__ out, int sq, int skv,
                     int h_n, int kh_n, float scale, int causal, int window, int chunked,
                     float softcap) {
  using Tile = PrefillTile<HD>;
  constexpr int BQ = Tile::kRows;
  constexpr int KS = Tile::kKStride;
  constexpr int NACC = Tile::kAcc;
  extern __shared__ float smem[];
  float* q_s = smem;               // [BQ][HD]
  float* k_s = q_s + BQ * HD;      // [kKeys][KS]
  float* v_s = k_s + kKeys * KS;   // [kKeys][HD]
  float* p_s = v_s + kKeys * HD;   // [BQ][kKeys]
  float* m_s = p_s + BQ * kKeys;   // [BQ]
  float* l_s = m_s + BQ;           // [BQ]
  float* a_s = l_s + BQ;           // [BQ]
  int* qp_s = reinterpret_cast<int*>(a_s + BQ);  // [BQ]
  int* kp_s = qp_s + BQ;                          // [kKeys]

  const int q0 = blockIdx.x * BQ;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = hq / (h_n / kh_n);
  const int nq = min(BQ, sq - q0);
  const bool is_causal = causal != 0;
  const bool is_chunked = chunked != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const int64_t q_row_stride = static_cast<int64_t>(h_n) * HD;
  const int64_t kv_row_stride = static_cast<int64_t>(kh_n) * HD;
  const int64_t q_off = ((static_cast<int64_t>(b) * sq + q0) * h_n + hq) * HD;
  const T* kb = k + (static_cast<int64_t>(b) * skv * kh_n + kvh) * HD;
  const T* vb = v + (static_cast<int64_t>(b) * skv * kh_n + kvh) * HD;

  attn::load_tile<T, HD>(q + q_off, q_row_stride, nq, q_s, HD);
  for (int r = threadIdx.x; r < BQ; r += kThreads) {
    qp_s[r] = r < nq ? (qpos != nullptr ? qpos[q0 + r] : q0 + r) : 0;
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  // CTA-uniform: every real query row of the tile has met a visible key
  bool all_seen = false;

  for (int c0 = 0; c0 < skv; c0 += kKeys) {
    const int nk = min(kKeys, skv - c0);
    for (int c = threadIdx.x; c < kKeys; c += kThreads)
      kp_s[c] = c < nk ? (kpos != nullptr ? kpos[c0 + c] : c0 + c) : -1;
    __syncthreads();
    // is any (query, key) pair of this tile visible?
    int mine = 0;
    for (int i = threadIdx.x; i < BQ * kKeys; i += kThreads) {
      const int r = i / kKeys;
      const int c = i % kKeys;
      if (r < nq && c < nk && attn::key_valid(qp_s[r], kp_s[c], is_causal, window, is_chunked))
        mine = 1;
    }
    if (!__syncthreads_or(mine) && all_seen) continue;

    attn::load_tile<T, HD>(kb + static_cast<int64_t>(c0) * kv_row_stride, kv_row_stride, nk,
                           k_s, KS);
    attn::load_tile<T, HD>(vb + static_cast<int64_t>(c0) * kv_row_stride, kv_row_stride, nk,
                           v_s, HD);
    __syncthreads();

    // scores: a warp takes one query row, a lane one key
    for (int i = threadIdx.x; i < BQ * kKeys; i += kThreads) {
      const int r = i / kKeys;
      const int c = i % kKeys;
      if (r >= nq || c >= nk) continue;
      const float* qr = q_s + r * HD;
      const float* kr = k_s + c * KS;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      p_s[i] = attn::key_valid(qp_s[r], kp_s[c], is_causal, window, is_chunked) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per query row, one lane per key
    for (int r = warp; r < nq; r += kWarps) {
      const bool key = lane < nk;
      const float s = key ? p_s[r * kKeys + lane] : kNegInf;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, attn::warp_max(s));
      const float p = key ? expf(s - m_new) : 0.0f;
      p_s[r * kKeys + lane] = p;
      const float sum = attn::warp_sum(p);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V; thread owns elements tid + j * kThreads
#pragma unroll
    for (int j = 0; j < NACC; ++j) {
      const int e = threadIdx.x + j * kThreads;
      const int r = e / HD;
      const int d = e % HD;
      if (r >= nq) continue;
      const float* pr = p_s + r * kKeys;
      float a = acc[j] * a_s[r];
      for (int c = 0; c < nk; ++c) a = fmaf(pr[c], v_s[c * HD + d], a);
      acc[j] = a;
    }
    if (!all_seen) {
      int seen = 1;
      for (int r = threadIdx.x; r < nq; r += kThreads) seen &= m_s[r] > kNegInf;
      all_seen = __syncthreads_and(seen) != 0;
    }
    __syncthreads();
  }

  T* ob = out + q_off;
#pragma unroll
  for (int j = 0; j < NACC; ++j) {
    const int e = threadIdx.x + j * kThreads;
    const int r = e / HD;
    const int d = e % HD;
    if (r < nq) ob[r * q_row_stride + d] = attn::from_f<T>(acc[j] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, int b, int sq, int skv, int h, int kh,
                   float scale, int causal, int window, int chunked, float softcap,
                   cudaStream_t stream) {
  auto kernel = flash_prefill_kernel<T, HD>;
  constexpr size_t smem = PrefillTile<HD>::kSmem;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + PrefillTile<HD>::kRows - 1) / PrefillTile<HD>::kRows, h, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qpos,
      kpos, static_cast<T*>(out), sq, skv, h, kh, scale, causal, window, chunked, softcap);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* qpos, const int* kpos, void* out, int b, int sq,
                        int skv, int h, int kh, float scale, int causal, int window,
                        int chunked, float softcap, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal,
                           window, chunked, softcap, st);
    case 64:
      return launch<T, 64>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal,
                           window, chunked, softcap, st);
    case 128:
      return launch<T, 128>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal,
                            window, chunked, softcap, st);
    case 256:
      return launch<T, 256>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal,
                            window, chunked, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16. qpos / kpos may be null (0..S-1).
// window <= 0: no window; softcap <= 0: no softcap.
int flash_prefill_launch(const void* q, const void* k, const void* v, const void* qpos,
                         const void* kpos, void* out, int b, int sq, int skv, int h,
                         int kh, int hd, int dtype, float scale, int causal, int window,
                         int chunked, float softcap, void* stream) {
  if (b <= 0 || sq <= 0 || skv <= 0 || kh <= 0 || h % kh != 0 || h > 65535 || b > 65535)
    return cudaErrorInvalidValue;
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_hd<float>(hd, q, k, v, qp, kp, out, b, sq, skv, h, kh, scale, causal,
                              window, chunked, softcap, st);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(hd, q, k, v, qp, kp, out, b, sq, skv, h, kh, scale,
                                      causal, window, chunked, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
