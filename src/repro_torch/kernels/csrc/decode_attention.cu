// Flash-decode for Hopper: one query token per sequence attending over its
// ring KV cache, GQA, online softmax in f32.
//
// Replaces the Pallas TPU kernel flash_decode in
// src/repro/kernels/decode_attention.py, which walks the cache in blk_c
// tiles on a sequential grid axis with (m, l, acc) in VMEM scratch and takes
// the query position by scalar prefetch.
//
//   q       [B, H, hd]       f32 or bf16; head h reads kv head h / G
//   k, v    [B, C, KH, hd]   q's type, or int8 with k_scale, v_scale [B, C, KH] f32
//   kv_pos  [B, C] int32     position stored at each ring entry, -1 = empty
//   q_pos   [B] int32        each row's query position (the TPU kernel takes
//                            one scalar; the engine decodes each row at its own)
//   out     [B, H, hd]       q's type
//
// An entry is a key of row b iff 0 <= kv_pos <= q_pos (and inside the
// sliding window or the same chunk when one is set); masked scores are the
// finite -1e30, so a row with no key at all (idle decode rows, trash-page
// rows of the paged view) comes out as the mean of V over its C entries, as
// in the TPU kernel and the plain model code.
//
// What bounds it on an H100: bytes. Every K and V element is read once and
// does 2 FLOPs per query head of its group (4 with the PV product), far
// under the ~295 FLOP/byte at which the tensor cores would be the limit.
// The design: one CTA per (b, kv head) stages the G query rows of the group
// in shared memory, so each K/V element is read once for all G heads; it
// walks C in tiles of 4096 / hd keys, each tile read with 16-byte vector
// loads and widened to f32 (int8 dequantised) as it lands in shared memory,
// and keeps (m, l) per row and acc per (row, column) in f32. Ragged C is
// masked: entries past C are not keys and join no sum. No split of C across
// CTAs yet, so the main path's decode shape (B 8, KH 8) runs 64 CTAs.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/decode_attention.py).
// The entry point launches on the caller's stream and returns a CUDA error
// code (0 on success).

#include "attention.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;
using attn::kWarps;

template <int HD> struct DecodeTile {
  static constexpr int kKeys = 4096 / HD;  // keys per tile: 16 KiB of f32 per K or V tile
  static constexpr int kKStride = HD + 1;  // padded K rows: conflict-free column reads
  static size_t smem_bytes(int g) {
    return sizeof(float) * (2 * static_cast<size_t>(g) * HD + kKeys * kKStride +
                            kKeys * HD + static_cast<size_t>(g) * kKeys + 3 * g) +
           sizeof(int) * kKeys;
  }
};

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                    const TKV* __restrict__ v, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale, const int* __restrict__ kv_pos,
                    const int* __restrict__ q_pos, TQ* __restrict__ out, int c_len,
                    int kh_n, int g, float scale, int window, int chunked,
                    float softcap) {
  using Tile = DecodeTile<HD>;
  constexpr int TC = Tile::kKeys;
  constexpr int KS = Tile::kKStride;
  extern __shared__ float smem[];
  float* q_s = smem;               // [g][HD]
  float* acc_s = q_s + g * HD;     // [g][HD]
  float* k_s = acc_s + g * HD;     // [TC][KS]
  float* v_s = k_s + TC * KS;      // [TC][HD]
  float* p_s = v_s + TC * HD;      // [g][TC] scores, then probabilities
  float* m_s = p_s + g * TC;       // [g] running max
  float* l_s = m_s + g;            // [g] running sum
  float* a_s = l_s + g;            // [g] this tile's rescale factor
  int* kp_s = reinterpret_cast<int*>(a_s + g);  // [TC]

  const int b = blockIdx.x / kh_n;
  const int kh = blockIdx.x % kh_n;
  const int h = kh_n * g;
  const int qp = q_pos[b];
  const int64_t head0 = static_cast<int64_t>(b) * h + static_cast<int64_t>(kh) * g;
  const TQ* qb = q + head0 * HD;   // the group's g rows are contiguous
  for (int i = threadIdx.x; i < g * HD; i += kThreads) {
    q_s[i] = attn::to_f(qb[i]);
    acc_s[i] = 0.0f;
  }
  for (int r = threadIdx.x; r < g; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.0f;
  }
  const int64_t row_stride = static_cast<int64_t>(kh_n) * HD;  // entry c -> c + 1
  const int64_t kv0 = static_cast<int64_t>(b) * c_len * kh_n + kh;  // (b, 0, kh)
  const int* pos_b = kv_pos + static_cast<int64_t>(b) * c_len;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (int c0 = 0; c0 < c_len; c0 += TC) {
    const int nc = min(TC, c_len - c0);
    const int64_t e0 = kv0 + static_cast<int64_t>(c0) * kh_n;  // entry (b, c0, kh)
    attn::load_tile<TKV, HD>(k + e0 * HD, row_stride, nc, k_s, KS,
                             k_scale != nullptr ? k_scale + e0 : nullptr, kh_n);
    attn::load_tile<TKV, HD>(v + e0 * HD, row_stride, nc, v_s, HD,
                             v_scale != nullptr ? v_scale + e0 : nullptr, kh_n);
    for (int c = threadIdx.x; c < nc; c += kThreads) kp_s[c] = pos_b[c0 + c];
    __syncthreads();

    // scores of the tile's real entries, masked to the finite sentinel
    for (int i = threadIdx.x; i < g * TC; i += kThreads) {
      const int r = i / TC;
      const int c = i % TC;
      if (c >= nc) continue;
      const float* qr = q_s + r * HD;
      const float* kr = k_s + c * KS;
      float s = 0.0f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) s = fmaf(qr[d], kr[d], s);
      s *= scale;
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      p_s[i] = attn::key_valid(qp, kp_s[c], true, window, chunked != 0) ? s : kNegInf;
    }
    __syncthreads();

    // online softmax, one warp per query row
    for (int r = warp; r < g; r += kWarps) {
      float* pr = p_s + r * TC;
      float mx = kNegInf;
      for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, pr[c]);
      mx = attn::warp_max(mx);
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.0f;
      for (int c = lane; c < nc; c += 32) {
        const float p = expf(pr[c] - m_new);
        pr[c] = p;
        sum += p;
      }
      sum = attn::warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + p . V over the tile's real entries
    for (int i = threadIdx.x; i < g * HD; i += kThreads) {
      const int r = i / HD;
      const int d = i % HD;
      const float* pr = p_s + r * TC;
      float a = acc_s[i] * a_s[r];
      for (int c = 0; c < nc; ++c) a = fmaf(pr[c], v_s[c * HD + d], a);
      acc_s[i] = a;
    }
    __syncthreads();
  }

  TQ* ob = out + head0 * HD;
  for (int i = threadIdx.x; i < g * HD; i += kThreads)
    ob[i] = attn::from_f<TQ>(acc_s[i] / fmaxf(l_s[i / HD], 1e-30f));
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* kv_pos, const int* q_pos, void* out,
                   int b, int c, int kh, int g, float scale, int window, int chunked,
                   float softcap, cudaStream_t stream) {
  auto kernel = flash_decode_kernel<TQ, TKV, HD>;
  const size_t smem = DecodeTile<HD>::smem_bytes(g);
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<static_cast<unsigned>(b) * kh, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v),
      ks, vs, kv_pos, q_pos, static_cast<TQ*>(out), c, kh, g, scale, window, chunked,
      softcap);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* kv_pos,
                        const int* q_pos, void* out, int b, int c, int kh, int g,
                        float scale, int window, int chunked, float softcap,
                        cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, ks, vs, kv_pos, q_pos, out, b, c, kh, g, scale,
                                 window, chunked, softcap, st);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, ks, vs, kv_pos, q_pos, out, b, c, kh, g, scale,
                                 window, chunked, softcap, st);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, ks, vs, kv_pos, q_pos, out, b, c, kh, g, scale,
                                  window, chunked, softcap, st);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, ks, vs, kv_pos, q_pos, out, b, c, kh, g, scale,
                                  window, chunked, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only, with both scales).
// window <= 0: no window; softcap <= 0: no softcap.
int flash_decode_launch(const void* q, const void* k, const void* v, const void* k_scale,
                        const void* v_scale, const void* kv_pos, const void* q_pos,
                        void* out, int b, int c, int kh, int g, int hd, int q_dtype,
                        int kv_dtype, float scale, int window, int chunked,
                        float softcap, void* stream) {
  if (b <= 0 || c <= 0 || kh <= 0 || g <= 0) return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = kv_dtype == 2;
  if (quant != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_hd<float, float>(hd, q, k, v, nullptr, nullptr, kp, qp, out, b, c,
                                     kh, g, scale, window, chunked, softcap, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, nullptr, nullptr, kp,
                                                     qp, out, b, c, kh, g, scale, window,
                                                     chunked, softcap, st);
  if (q_dtype == 0 && quant)
    return dispatch_hd<float, int8_t>(hd, q, k, v, ks, vs, kp, qp, out, b, c, kh, g,
                                      scale, window, chunked, softcap, st);
  if (q_dtype == 1 && quant)
    return dispatch_hd<__nv_bfloat16, int8_t>(hd, q, k, v, ks, vs, kp, qp, out, b, c, kh,
                                              g, scale, window, chunked, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
