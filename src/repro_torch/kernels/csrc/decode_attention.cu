// Flash-decode for Hopper: one query token per sequence attending over its
// ring KV cache, GQA, softmax in f32, the ring split across CTAs.
//
// Replaces the Pallas TPU kernel flash_decode in
// src/repro/kernels/decode_attention.py, which walks the cache in blk_c
// tiles on a sequential grid axis with (m, l, acc) in VMEM scratch and takes
// the query position by scalar prefetch.
//
//   q        [B, H, hd]       f32 or bf16; head h reads kv head h / G
//   k, v     [B, C, KH, hd]   q's type, or int8 with k_scale, v_scale [B, C, KH] f32
//   kv_pos   [B, C] int32     position stored at each ring entry, -1 = empty
//   q_pos    [B] int32        each row's query position (the TPU kernel takes
//                             one scalar; the engine decodes each row at its own)
//   out      [B, H, hd]       q's type
//   part_acc [B*KH, S, G, hd] f32 scratch, part_ml [B*KH, S, G, 2] f32 scratch
//   arrived  [B*KH] int32     zero before the call, zero after it (the last
//                             CTA of each (row, kv head) resets its count);
//                             the three unused, may be null, when S = 1
//
// An entry is a key of row b iff 0 <= kv_pos <= q_pos (and inside the
// sliding window or the same chunk when one is set); masked scores are the
// finite -1e30, so a row with no key at all (idle decode rows, trash-page
// rows of the paged view) comes out as the mean of V over its C entries, as
// in the TPU kernel and the plain model code.
//
// What bounds it on an H100: bytes. Every K and V element is read once and
// does 2 FLOPs per query head of its group (4 with the PV product), far
// under the ~295 FLOP/byte at which the tensor cores would be the limit; at
// the main path's shape (B 8, KH 8, C 256) the bytes take ~1.4 us, so what
// is left to beat is latency: round trips to HBM and an idle card.
//
// The design. The wrapper cuts the ring into S contiguous splits of
// keys_per_split entries (the last one ragged) so that B * KH * S fills the
// card twice over (decode_attention.split_plan; 5 splits of 52 keys, 320
// CTAs, at the main path's shape). One CTA of 256 threads per (split, row,
// kv head):
//  1. issues every K/V load of its split at once (16-byte cp.async, the
//     int8 scales 4 bytes each), K/V kept in their storage type in shared
//     memory, and reads the split's kv_pos and the group's q while they
//     are in flight: one round trip to HBM.
//  2. asks whether any entry of the split is visible to the row. A split
//     with none adds exactly nothing to the row's softmax if the row has a
//     visible key somewhere (every masked score then weighs
//     exp(-1e30 - m) = 0), but a row with no visible key at all needs every
//     entry in its sentinel mean. So an invisible split scans the rest of
//     the row's kv_pos and, if the row has a key elsewhere, skips its
//     compute and writes the empty partial (m = -1e30, l = 0). Its loads
//     were already in flight: issuing them before the positions are known
//     saves a round trip, which costs more here than the bytes.
//  3. computes the G x n scores (K widened to f32, int8 scaled, in
//     registers as it is read), the split's max m and sum l per query row,
//     and the unnormalised acc = sum_c exp(s_c - m) v_c, on CUDA cores in
//     f32: with g = 4 query rows a kv head, decode stays bytes-bound.
//  4. with S = 1 writes out = acc / l. Else it writes (m, l, acc) to
//     scratch and counts itself in arrived[row, kv head]; the CTA that
//     arrives last merges the S partials in split order, m = max m_s (from
//     -1e30), l = sum exp(m_s - m) l_s, acc = sum exp(m_s - m) acc_s, and
//     resets the counter (its L2 reads batched 8 splits at a time, merged
//     in order with a running max). No float atomics: two calls give
//     bit-equal outputs, and no second launch. A fully masked row has
//     m_s = -1e30 in every split and merges to (sum of V) / C, the mean of
//     V, exactly as one long walk.
// Entries past C are not keys and join no sum.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/decode_attention.py).
// The entry point launches on the caller's stream and returns a CUDA error
// code (0 on success).

#include "attention.cuh"

namespace {

using attn::kNegInf;

// 256 threads a CTA: a split's few dozen keys give each thread one score
// and one pair of output columns, short serial chains
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Shared memory of one split CTA, in bytes, laid out as
//   k_s [n][HD + pad] TKV | v_s [n][HD] TKV | q_s [g][HD] f32 | p_s [g][n] f32
//   | m_s, l_s [g] f32 | ks_s, vs_s [n] f32 (int8 only) | kp_s [n] int
// K rows are padded by 16 bytes so that the lanes of a warp, one key each,
// read 16-byte vectors without bank conflicts.
template <typename TKV, int HD> struct SplitSmem {
  static constexpr int kKStride = HD + 16 / static_cast<int>(sizeof(TKV));
  static constexpr bool kQuant = sizeof(TKV) == 1;
  static size_t bytes(int g, int n) {
    return sizeof(TKV) * static_cast<size_t>(n) * (kKStride + HD) +
           sizeof(float) * (static_cast<size_t>(g) * (HD + n + 2) + (kQuant ? 2 * n : 0)) +
           sizeof(int) * static_cast<size_t>(n);
  }
};

// q_row . k_row over HD: K read as 16-byte vectors in its storage type and
// widened in registers, q (f32 in shared memory) as float4
template <typename T, int HD>
__device__ __forceinline__ float dot_row(const float* qr, const T* kr) {
  constexpr int kVec = 16 / sizeof(T);
  float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // four short FMA chains, not one long one
#pragma unroll
  for (int j = 0; j < HD; j += kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(kr + j);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int u = 0; u < kVec; u += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qr + j + u);
      s.x = fmaf(qv.x, attn::to_f(e[u]), s.x);
      s.y = fmaf(qv.y, attn::to_f(e[u + 1]), s.y);
      s.z = fmaf(qv.z, attn::to_f(e[u + 2]), s.z);
      s.w = fmaf(qv.w, attn::to_f(e[u + 3]), s.w);
    }
  }
  return (s.x + s.y) + (s.z + s.w);
}

// two adjacent elements of a V row, widened
__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load_pair(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2(static_cast<float>(v.x), static_cast<float>(v.y));
}

template <typename TQ, typename TKV, int HD>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(const TQ* __restrict__ q, const TKV* __restrict__ k,
                          const TKV* __restrict__ v, const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale, const int* __restrict__ kv_pos,
                          const int* __restrict__ q_pos, TQ* __restrict__ out,
                          float* __restrict__ part_acc, float* __restrict__ part_ml,
                          int* __restrict__ arrived, int c_len, int kh_n, int g,
                          int keys_per_split, float scale, int window, int chunked,
                          float softcap) {
  using Smem = SplitSmem<TKV, HD>;
  constexpr int KS = Smem::kKStride;
  constexpr int kChunks = HD * static_cast<int>(sizeof(TKV)) / 16;  // 16-byte pieces a row
  static_assert(HD * sizeof(TKV) % 16 == 0, "head dim must fill whole 16-byte vectors");
  const int split = blockIdx.x;
  const int n_splits = gridDim.x;
  const int bk = blockIdx.y;  // b * kh_n + kh
  const int b = bk / kh_n;
  const int kh = bk % kh_n;
  const int c0 = split * keys_per_split;
  const int nc = min(keys_per_split, c_len - c0);
  const int tid = threadIdx.x;
  const bool is_chunked = chunked != 0;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  TKV* k_s = reinterpret_cast<TKV*>(smem_raw);
  TKV* v_s = k_s + static_cast<size_t>(keys_per_split) * KS;
  float* q_s = reinterpret_cast<float*>(v_s + static_cast<size_t>(keys_per_split) * HD);
  float* p_s = q_s + g * HD;
  float* m_s = p_s + g * keys_per_split;
  float* l_s = m_s + g;
  float* ks_s = l_s + g;
  float* vs_s = ks_s + (Smem::kQuant ? keys_per_split : 0);
  int* kp_s = reinterpret_cast<int*>(vs_s + (Smem::kQuant ? keys_per_split : 0));
  __shared__ int last_s;

  // 1. every K/V load of the split at once, in the storage type; the
  // positions and q load meanwhile
  const int64_t e0 = (static_cast<int64_t>(b) * c_len + c0) * kh_n + kh;  // entry (b, c0, kh)
  const int64_t row_stride = static_cast<int64_t>(kh_n) * HD;            // entry c -> c + 1
  for (int i = tid; i < nc * kChunks; i += kThreads) {
    const int c = i / kChunks;
    const int j = (i % kChunks) * (16 / static_cast<int>(sizeof(TKV)));
    const int64_t src = e0 * HD + c * row_stride + j;
    attn::cp_async16(k_s + c * KS + j, k + src);
    attn::cp_async16(v_s + c * HD + j, v + src);
  }
  if (Smem::kQuant) {
    for (int c = tid; c < nc; c += kThreads) {
      attn::cp_async4(ks_s + c, k_scale + e0 + static_cast<int64_t>(c) * kh_n);
      attn::cp_async4(vs_s + c, v_scale + e0 + static_cast<int64_t>(c) * kh_n);
    }
  }
  attn::cp_async_commit();
  const int qp = q_pos[b];
  const int* pos_b = kv_pos + static_cast<int64_t>(b) * c_len;
  int mine = 0;
  for (int c = tid; c < nc; c += kThreads) {
    const int kp = pos_b[c0 + c];
    kp_s[c] = kp;
    mine |= attn::key_valid(qp, kp, true, window, is_chunked);
  }
  const TQ* qb = q + static_cast<int64_t>(bk) * g * HD;  // the group's g rows are contiguous
  for (int i = tid; i < g * HD; i += kThreads) q_s[i] = attn::to_f(qb[i]);

  // 2. a split with no key of the row adds exactly nothing to its softmax
  // if the row has a key elsewhere; a row with none walks every entry
  bool skip = false;
  if (!__syncthreads_or(mine) && n_splits > 1) {
    int elsewhere = 0;
    for (int c = tid; c < c_len; c += kThreads)
      if (c < c0 || c >= c0 + nc)
        elsewhere |= attn::key_valid(qp, pos_b[c], true, window, is_chunked);
    skip = __syncthreads_or(elsewhere) != 0;
  }
  attn::cp_async_wait<0>();
  __syncthreads();
  const int64_t pidx = static_cast<int64_t>(bk) * n_splits + split;  // this partial
  if (skip) {
    for (int r = tid; r < g; r += kThreads) {
      part_ml[(pidx * g + r) * 2] = kNegInf;
      part_ml[(pidx * g + r) * 2 + 1] = 0.0f;
    }
  } else {
    // 3. scores (one thread per (row, entry)), masked to the finite sentinel
    for (int i = tid; i < g * nc; i += kThreads) {
      const int r = i / nc;
      const int c = i % nc;
      float s = dot_row<TKV, HD>(q_s + r * HD, k_s + c * KS);
      if (Smem::kQuant) s *= ks_s[c];
      s *= scale;
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      p_s[r * keys_per_split + c] =
          attn::key_valid(qp, kp_s[c], true, window, is_chunked) ? s : kNegInf;
    }
    __syncthreads();
    const int lane = tid & 31;
    for (int r = tid >> 5; r < g; r += kWarps) {  // one warp per query row
      float* pr = p_s + r * keys_per_split;
      float mx = kNegInf;
      for (int c = lane; c < nc; c += 32) mx = fmaxf(mx, pr[c]);
      mx = attn::warp_max(mx);
      float sum = 0.0f;
      for (int c = lane; c < nc; c += 32) {
        const float p = expf(pr[c] - mx);
        pr[c] = Smem::kQuant ? p * vs_s[c] : p;  // int8: the V scale folds into p
        sum += p;
      }
      sum = attn::warp_sum(sum);
      if (lane == 0) {
        m_s[r] = mx;
        l_s[r] = sum;
      }
    }
    __syncthreads();

    // acc = sum_c p_c v_c, two adjacent columns a thread; out or the partial
    for (int i = tid; i < g * HD / 2; i += kThreads) {
      const int r = i / (HD / 2);
      const int d = 2 * (i % (HD / 2));
      const float* pr = p_s + r * keys_per_split;
      float a0 = 0.0f;
      float a1 = 0.0f;
#pragma unroll 4
      for (int c = 0; c < nc; ++c) {
        const float2 vv = load_pair(v_s + c * HD + d);
        a0 = fmaf(pr[c], vv.x, a0);
        a1 = fmaf(pr[c], vv.y, a1);
      }
      if (n_splits == 1) {
        const float inv = 1.0f / fmaxf(l_s[r], 1e-30f);
        TQ* o = out + (static_cast<int64_t>(bk) * g + r) * HD + d;
        o[0] = attn::from_f<TQ>(a0 * inv);
        o[1] = attn::from_f<TQ>(a1 * inv);
      } else {
        float* pa = part_acc + (pidx * g + r) * HD + d;
        pa[0] = a0;
        pa[1] = a1;
      }
    }
    if (n_splits > 1) {
      for (int r = tid; r < g; r += kThreads) {
        part_ml[(pidx * g + r) * 2] = m_s[r];
        part_ml[(pidx * g + r) * 2 + 1] = l_s[r];
      }
    }
  }
  if (n_splits == 1) return;

  // 4. the last split of (row, kv head) to finish merges all of them, in
  // split order: m = max m_s, l = sum exp(m_s - m) l_s, acc likewise
  __threadfence();  // this CTA's partial is visible before it is counted
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(arrived + bk, 1) == n_splits - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (tid == 0) arrived[bk] = 0;  // ready for the next call on this stream
  const float* ml = part_ml + static_cast<int64_t>(bk) * n_splits * g * 2;
  const float* pa = part_acc + static_cast<int64_t>(bk) * n_splits * g * HD;
  // one thread per (query row, 4 columns); splits taken 8 at a time, their
  // L2 reads issued together, merged in split order with a running max
  constexpr int kBatch = 8;
  for (int i = tid; i < g * HD / 4; i += kThreads) {
    const int r = i / (HD / 4);
    const int d = 4 * (i % (HD / 4));
    float m = kNegInf;
    float l = 0.0f;
    float4 a = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < n_splits; s0 += kBatch) {
      float2 mls[kBatch];
      float4 as[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int s = min(s0 + u, n_splits - 1);
        mls[u] = __ldcg(reinterpret_cast<const float2*>(ml + (s * g + r) * 2));
        as[u] = __ldcg(
            reinterpret_cast<const float4*>(pa + (static_cast<int64_t>(s) * g + r) * HD + d));
      }
      float m_new = m;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) m_new = fmaxf(m_new, mls[u].x);
      const float alpha = expf(m - m_new);
      l *= alpha;
      a.x *= alpha;
      a.y *= alpha;
      a.z *= alpha;
      a.w *= alpha;
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        // a skipped split (l = 0) never wrote acc; the batch's tail repeats
        // the last split and is left out
        if (s0 + u >= n_splits || mls[u].y == 0.0f) continue;
        const float w = expf(mls[u].x - m_new);
        l = fmaf(w, mls[u].y, l);
        a.x = fmaf(w, as[u].x, a.x);
        a.y = fmaf(w, as[u].y, a.y);
        a.z = fmaf(w, as[u].z, a.z);
        a.w = fmaf(w, as[u].w, a.w);
      }
      m = m_new;
    }
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    TQ* o = out + (static_cast<int64_t>(bk) * g + r) * HD + d;
    o[0] = attn::from_f<TQ>(a.x * inv);
    o[1] = attn::from_f<TQ>(a.y * inv);
    o[2] = attn::from_f<TQ>(a.z * inv);
    o[3] = attn::from_f<TQ>(a.w * inv);
  }
}

template <typename TQ, typename TKV, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ks,
                   const float* vs, const int* kv_pos, const int* q_pos, void* out,
                   float* part_acc, float* part_ml, int* arrived, int b, int c, int kh,
                   int g, int keys_per_split, int n_splits, float scale, int window,
                   int chunked, float softcap, cudaStream_t stream) {
  auto kernel = flash_decode_split_kernel<TQ, TKV, HD>;
  const size_t smem = SplitSmem<TKV, HD>::bytes(g, keys_per_split);
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(n_splits, b * kh);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k), static_cast<const TKV*>(v), ks,
      vs, kv_pos, q_pos, static_cast<TQ*>(out), part_acc, part_ml, arrived, c, kh, g,
      keys_per_split, scale, window, chunked, softcap);
  return cudaGetLastError();
}

template <typename TQ, typename TKV>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const float* ks, const float* vs, const int* kv_pos,
                        const int* q_pos, void* out, float* pa, float* pm, int* ar, int b, int c,
                        int kh, int g, int kps, int ns, float scale, int window,
                        int chunked, float softcap, cudaStream_t st) {
  switch (hd) {
    case 32:
      return launch<TQ, TKV, 32>(q, k, v, ks, vs, kv_pos, q_pos, out, pa, pm, ar, b, c, kh, g,
                                 kps, ns, scale, window, chunked, softcap, st);
    case 64:
      return launch<TQ, TKV, 64>(q, k, v, ks, vs, kv_pos, q_pos, out, pa, pm, ar, b, c, kh, g,
                                 kps, ns, scale, window, chunked, softcap, st);
    case 128:
      return launch<TQ, TKV, 128>(q, k, v, ks, vs, kv_pos, q_pos, out, pa, pm, ar, b, c, kh, g,
                                  kps, ns, scale, window, chunked, softcap, st);
    case 256:
      return launch<TQ, TKV, 256>(q, k, v, ks, vs, kv_pos, q_pos, out, pa, pm, ar, b, c, kh, g,
                                  kps, ns, scale, window, chunked, softcap, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 float32, 1 bfloat16, 2 int8 (K/V only, with both scales).
// window <= 0: no window; softcap <= 0: no softcap. The splits must cover
// C exactly, none empty: (n_splits - 1) * keys_per_split < C <=
// n_splits * keys_per_split; part_acc / part_ml are needed when n_splits > 1.
int flash_decode_launch(const void* q, const void* k, const void* v, const void* k_scale,
                        const void* v_scale, const void* kv_pos, const void* q_pos,
                        void* out, void* part_acc, void* part_ml, void* arrived, int b,
                        int c, int kh,
                        int g, int hd, int q_dtype, int kv_dtype, int keys_per_split,
                        int n_splits, float scale, int window, int chunked, float softcap,
                        void* stream) {
  if (b <= 0 || c <= 0 || kh <= 0 || g <= 0 || b * kh > 65535 || keys_per_split <= 0 ||
      n_splits <= 0 || static_cast<int64_t>(n_splits) * keys_per_split < c ||
      static_cast<int64_t>(n_splits - 1) * keys_per_split >= c)
    return cudaErrorInvalidValue;
  if (n_splits > 1 && (part_acc == nullptr || part_ml == nullptr || arrived == nullptr))
    return cudaErrorInvalidValue;
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* kp = static_cast<const int*>(kv_pos);
  const int* qp = static_cast<const int*>(q_pos);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  int* ar = static_cast<int*>(arrived);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool quant = kv_dtype == 2;
  if (quant != (ks != nullptr && vs != nullptr)) return cudaErrorInvalidValue;
  if (q_dtype == 0 && kv_dtype == 0)
    return dispatch_hd<float, float>(hd, q, k, v, nullptr, nullptr, kp, qp, out, pa, pm, ar, b,
                                     c, kh, g, keys_per_split, n_splits, scale, window,
                                     chunked, softcap, st);
  if (q_dtype == 1 && kv_dtype == 1)
    return dispatch_hd<__nv_bfloat16, __nv_bfloat16>(hd, q, k, v, nullptr, nullptr, kp, qp,
                                                     out, pa, pm, ar, b, c, kh, g,
                                                     keys_per_split, n_splits, scale,
                                                     window, chunked, softcap, st);
  if (q_dtype == 0 && quant)
    return dispatch_hd<float, int8_t>(hd, q, k, v, ks, vs, kp, qp, out, pa, pm, ar, b, c, kh, g,
                                      keys_per_split, n_splits, scale, window, chunked,
                                      softcap, st);
  if (q_dtype == 1 && quant)
    return dispatch_hd<__nv_bfloat16, int8_t>(hd, q, k, v, ks, vs, kp, qp, out, pa, pm, ar, b,
                                              c, kh, g, keys_per_split, n_splits, scale,
                                              window, chunked, softcap, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
