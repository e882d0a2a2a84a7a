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
// Ragged Sq and Skv are masked (no divisibility requirement): rows past Sq
// are not written and entries past Skv are not keys.
//
// What bounds it on an H100: at the main path's prefill shapes (S <= 256,
// hd 128) bytes, just: each q, k, v and out element moves once and does
// ~S/2 multiply-adds per query head of its group (3.1 us of bytes against
// 0.3 us of bf16 tensor-core work at [8, 64, 32, 128]). At these sizes one
// wave of CTAs covers the problem, so what is left to beat is the latency
// of each CTA's chain: load, products, softmax, store.
//
// bf16, the main path: tensor cores (flash_prefill_mma_kernel). One CTA of
// four warps per (64 packed rows, kv head, b). A packed row is a (position,
// head) pair of the kv head's group, row L = position * g + head: for a
// fixed position the g heads are contiguous in q, so the tile is runs of
// g * hd elements and the g heads share every K/V tile (at [8, 64, 32, 128],
// g 4: 16 positions x 4 heads a CTA, 256 CTAs). Q, K and V tiles stay bf16
// in shared memory, rows padded by 16 bytes so that ldmatrix is free of
// bank conflicts, filled by 16-byte cp.async (zero-filled past a ragged
// edge), K/V double-buffered: the next needed tile loads while this one
// computes. Each warp owns 16 rows: S = Q.K^T with mma.sync.m16n8k16
// (bf16 in, f32 accumulate; Q fragments held in registers up to hd 128
// and read from shared memory at hd 256, where registers would spill), K
// by ldmatrix; the online softmax runs on the S fragments in registers
// (row max and sum across the quad by shuffles, exp2 of log2(e)-scaled
// scores); then O += P.V with P rounded to bf16 (as the reference model's
// plain attention rounds p to V's type) and V by ldmatrix.trans, O in f32
// registers. Q.K^T itself is exact in products and sums in f32, as the
// TPU kernel's f32 dot_general does. Held to its plain version (f32 p) at
// 1e-2 of max|plain|. Within a tile, a 16-key block that no row of a warp
// sees is left out of both products once every row of the warp has a
// visible key (in this tile or an earlier one): its p are then exactly 0.
// O is staged through shared memory and written as 16-byte vectors.
//
// f32: CUDA cores (flash_prefill_kernel), an explicit dispatch on dtype:
// mma.sync has no f32 path that meets 1e-5 of max|plain| (TF32 keeps about
// three digits). One CTA per (q tile of 4096 / hd rows, q head, b) stages
// its q tile in shared memory as f32 and walks the KV tiles of kv head
// h / g (32 keys each); scores, the online softmax (one warp lane per key)
// and the PV product run in f32 with acc in registers.
//
// Skipping masked tiles, both templates: a KV tile in which no (query, key)
// pair of the CTA is visible is skipped, but only once every query row of
// the CTA has met a visible key: from then on such a tile adds exactly
// nothing (p = 0), while a row with no visible key yet must still take the
// tile into its sentinel mean, as the TPU kernel does. Visibility depends
// only on positions, so the bf16 template decides it before it loads a
// tile, over the CTA's positions.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/flash_prefill.py).
// The entry point launches on the caller's stream and returns a CUDA error
// code (0 on success).

#include <type_traits>

#include "attention.cuh"

namespace {

using attn::kNegInf;
using attn::kThreads;
using attn::kWarps;

constexpr float kLog2e = 1.4426950408889634f;

// ---- f32: CUDA cores -------------------------------------------------------

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

// ---- bf16: tensor cores ---------------------------------------------------

template <int HD> struct MmaTile {
  static constexpr int kRows = 64;                  // packed rows per CTA, 16 per warp
  static constexpr int kKeys = HD <= 128 ? 64 : 32; // keys per K/V tile
  static constexpr int kStride = HD + 8;            // bf16 per smem row: 16 bytes of pad
  static constexpr bool kQRegs = HD <= 128;         // Q fragments in registers
  static constexpr size_t kSmem =
      sizeof(__nv_bfloat16) * kStride * (kRows + 4 * kKeys) + sizeof(int) * (2 * kKeys + 2 * kRows);
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                         const int* __restrict__ kpos, __nv_bfloat16* __restrict__ out, int sq,
                         int skv, int h_n, int kh_n, float scale, int causal, int window,
                         int chunked, float softcap) {
  using Tile = MmaTile<HD>;
  constexpr int BM = Tile::kRows;
  constexpr int BK = Tile::kKeys;
  constexpr int ST = Tile::kStride;
  constexpr int kChunks = HD / 8;  // 16-byte pieces of a row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BM][ST]
  __nv_bfloat16* k_s = q_s + BM * ST;                                // [2][BK][ST]
  __nv_bfloat16* v_s = k_s + 2 * BK * ST;                            // [2][BK][ST]
  int* kp_s = reinterpret_cast<int*>(v_s + 2 * BK * ST);             // [2][BK]
  int* qp_s = kp_s + 2 * BK;    // [BM] positions of the CTA's rows
  int* seen_s = qp_s + BM;      // [BM] has the position met a visible key?

  const int g = h_n / kh_n;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int n_rows = sq * g;  // packed rows of this (b, kv head)
  const int l0 = blockIdx.x * BM;
  const int pos0 = l0 / g;
  const int npos = min((l0 + BM - 1) / g, sq - 1) - pos0 + 1;
  const int n_tiles = (skv + BK - 1) / BK;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gid = lane >> 2;  // row of the mma fragment (and +8)
  const int tig = lane & 3;   // column pair of the mma fragment
  const bool is_causal = causal != 0;
  const bool is_chunked = chunked != 0;

  const int64_t kv_row_stride = static_cast<int64_t>(kh_n) * HD;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * skv * kh_n + kvh) * HD;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * skv * kh_n + kvh) * HD;
  // q / out element of packed row L: position L / g, head kvh * g + L % g
  auto row_off = [&](int L) -> int64_t {
    return ((static_cast<int64_t>(b) * sq + L / g) * h_n + kvh * g + L % g) * HD;
  };

  // Q tile (zero rows past the end), committed with the first K/V tile
  for (int i = tid; i < BM * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int j = (i % kChunks) * 8;
    const bool real = l0 + r < n_rows;
    attn::cp_async16(q_s + r * ST + j, real ? q + row_off(l0 + r) + j : q, real ? 16 : 0);
  }
  for (int i = tid; i < BM; i += kThreads) {
    qp_s[i] = i < npos ? (qpos != nullptr ? qpos[pos0 + i] : pos0 + i) : 0;
    seen_s[i] = i < npos ? 0 : 1;
  }
  auto load_kv = [&](int t, int buf) {
    const int c0 = t * BK;
    for (int i = tid; i < BK * kChunks; i += kThreads) {
      const int r = i / kChunks;
      const int j = (i % kChunks) * 8;
      const bool real = c0 + r < skv;
      const int64_t off = real ? static_cast<int64_t>(c0 + r) * kv_row_stride + j : 0;
      attn::cp_async16(k_s + (buf * BK + r) * ST + j, kb + off, real ? 16 : 0);
      attn::cp_async16(v_s + (buf * BK + r) * ST + j, vb + off, real ? 16 : 0);
    }
    attn::cp_async_commit();
  };
  // Stage tile t's key positions in kp_s[buf]; is any (position, key) pair
  // of the CTA visible in it? Marks the positions that see a key.
  auto test_tile = [&](int t, int buf) -> bool {
    const int c0 = t * BK;
    const int nk = min(BK, skv - c0);
    __syncthreads();  // qp_s / seen_s written, kp_s[buf] no longer read
    for (int c = tid; c < BK; c += kThreads)
      kp_s[buf * BK + c] = c < nk ? (kpos != nullptr ? kpos[c0 + c] : c0 + c) : -1;
    __syncthreads();
    int mine = 0;
    for (int i = tid; i < npos * BK; i += kThreads) {
      const int p = i / BK;
      const int c = i % BK;
      if (c < nk && attn::key_valid(qp_s[p], kp_s[buf * BK + c], is_causal, window, is_chunked)) {
        mine = 1;
        seen_s[p] = 1;
      }
    }
    return __syncthreads_or(mine) != 0;
  };
  auto all_seen = [&]() -> bool {
    int ok = 1;
    for (int p = tid; p < npos; p += kThreads) ok &= seen_s[p];
    return __syncthreads_and(ok) != 0;
  };

  // this thread's two rows (gid, gid + 8 of its warp's 16)
  int qp_r[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int L = min(l0 + warp * 16 + gid + 8 * hf, n_rows - 1);
    qp_r[hf] = qpos != nullptr ? qpos[L / g] : L / g;
  }
  float o[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.0f;
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.0f, 0.0f};
  uint32_t qf[Tile::kQRegs ? HD / 16 : 1][4];
  // lane's ldmatrix rows: Q row lane % 16, column half lane / 16; K and
  // V: row lane % 8 of matrix lane / 8, which is (key +8 if >= 2, hd +8 if
  // odd) for K and (key +8 if odd, hd +8 if >= 2) for V^T
  const __nv_bfloat16* q_warp = q_s + (warp * 16 + (lane & 15)) * ST + (lane >> 4) * 8;
  const int mi = lane >> 3;
  const int k_lane = ((mi >> 1) * 8 + (lane & 7)) * ST + (mi & 1) * 8;
  const int v_lane = ((mi & 1) * 8 + (lane & 7)) * ST + (mi >> 1) * 8;

  bool seen = false;  // CTA-uniform: every real row has met a visible key
  load_kv(0, 0);      // no row has seen a key yet: tile 0 is needed
  test_tile(0, 0);
  int cur = 0;
  int buf = 0;
  while (cur < n_tiles) {
    // the next needed tile, loading while this one computes
    if (!seen) seen = all_seen();
    int nxt = cur + 1;
    while (nxt < n_tiles && !test_tile(nxt, buf ^ 1) && seen) ++nxt;
    if (nxt < n_tiles) {
      load_kv(nxt, buf ^ 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    if (Tile::kQRegs && cur == 0) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        attn::ldmatrix_x4(qf[Tile::kQRegs ? kk : 0], q_warp + kk * 16);
    }

    // Which of this tile's keys does each of the thread's two rows see?
    // Bit 4j + e is S fragment element (j, e): row gid + 8 (e / 2), key
    // j * 8 + 2 tig + e % 2. A 16-key block that no row of the warp sees is
    // skipped in both products once every row of the warp has a visible
    // key in this tile or an earlier one: its p are then exactly 0.
    const __nv_bfloat16* kt = k_s + buf * BK * ST;
    const __nv_bfloat16* vt = v_s + buf * BK * ST;
    const int c0 = cur * BK;
    const int* kp = kp_s + buf * BK;
    uint32_t vis = 0;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tig * 2 + (e & 1);
        if (c0 + col < skv && attn::key_valid(qp_r[e >> 1], kp[col], is_causal, window, is_chunked))
          vis |= 1u << (4 * j + e);
      }
    }
    uint32_t row_vis[2] = {vis & 0x33333333u, vis & 0xccccccccu};  // rows gid, gid + 8
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      row_vis[hf] |= __shfl_xor_sync(0xffffffffu, row_vis[hf], 1);
      row_vis[hf] |= __shfl_xor_sync(0xffffffffu, row_vis[hf], 2);
    }
    const bool can_skip = __all_sync(0xffffffffu, (row_vis[0] != 0 || m_r[0] > kNegInf) &&
                                                      (row_vis[1] != 0 || m_r[1] > kNegInf));
    uint32_t blocks = (1u << (BK / 16)) - 1;  // bit kk: keys 16 kk .. 16 kk + 15 computed
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      if (can_skip && !__any_sync(0xffffffffu, (vis >> (8 * kk)) & 0xffu)) blocks &= ~(1u << kk);

    // S = Q . K^T, 16 rows x BK keys a warp
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      if constexpr (Tile::kQRegs) {
#pragma unroll
        for (int u = 0; u < 4; ++u) a[u] = qf[Tile::kQRegs ? kk : 0][u];
      } else {
        attn::ldmatrix_x4(a, q_warp + kk * 16);
      }
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        if (!((blocks >> (j / 2)) & 1u)) continue;
        uint32_t bf[4];
        attn::ldmatrix_x4(bf, kt + k_lane + j * 8 * ST + kk * 16);
        attn::mma_bf16(s[j], a, bf[0], bf[1]);
        attn::mma_bf16(s[j + 1], a, bf[2], bf[3]);
      }
    }

    // scale, softcap, mask; online softmax on the fragments, in log2 units
    // (exp2 of log2(e)-scaled scores; the sentinel stays -1e30)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if ((vis >> (4 * j + e)) & 1u) {
          x = s[j][e] * scale;
          if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
          x *= kLog2e;
        } else {
          // masked: the finite sentinel; past Skv: not a key, p = 0
          x = c0 + j * 8 + tig * 2 + (e & 1) < skv ? kNegInf : -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
      const float m_new = fmaxf(m_r[hf], mx[hf]);
      alpha[hf] = exp2f(m_r[hf] - m_new);
      m_r[hf] = m_new;
      l_r[hf] *= alpha[hf];
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_r[e >> 1]);
        l_r[e >> 1] += p;
        s[j][e] = p;
      }
    }

    // O += P . V, P rounded to bf16: the C fragments of key blocks 2kk and
    // 2kk + 1 are the A fragment of the k-step kk
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (!((blocks >> kk) & 1u)) continue;
      const uint32_t a[4] = {attn::pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             attn::pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             attn::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             attn::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int j = 0; j < HD / 8; j += 2) {
        uint32_t bf[4];
        attn::ldmatrix_x4_trans(bf, vt + v_lane + kk * 16 * ST + j * 8);
        attn::mma_bf16(o[j], a, bf[0], bf[1]);
        attn::mma_bf16(o[j + 1], a, bf[2], bf[3]);
      }
    }
    cur = nxt;
    buf ^= 1;
  }

  // out = O / l, the row sums completed across the quad; each warp stages
  // its 16 rows in its own rows of q_s, then writes them as 16-byte vectors
  __nv_bfloat16* o_s = q_s + warp * 16 * ST;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 1);
    l_r[hf] += __shfl_xor_sync(0xffffffffu, l_r[hf], 2);
    const float inv = 1.0f / fmaxf(l_r[hf], 1e-30f);
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(o_s + (gid + 8 * hf) * ST + j * 8 + tig * 2) =
          __floats2bfloat162_rn(o[j][2 * hf] * inv, o[j][2 * hf + 1] * inv);
  }
  __syncwarp();
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks;
    const int j = (i % kChunks) * 8;
    const int L = l0 + warp * 16 + r;
    if (L < n_rows)
      *reinterpret_cast<uint4*>(out + row_off(L) + j) =
          *reinterpret_cast<const uint4*>(o_s + r * ST + j);
  }
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* qpos,
                       const int* kpos, void* out, int b, int sq, int skv, int h, int kh,
                       float scale, int causal, int window, int chunked, float softcap,
                       cudaStream_t stream) {
  auto kernel = flash_prefill_mma_kernel<HD>;
  constexpr size_t smem = MmaTile<HD>::kSmem;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(sq) * (h / kh);
  const auto tiles = static_cast<unsigned>((rows + MmaTile<HD>::kRows - 1) / MmaTile<HD>::kRows);
  const dim3 grid(tiles, kh, b);
  using bf16 = __nv_bfloat16;
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      qpos, kpos, static_cast<bf16*>(out), sq, skv, h, kh, scale, causal, window, chunked,
      softcap);
  return cudaGetLastError();
}

// bf16 on the tensor cores, f32 on the CUDA cores (see the note above)
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, int b, int sq, int skv, int h, int kh,
                   float scale, int causal, int window, int chunked, float softcap,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_mma<HD>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal, window,
                          chunked, softcap, stream);
  } else {
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
