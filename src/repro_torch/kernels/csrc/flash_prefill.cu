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
// three digits). One CTA per (q tile of ~4096 / hd rows, q head, b) stages
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
// Any head dim. Both templates are built for the widths 32, 64, 80, 96,
// 128, 160, 192 and 256; a head dim hd runs at the next of them, each row
// of q, K and V padded in shared memory from hd to that width with zeros
// (cp.async's zero-fill where the rows are whole, aligned 16-byte vectors,
// element by element where they are not). A zero column adds an exact
// zero to Q.K^T, and the padded output columns are never stored, so
// padding changes no value. The bf16 template is built twice a width: for
// a head dim equal to it in aligned 16-byte rows (EXACT: hd and the copies
// known to the compiler; the main path's), and padded. The f32
// template takes only a head dim equal to its width in aligned rows; any
// other f32 head dim takes the wide kernel below. At 80 (zamba2's shared
// block) the bf16 tile
// takes 5 k-steps of 16 in Q.K^T and 5 ldmatrix.x4.trans loads (10 n8
// tiles) in P.V; its rows are 88 bf16 (176 bytes, 11 x 16: 16-byte aligned
// for cp.async and ldmatrix, and 8 rows at 44-word offsets hit disjoint
// banks); 96, 160 and 192 pad rows to 13, 21 and 25 x 16 bytes likewise.
// The f32 tile takes 48 query rows at 80 (40 at 96, 24 at 160, 16 at
// 192), so the accumulators of a thread cover it exactly.
//
// Above 256 (flash_prefill_wide_kernel; and in f32 off the widths), one
// route for both dtypes on CUDA cores: the f32 template's walk with the
// width a run-time argument (hd rounded up to 16), in register tiles of 4
// query rows a warp (the scores, running max and sum in registers, p
// passed between lanes by shuffles), the running output in shared memory
// between KV tiles, the q tile and the KV tile sized on the host to fit
// shared memory. Not tuned further.
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
  // query rows per CTA: a q tile of 4096 f32, cut so that the tile's
  // elements share out evenly over the threads (hd 80: 48 rows, not 51)
  static constexpr int kRows = 4096 / HD / (kThreads / 16) * (kThreads / 16);
  static constexpr int kKStride = HD + 1;               // padded K rows
  static constexpr int kAcc = kRows * HD / kThreads;    // acc registers per thread
  static_assert(kRows * HD % kThreads == 0, "acc must cover the tile exactly");
  static constexpr size_t kSmem =
      sizeof(float) * (kRows * HD + kKeys * kKStride + kKeys * HD + kRows * kKeys +
                       3 * kRows) +
      sizeof(int) * (kRows + kKeys);
};

// hd = HD, rows of whole, aligned 16-byte vectors (other f32 head dims
// take flash_prefill_wide_kernel)
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ qpos,
                     const int* __restrict__ kpos, T* __restrict__ out, int sq, int skv,
                     int h_n, int kh_n, float scale, int causal, int window, int chunked,
                     float softcap) {
  constexpr int hd = HD;
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

  const int64_t q_row_stride = static_cast<int64_t>(h_n) * hd;
  const int64_t kv_row_stride = static_cast<int64_t>(kh_n) * hd;
  const int64_t q_off = ((static_cast<int64_t>(b) * sq + q0) * h_n + hq) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * skv * kh_n + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * skv * kh_n + kvh) * hd;

  attn::load_tile<T, true>(q + q_off, q_row_stride, nq, q_s, HD, hd, HD, true);
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

    attn::load_tile<T, true>(kb + static_cast<int64_t>(c0) * kv_row_stride, kv_row_stride,
                             nk, k_s, KS, hd, HD, true);
    attn::load_tile<T, true>(vb + static_cast<int64_t>(c0) * kv_row_stride, kv_row_stride,
                             nk, v_s, HD, hd, HD, true);
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

// HD: the padded width; hd: the head dim in memory; vec: rows load as
// 16-byte vectors (cp.async, zero-filled past hd). EXACT: hd = HD and vec,
// both known to the compiler (a head dim the kernel is built for).
template <int HD, bool EXACT>
__global__ void __launch_bounds__(kThreads)
flash_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ qpos,
                         const int* __restrict__ kpos, __nv_bfloat16* __restrict__ out, int sq,
                         int skv, int h_n, int kh_n, float scale, int causal, int window,
                         int chunked, float softcap, int hd_arg, bool vec_arg) {
  const int hd = EXACT ? HD : hd_arg;
  const bool vec = EXACT || vec_arg;
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

  const int64_t kv_row_stride = static_cast<int64_t>(kh_n) * hd;
  const __nv_bfloat16* kb = k + (static_cast<int64_t>(b) * skv * kh_n + kvh) * hd;
  const __nv_bfloat16* vb = v + (static_cast<int64_t>(b) * skv * kh_n + kvh) * hd;
  // q / out element of packed row L: position L / g, head kvh * g + L % g
  auto row_off = [&](int L) -> int64_t {
    return ((static_cast<int64_t>(b) * sq + L / g) * h_n + kvh * g + L % g) * hd;
  };
  // columns j .. j + 7 of a shared row from `row` (hd long; zeros when not
  // `real`), zero past hd: one 16-byte cp.async when vec (8 columns or none
  // there), else element by element. The EXACT kernel copies whole rows
  // by cp.async alone, written out in place below.
  auto load8 = [&](__nv_bfloat16* dst, const __nv_bfloat16* row, bool real, int j) {
    const int n = real ? min(max(hd - j, 0), 8) : 0;
    if (vec) {
      attn::cp_async16(dst, n > 0 ? row + j : row, 2 * n);
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) dst[u] = u < n ? row[j + u] : __float2bfloat16(0.0f);
    }
  };

  // Q tile (zero rows past the end), committed with the first K/V tile
  for (int i = tid; i < BM * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int j = (i % kChunks) * 8;
    const bool real = l0 + r < n_rows;
    if constexpr (EXACT)
      attn::cp_async16(q_s + r * ST + j, real ? q + row_off(l0 + r) + j : q, real ? 16 : 0);
    else
      load8(q_s + r * ST + j, real ? q + row_off(l0 + r) : q, real, j);
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
      if constexpr (EXACT) {
        const int64_t off = real ? static_cast<int64_t>(c0 + r) * kv_row_stride + j : 0;
        attn::cp_async16(k_s + (buf * BK + r) * ST + j, kb + off, real ? 16 : 0);
        attn::cp_async16(v_s + (buf * BK + r) * ST + j, vb + off, real ? 16 : 0);
      } else {
        const int64_t off = real ? static_cast<int64_t>(c0 + r) * kv_row_stride : 0;
        load8(k_s + (buf * BK + r) * ST + j, kb + off, real, j);
        load8(v_s + (buf * BK + r) * ST + j, vb + off, real, j);
      }
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
    if constexpr (EXACT) {
      if (L < n_rows)
        *reinterpret_cast<uint4*>(out + row_off(L) + j) =
            *reinterpret_cast<const uint4*>(o_s + r * ST + j);
    } else if (L < n_rows && j < hd) {
      if (vec)
        *reinterpret_cast<uint4*>(out + row_off(L) + j) =
            *reinterpret_cast<const uint4*>(o_s + r * ST + j);
      else
        for (int u = 0; u < 8 && j + u < hd; ++u) out[row_off(L) + j + u] = o_s[r * ST + j + u];
    }
  }
}

// ---- above 256: CUDA cores, the width at run time --------------------------

constexpr int kWideRowsMax = 4;   // query rows a warp
constexpr int kWideCols = 8;      // output columns a lane takes per pass (8 x 32 a warp)

// Tile sizes of the wide kernel: bq query rows a CTA (bq / 4 a warp), nkeys
// keys a KV tile (one warp lane each), width w = hd rounded up to 16.
struct WideTile {
  int w, bq, nkeys;
  size_t smem() const {
    return sizeof(float) * ((4 * kWideRowsMax + static_cast<size_t>(bq)) * w +
                            static_cast<size_t>(nkeys) * (2 * w + 1)) +
           sizeof(int) * (bq + kKeys);
  }
};

// 16 rows and 32 keys a CTA; keys halved (down to 8) until two CTAs fit an
// SM, then rows halved (down to 4) until one fits
inline WideTile wide_tile(int hd) {
  WideTile t{(hd + 15) / 16 * 16, 4 * kWideRowsMax, kKeys};
  while (t.smem() > 232448 / 2 && t.nkeys > 8) t.nkeys /= 2;
  while (t.smem() > 232448 && t.bq > 4) t.bq /= 2;
  return t;
}

// grid (ceil(Sq / bq), H, B), 128 threads; the f32 template's walk (see the
// note at the top) in register tiles: warp w takes query rows w·rpw ..
// (rpw = bq / 4), lane l key l of each KV tile for the scores and columns
// l, l + 32, ... for the output. q is kept transposed in shared memory (a
// warp's rows at one column are one float4), the scores, the running max
// and sum stay in registers, p reaches the lanes by shuffles, and the
// running output lives in shared memory between KV tiles.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_prefill_wide_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const int* __restrict__ qpos,
                          const int* __restrict__ kpos, T* __restrict__ out, int sq, int skv,
                          int h_n, int kh_n, float scale, int causal, int window, int chunked,
                          float softcap, int hd, WideTile tile, bool vec) {
  const int w = tile.w, bq = tile.bq, nkeys = tile.nkeys;
  const int rpw = bq / kWarps;
  const int ks = w + 1;  // padded K rows: the lanes of a warp, one key each
  extern __shared__ __align__(16) float wsmem[];
  float* qt_s = wsmem;              // [w][4 warps][kWideRowsMax]: q transposed
  float* o_s = qt_s + w * 4 * kWideRowsMax;  // [bq][w] the running output
  float* k_s = o_s + bq * w;       // [nkeys][ks]
  float* v_s = k_s + nkeys * ks;   // [nkeys][w]
  int* qp_s = reinterpret_cast<int*>(v_s + nkeys * w);  // [bq]
  int* kp_s = qp_s + bq;                                 // [kKeys]

  const int q0 = blockIdx.x * bq;
  const int hq = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = hq / (h_n / kh_n);
  const int nq = min(bq, sq - q0);
  const bool is_causal = causal != 0;
  const bool is_chunked = chunked != 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = warp * rpw;  // the warp's first row

  const int64_t q_row_stride = static_cast<int64_t>(h_n) * hd;
  const int64_t kv_row_stride = static_cast<int64_t>(kh_n) * hd;
  const int64_t q_off = ((static_cast<int64_t>(b) * sq + q0) * h_n + hq) * hd;
  const T* kb = k + (static_cast<int64_t>(b) * skv * kh_n + kvh) * hd;
  const T* vb = v + (static_cast<int64_t>(b) * skv * kh_n + kvh) * hd;

  // q transposed, a warp's rows at one column side by side (zeros past hd,
  // past nq and past rpw), the output zeroed
  for (int i = threadIdx.x; i < 4 * kWideRowsMax * w; i += kThreads) {
    const int d = i / (4 * kWideRowsMax), slot = i % (4 * kWideRowsMax);
    const int ii = slot % kWideRowsMax, r = slot / kWideRowsMax * rpw + ii;
    qt_s[i] = ii < rpw && r < nq && d < hd ? attn::to_f(q[q_off + r * q_row_stride + d]) : 0.0f;
  }
  for (int i = threadIdx.x; i < bq * w; i += kThreads) o_s[i] = 0.0f;
  for (int r = threadIdx.x; r < bq; r += kThreads)
    qp_s[r] = r < nq ? (qpos != nullptr ? qpos[q0 + r] : q0 + r) : 0;
  float m_r[kWideRowsMax], l_r[kWideRowsMax];
#pragma unroll
  for (int i = 0; i < kWideRowsMax; ++i) {
    m_r[i] = kNegInf;
    l_r[i] = 0.0f;
  }
  bool all_seen = false;  // CTA-uniform: every real query row has met a visible key

  for (int c0 = 0; c0 < skv; c0 += nkeys) {
    const int nk = min(nkeys, skv - c0);
    for (int c = threadIdx.x; c < kKeys; c += kThreads)
      kp_s[c] = c < nk ? (kpos != nullptr ? kpos[c0 + c] : c0 + c) : -1;
    __syncthreads();
    int mine = 0;
    for (int i = threadIdx.x; i < bq * nkeys; i += kThreads) {
      const int r = i / nkeys;
      const int c = i % nkeys;
      if (r < nq && c < nk && attn::key_valid(qp_s[r], kp_s[c], is_causal, window, is_chunked))
        mine = 1;
    }
    if (!__syncthreads_or(mine) && all_seen) continue;

    attn::load_tile<T, false>(kb + static_cast<int64_t>(c0) * kv_row_stride, kv_row_stride,
                              nk, k_s, ks, hd, w, vec);
    attn::load_tile<T, false>(vb + static_cast<int64_t>(c0) * kv_row_stride, kv_row_stride,
                              nk, v_s, w, hd, w, vec);
    __syncthreads();

    // scores of the warp's rows against the lane's key: k read once for
    // all rows, the rows' q at a column as one float4
    const bool key = lane < nk;
    float s[kWideRowsMax] = {};
    if (key) {
      const float* kr = k_s + lane * ks;
#pragma unroll 4
      for (int d = 0; d < w; ++d) {
        const float kv = kr[d];
        const float4 qv =
            *reinterpret_cast<const float4*>(qt_s + (d * 4 + warp) * kWideRowsMax);
        s[0] = fmaf(qv.x, kv, s[0]);
        s[1] = fmaf(qv.y, kv, s[1]);
        s[2] = fmaf(qv.z, kv, s[2]);
        s[3] = fmaf(qv.w, kv, s[3]);
      }
    }
    // online softmax in registers: a row's scores lie across the warp
    float alpha[kWideRowsMax];
#pragma unroll
    for (int i = 0; i < kWideRowsMax; ++i) {
      const int r = r0 + i;
      float x = kNegInf;
      if (key) {
        x = s[i] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        if (!(i < rpw && r < nq &&
              attn::key_valid(qp_s[r], kp_s[lane], is_causal, window, is_chunked)))
          x = kNegInf;
      }
      const float m_new = fmaxf(m_r[i], attn::warp_max(x));
      s[i] = key ? expf(x - m_new) : 0.0f;
      alpha[i] = expf(m_r[i] - m_new);
      l_r[i] = l_r[i] * alpha[i] + attn::warp_sum(s[i]);
      m_r[i] = m_new;
    }

    // o = o · alpha + p · V over the warp's rows, kWideCols columns a lane
    // a pass; p of key c from lane c
    for (int cb = 0; cb < w; cb += 32 * kWideCols) {
      float acc[kWideRowsMax][kWideCols];
#pragma unroll
      for (int i = 0; i < kWideRowsMax; ++i)
#pragma unroll
        for (int j = 0; j < kWideCols; ++j) {
          const int d = cb + lane + 32 * j;
          acc[i][j] = i < rpw && d < w ? o_s[(r0 + i) * w + d] * alpha[i] : 0.0f;
        }
      for (int c = 0; c < nk; ++c) {
        float p[kWideRowsMax];
#pragma unroll
        for (int i = 0; i < kWideRowsMax; ++i) p[i] = __shfl_sync(0xffffffffu, s[i], c);
#pragma unroll
        for (int j = 0; j < kWideCols; ++j) {
          const int d = cb + lane + 32 * j;
          const float vv = d < w ? v_s[c * w + d] : 0.0f;
#pragma unroll
          for (int i = 0; i < kWideRowsMax; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kWideRowsMax; ++i)
#pragma unroll
        for (int j = 0; j < kWideCols; ++j) {
          const int d = cb + lane + 32 * j;
          if (i < rpw && d < w) o_s[(r0 + i) * w + d] = acc[i][j];
        }
    }
    if (!all_seen) {
      int seen = 1;
#pragma unroll
      for (int i = 0; i < kWideRowsMax; ++i) seen &= i >= rpw || r0 + i >= nq || m_r[i] > kNegInf;
      all_seen = __syncthreads_and(seen) != 0;
    }
    __syncthreads();
  }

  // each warp writes its rows: o / l
  T* ob = out + q_off;
#pragma unroll
  for (int i = 0; i < kWideRowsMax; ++i) {
    const int r = r0 + i;
    if (i >= rpw || r >= nq) continue;
    const float inv = 1.0f / fmaxf(l_r[i], 1e-30f);
    for (int d = lane; d < hd; d += 32)
      ob[r * q_row_stride + d] = attn::from_f<T>(o_s[r * w + d] * inv);
  }
}

// ---- host side ------------------------------------------------------------

// rows of whole, aligned 16-byte vectors of T
template <typename T>
bool rows_vec(int hd, const void* q, const void* k, const void* v) {
  return hd * sizeof(T) % 16 == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(k) % 16 == 0 && reinterpret_cast<uintptr_t>(v) % 16 == 0;
}

template <int HD>
cudaError_t launch_mma(const void* q, const void* k, const void* v, const int* qpos,
                       const int* kpos, void* out, int b, int sq, int skv, int h, int kh,
                       float scale, int causal, int window, int chunked, float softcap, int hd,
                       cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bool vec = rows_vec<bf16>(hd, q, k, v) && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  auto kernel = hd == HD && vec ? flash_prefill_mma_kernel<HD, true>
                                : flash_prefill_mma_kernel<HD, false>;
  constexpr size_t smem = MmaTile<HD>::kSmem;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows = static_cast<int64_t>(sq) * (h / kh);
  const auto tiles = static_cast<unsigned>((rows + MmaTile<HD>::kRows - 1) / MmaTile<HD>::kRows);
  const dim3 grid(tiles, kh, b);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      qpos, kpos, static_cast<bf16*>(out), sq, skv, h, kh, scale, causal, window, chunked,
      softcap, hd, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const void* q, const void* k, const void* v, const int* qpos,
                        const int* kpos, void* out, int b, int sq, int skv, int h, int kh,
                        float scale, int causal, int window, int chunked, float softcap, int hd,
                        cudaStream_t stream) {
  auto kernel = flash_prefill_wide_kernel<T>;
  const WideTile tile = wide_tile(hd);
  cudaError_t err = attn::allow_smem(kernel, tile.smem());
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + tile.bq - 1) / tile.bq, h, b);
  kernel<<<grid, kThreads, tile.smem(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), qpos, kpos,
      static_cast<T*>(out), sq, skv, h, kh, scale, causal, window, chunked, softcap, hd, tile,
      rows_vec<T>(hd, q, k, v));
  return cudaGetLastError();
}

// bf16 on the tensor cores, f32 on the CUDA cores (see the note above); an
// f32 head dim off the widths takes the wide kernel
template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* qpos,
                   const int* kpos, void* out, int b, int sq, int skv, int h, int kh,
                   float scale, int causal, int window, int chunked, float softcap, int hd,
                   cudaStream_t stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return launch_mma<HD>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal, window,
                          chunked, softcap, hd, stream);
  } else {
    if (hd != HD || !rows_vec<T>(hd, q, k, v))
      return launch_wide<T>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal, window,
                            chunked, softcap, hd, stream);
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

// the next width the templates are built for, or the wide kernel above 256
template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v,
                        const int* qpos, const int* kpos, void* out, int b, int sq,
                        int skv, int h, int kh, float scale, int causal, int window,
                        int chunked, float softcap, cudaStream_t st) {
#define PREFILL_AT(W)                                                                        \
  launch<T, W>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal, window, chunked, \
               softcap, hd, st)
  if (hd <= 0) return cudaErrorInvalidValue;
  if (hd <= 32) return PREFILL_AT(32);
  if (hd <= 64) return PREFILL_AT(64);
  if (hd <= 80) return PREFILL_AT(80);
  if (hd <= 96) return PREFILL_AT(96);
  if (hd <= 128) return PREFILL_AT(128);
  if (hd <= 160) return PREFILL_AT(160);
  if (hd <= 192) return PREFILL_AT(192);
  if (hd <= 256) return PREFILL_AT(256);
#undef PREFILL_AT
  return launch_wide<T>(q, k, v, qpos, kpos, out, b, sq, skv, h, kh, scale, causal, window,
                        chunked, softcap, hd, st);
}

}  // namespace

extern "C" {

// The largest head dim the wide kernel's tile fits a CTA's shared memory at
// (the Python wrapper checks it when it binds the library).
int flash_prefill_max_head_dim() {
  int hd = 256;
  while (wide_tile(hd + 16).smem() <= 232448) hd += 16;
  return hd;
}

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
