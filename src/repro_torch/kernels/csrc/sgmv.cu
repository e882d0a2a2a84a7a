// SGMV (segmented gather matrix-vector) kernels for Hopper: the paper's
// Batch LoRA Inference hot loop, as hand-written CUDA.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/sgmv.py:
//   sgmv_shrink (_shrink_kernel, :62):  s[T, r]     = x[T, d_in] · A[slot]ᵀ  (f32 out)
//   sgmv_expand (_expand_kernel, :98):  y[T, d_out] = s[T, r]    · B[slot]ᵀ  (f32 out)
// Tokens arrive pre-sorted into adapter-homogeneous blocks of blk_t rows
// (repro_torch/kernels/ops.py plan_grouping); block_slots[i] names the pool
// slot that owns block i. The padded buffer has the static bound's
// n_blocks = ceil(T / blk_t) + R blocks; only the first n_used of them hold
// tokens (the plan's n_used, an int32 on the device that the host never
// reads; null means every block, as on the TPU). The rest hold zero rows of
// x, so their rows of s and y are zero: both kernels store those zeros and
// read no weights for them. On the TPU a scalar-prefetched block_slots
// steered the weight DMA; here each CTA reads block_slots itself.
//
// The adapter pool is f32 (the serving pool's dtype) whatever the type of x:
// each weight is rounded to the activation type before its product -- the
// same numbers the reference gets by casting the whole pool to x.dtype
// first, without re-materialising the pool on every call.
//
// What bounds them on an H100: bytes. The LoRA rank r (4..64 in the
// configs; any r >= 1 is taken) makes both products thin: shrink does 2·r
// FLOPs per x element, expand 2·r per y element, far below the ~295
// FLOP/byte of the bf16 tensor cores. At decode
// (8 tokens) shrink's bytes are the f32 A rows of the used slots,
// r · d_in · 4 bytes each (512 KiB at r 32, d_in 4096), and expand's the
// f32 B rows of the used slots plus the f32 y rows of the whole padded
// buffer; a few MB, which the card moves in about as long as one chain of
// dependent round trips takes. So the design keeps many bytes in flight
// per SM and the chain short.
//
// Any rank and any blk_t. A block's [blk_t, r] tile of s is cut into
// units: n_sub row slices of sub_t <= kSubBlk rows (blk_t itself up to 128;
// a block of k·128 rows is k slices of 128 with the block's slot) times
// n_rc rank chunks of up to kRankChunk ranks (r itself up to 64). A unit is
// what the kernels were built for (16 token tiles of 8, 4 rank tiles of
// 16). Both kernels derive the units on the device from (blk_t, r); at
// blk_t <= 128 and r <= 64 a block is one unit, as before.
//
// sgmv_shrink (one launch):
//  1. The grid is as many CTAs as the card holds at once (sgmv_shrink_ctas:
//     occupancy x SMs, 2 x 132 at the main path's shapes). Each CTA reads
//     n_used and block_slots in one round trip and derives its work: a used
//     block's d_in is cut into kt tiles of kKC columns, the tiles into
//     S = clamp(G / (n_used · units), 1, kt) contiguous splits, and CTA g
//     takes items g, g + G, ... of the n_used · units · S (unit = item / S,
//     split = item % S; block = unit / units a block). So the card's CTAs spread
//     over the blocks that really hold tokens (up to 8 at decode) and not
//     over the static bound (21). Every CTA also stores a share of the zero
//     rows of the blocks past n_used.
//  2. A ring of up to 4 stages of kKC columns (A rows in f32, x rows in x's
//     type, rows padded so fragment reads are free of bank conflicts),
//     filled by 16-byte cp.async from every thread; an mbarrier per stage
//     counts each thread's copies in (cp.async.mbarrier.arrive.noinc), so
//     all of a split's tiles that fit are in flight before the first product
//     and a stage is refilled only after every warp is done with it. Ragged
//     d_in edges are zero-filled by the copies; rows that are not 16-byte
//     aligned are loaded element by element.
//  3. bf16 x: the products run on the tensor cores, mma.sync m16n8k16, bf16
//     in, f32 accumulate, the rank on M (16-row tiles) and the block's
//     tokens on N (8-token tiles: blk_t 8 at decode is one tile). A is
//     rounded to bf16 as its fragments are read out of shared memory.
//     Products of bf16 values are exact in f32, so only the order of the
//     sum differs from the plain version. f32 x: the same fragment layout on
//     CUDA-core FMAs (explicit dispatch on x's type), float4 shared loads.
//     The rank tiles and the token tiles per warp are template parameters,
//     so the k-step loop has no run-time guards (with them every mma was
//     predicated behind a convergence barrier, which cost more than the
//     products).
//  4. The 4 warps split the tile's token tiles (wn) and its 16-column
//     k-steps (wk); their partial sums meet in shared memory, in warp
//     order. With S > 1 each split writes its unit's partial to scratch
//     and counts itself in arrived[unit] with a release/acquire atomic;
//     the last split to arrive sums the S partials in split order (all L2
//     reads of a batch in flight) and resets the counter. No second launch,
//     no float atomics: two calls give bit-equal outputs.
//
// sgmv_expand: grid (n_blocks · n_sub, ceil(d_out / kExpandDT)). Each CTA
// reads its block's slot beside n_used; a CTA of a block past n_used stores
// its zero tile and exits. Any other CTA issues its kExpandDT columns of B (a
// contiguous kExpandDT x r f32 run of the pool) and its rows of s as 16-byte
// cp.async, all in flight at once, rounds B to the compute type once in
// shared memory, and computes sub_t x kExpandDT outputs in passes of 4·TM
// tokens: each thread keeps a TM x kExpandCJ register tile (one float4 of s
// feeds 4·kExpandCJ FMAs), in f32 in rank order, as the plain version
// multiplies. Rows go out through shared memory as 16-byte stores. A rank
// above kExpandOneShot walks the contraction in chunks of kRankChunk ranks
// through two shared-memory buffers (the next chunk loads while this one
// computes); between chunks each thread parks its register tile in shared
// memory and takes it up again, so every output is still one f32 sum in
// rank order.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/sgmv.py). Each entry
// point launches on the caller's stream and returns a CUDA error code.

#include <type_traits>

#include "attention.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKC = 128;           // d_in columns per shrink stage
constexpr int kKSteps = kKC / 16;  // mma k-steps per stage
constexpr int kLdA = kKC + 8;      // f32 A row stride in shared memory: 544 B
constexpr int kRankChunk = 64;     // ranks a unit: 4 rank tiles of 16
constexpr int kSubBlk = 128;       // rows a unit: 16 token tiles of 8, at most 4 a warp
constexpr int kMaxStages = 4;      // ring depth
constexpr int kRingBudget = 112 * 1024;  // two CTAs share an SM's 228 KiB
constexpr int kMaxSmem = 232448;   // what one CTA may have (227 KiB)
constexpr int kMergeBatch = 16;    // partials whose L2 reads are issued together
constexpr int kExpandDT = 64;      // d_out columns per expand CTA
constexpr int kExpandCJ = kExpandDT / 32;  // ... per lane
constexpr int kExpandOneShot = 128;  // expand ranks (padded to 4) taken in one chunk

enum DType { kF32 = 0, kBF16 = 1 };

// x's row stride in shared memory, in elements: 272 B for bf16 (the B
// fragments' 32-bit reads hit 32 distinct banks), 528 B for f32 (the
// float4 reads of a quarter warp hit distinct 16-byte bank groups)
template <typename T> struct XTile;
template <> struct XTile<__nv_bfloat16> { static constexpr int kLd = kKC + 8; };
template <> struct XTile<float> { static constexpr int kLd = kKC + 4; };

// Round a weight to bf16, kept in f32.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A block's units (see the note at the top): n_sub row slices of sub_t rows
// (the last one ragged), n_rc rank chunks of rcw ranks (the last one ragged).
struct Units {
  int n_sub, sub_t, n_rc, rcw;
};

__host__ __device__ inline Units units_of(int blk_t, int r) {
  Units u;
  u.n_sub = (blk_t + kSubBlk - 1) / kSubBlk;
  u.sub_t = u.n_sub == 1 ? blk_t : (blk_t + u.n_sub - 1) / u.n_sub;
  u.n_rc = (r + kRankChunk - 1) / kRankChunk;
  u.rcw = r < kRankChunk ? r : kRankChunk;
  return u;
}

// How a shrink CTA's 4 warps cover a unit's [rcw, sub_t] tile of s: mt rank tiles of
// 16, nt token tiles of 8; wn warps across the token tiles, ntw tiles each
// (a power of two; tiles past nt read rows that are never stored), wk warps
// across the k-steps of a stage.
struct ShrinkShape {
  int mt, nt, wn, wk, ntw, r_pad, x_rows;
};

// the shape of a unit of sub_t rows and rcw ranks
__host__ __device__ inline ShrinkShape unit_shape(int sub_t, int rcw) {
  ShrinkShape s;
  s.mt = (rcw + 15) / 16;
  s.nt = (sub_t + 7) / 8;
  s.wn = s.nt >= 3 ? 4 : s.nt;
  s.wk = kWarps / s.wn;
  s.ntw = s.nt <= 4 ? 1 : (s.nt <= 8 ? 2 : 4);
  s.r_pad = 16 * s.mt;
  s.x_rows = 8 * s.wn * s.ntw;
  return s;
}

__host__ __device__ inline ShrinkShape shrink_shape(int blk_t, int r) {
  const Units u = units_of(blk_t, r);
  return unit_shape(u.sub_t, u.rcw);
}

// one ring stage: r_pad rows of A in f32, then x_rows rows of x
__host__ __device__ inline int shrink_a_bytes(const ShrinkShape& s) { return s.r_pad * kLdA * 4; }

template <typename T> __host__ __device__ inline int shrink_stage_bytes(const ShrinkShape& s) {
  return shrink_a_bytes(s) + s.x_rows * XTile<T>::kLd * static_cast<int>(sizeof(T));
}

// the warps' partial sums, [wk][x_rows][r_pad + 1] f32, after the ring
__host__ __device__ inline int shrink_red_bytes(const ShrinkShape& s) {
  return s.wk * s.x_rows * (s.r_pad + 1) * 4;
}

// ---- shrink ---------------------------------------------------------------

// Shared-memory barriers, one per ring stage, expecting one arrival per
// thread per fill; the k-th fill of a stage completes its phase k, of
// parity k & 1.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(attn::smem_addr(bar)), "r"(count)
               : "memory");
}

// this thread's arrival, once its cp.async copies issued so far have landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   attn::smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(attn::smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(attn::smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copy columns [k0, k0 + kKC) of `rows` rows (row i at src + i * ld_src) to
// dst + i * ld_dst, zero past kmax: 16-byte cp.async when the rows are
// 16-byte aligned (vec; kmax is then a whole number of chunks), else element
// by element.
template <typename E>
__device__ __forceinline__ void load_rows(E* dst, int ld_dst, const E* __restrict__ src,
                                          int64_t ld_src, int rows, int k0, int kmax, bool vec) {
  constexpr int kVec = 16 / sizeof(E);
  constexpr int kChunks = kKC / kVec;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int row = c / kChunks;
    const int kc = (c % kChunks) * kVec;
    const int k = k0 + kc;
    E* d = dst + row * ld_dst + kc;
    const E* s = src + row * ld_src + k;
    if (vec) {
      attn::cp_async16(d, k < kmax ? s : src, k < kmax ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) d[e] = k + e < kmax ? s[e] : E();
    }
  }
}

// One stage's products, bf16 x: acc[m][n] += A[m-tile] · x[n-tile]ᵀ over
// this warp's k-steps, on the tensor cores. A is rounded to bf16 as its
// fragments are read.
template <int MT, int NTW>
__device__ __forceinline__ void shrink_products(float (&acc)[MT][NTW][4], const float* as,
                                                const __nv_bfloat16* xs, int tile0, int wk,
                                                int wk_n, int g, int q) {
  constexpr int kLdX = XTile<__nv_bfloat16>::kLd;
  for (int ks = wk; ks < kKSteps; ks += wk_n) {
    const int kb = ks * 16 + 2 * q;
    uint32_t bf[NTW][2];
#pragma unroll
    for (int n = 0; n < NTW; ++n) {
      const __nv_bfloat16* xr = xs + ((tile0 + n) * 8 + g) * kLdX + kb;
      bf[n][0] = *reinterpret_cast<const uint32_t*>(xr);
      bf[n][1] = *reinterpret_cast<const uint32_t*>(xr + 8);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* ar = as + (m * 16 + g) * kLdA + kb;
      const float2 v0 = *reinterpret_cast<const float2*>(ar);
      const float2 v1 = *reinterpret_cast<const float2*>(ar + 8 * kLdA);
      const float2 v2 = *reinterpret_cast<const float2*>(ar + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(ar + 8 * kLdA + 8);
      const uint32_t af[4] = {attn::pack_bf16(v0.x, v0.y), attn::pack_bf16(v1.x, v1.y),
                              attn::pack_bf16(v2.x, v2.y), attn::pack_bf16(v3.x, v3.y)};
#pragma unroll
      for (int n = 0; n < NTW; ++n) attn::mma_bf16(acc[m][n], af, bf[n][0], bf[n][1]);
    }
  }
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// The same for f32 x on CUDA cores, in the mma fragment layout: thread
// (g, q) owns ranks g, g + 8 of each rank tile and tokens 2q, 2q + 1 of
// each token tile.
template <int MT, int NTW>
__device__ __forceinline__ void shrink_products(float (&acc)[MT][NTW][4], const float* as,
                                                const float* xs, int tile0, int wk, int wk_n,
                                                int g, int q) {
  constexpr int kLdX = XTile<float>::kLd;
  for (int ks = wk; ks < kKSteps; ks += wk_n) {
#pragma unroll
    for (int kq = 0; kq < 16; kq += 4) {
      const int k = ks * 16 + kq;
      float4 xv[NTW][2];
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const float* xr = xs + ((tile0 + n) * 8 + 2 * q) * kLdX + k;
        xv[n][0] = *reinterpret_cast<const float4*>(xr);
        xv[n][1] = *reinterpret_cast<const float4*>(xr + kLdX);
      }
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        const float* ar = as + (m * 16 + g) * kLdA + k;
        const float4 a0 = *reinterpret_cast<const float4*>(ar);
        const float4 a1 = *reinterpret_cast<const float4*>(ar + 8 * kLdA);
#pragma unroll
        for (int n = 0; n < NTW; ++n) {
          acc[m][n][0] = dot4(a0, xv[n][0], acc[m][n][0]);
          acc[m][n][1] = dot4(a0, xv[n][1], acc[m][n][1]);
          acc[m][n][2] = dot4(a1, xv[n][0], acc[m][n][2]);
          acc[m][n][3] = dot4(a1, xv[n][1], acc[m][n][3]);
        }
      }
    }
  }
}

// atomicAdd with release and acquire semantics at device scope
__device__ __forceinline__ int atomic_add_acq_rel(int* p, int v) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], %2;\n"
               : "=r"(old)
               : "l"(p), "r"(v)
               : "memory");
  return old;
}

__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// out = the sum of the splits' partials, j in order: a [rows, cols] tile,
// partial j at part + j · pstride (contiguous rows of cols), out row i at
// out + i · ld; in vectors V (float4 where the widths allow). When the tile
// has fewer vectors than the CTA threads, p_n threads share a vector:
// thread p sums the splits j = p, p + p_n, ... in order and the p_n sums
// are added in p order through `scratch`. A fixed order either way: two
// calls give bit-equal outputs. Every load of a batch is issued before the
// first add.
template <typename V>
__device__ __forceinline__ void merge_splits(const float* part, int pstride, float* out, int rows,
                                             int cols, int ld, int splits, V* scratch) {
  constexpr int kW = sizeof(V) / sizeof(float);
  const int nv = rows * cols / kW;
  const int pnv = pstride / kW;
  const int p_n = nv >= kThreads ? 1 : kThreads / nv;
  const V* pv = reinterpret_cast<const V*>(part);
  // vector c's element offset in out: rows are contiguous when cols == ld
  auto out_at = [&](int c) -> V* {
    const int e = c * kW;
    return reinterpret_cast<V*>(out + (cols == ld ? e : (e / cols) * ld + e % cols));
  };
  const int tid = threadIdx.x;
  const int p = p_n > 1 ? tid / nv : 0;
  for (int c = p_n > 1 ? tid % nv : tid; c < nv && p < p_n; c += p_n > 1 ? nv : kThreads) {
    V acc{};
    for (int j0 = p; j0 < splits; j0 += kMergeBatch * p_n) {
      V v[kMergeBatch];
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u) {
        const int j = j0 + u * p_n;
        if (j < splits) v[u] = __ldcg(pv + static_cast<int64_t>(j) * pnv + c);
      }
#pragma unroll
      for (int u = 0; u < kMergeBatch; ++u)
        if (j0 + u * p_n < splits) acc = add(acc, v[u]);
    }
    if (p_n == 1) {
      *out_at(c) = acc;
    } else {
      scratch[p * nv + c] = acc;
    }
  }
  if (p_n == 1) return;
  __syncthreads();
  for (int c = tid; c < nv; c += kThreads) {
    V acc = scratch[c];
    for (int i = 1; i < p_n; ++i) acc = add(acc, scratch[i * nv + c]);
    *out_at(c) = acc;
  }
}

// grid G (sgmv_shrink_ctas), 128 threads, nst ring stages; see the note at
// the top. Rows of the ring past a unit's ranks and rows are never loaded:
// they only feed rank rows and token columns of the products that are not
// stored. UNITS: a block is more than one unit (r > 64 or blk_t > 128);
// without it the unit is the block, in the main path's code.
template <typename T, int MT, int NTW, bool UNITS>
__global__ void __launch_bounds__(kThreads)
sgmv_shrink_kernel(const T* __restrict__ x, const float* __restrict__ a,
                   const int* __restrict__ block_slots, const int* __restrict__ n_used_p,
                   float* __restrict__ out, float* __restrict__ part, int* __restrict__ arrived,
                   int n_blocks, int blk_t, int d_in, int r, int n_slots, int nst, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  __shared__ int slots_s[kThreads];
  __shared__ int used_s, is_last;
  constexpr int kLdX = XTile<T>::kLd;
  const ShrinkShape sh = UNITS ? shrink_shape(blk_t, r) : unit_shape(blk_t, r);
  const Units un = UNITS ? units_of(blk_t, r) : Units{1, blk_t, 1, r};
  const int a_bytes = shrink_a_bytes(sh);
  const int stage_bytes = shrink_stage_bytes<T>(sh);
  float* red = reinterpret_cast<float*>(smem + nst * stage_bytes);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const int wn = warp % sh.wn, wk = warp / sh.wn;

  // n_used and the first block slots in one round trip
  if (tid == 0) {
    used_s = n_used_p ? min(max(*n_used_p, 0), n_blocks) : n_blocks;
    for (int st = 0; st < kMaxStages; ++st) mbar_init(&bars[st], kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < n_blocks) slots_s[tid] = block_slots[tid];
  __syncthreads();
  const int used = used_s;
  const int grid = gridDim.x;
  const int kt = (d_in + kKC - 1) / kKC;
  const int per_blk = un.n_sub * un.n_rc;  // units a block
  const int units = used * per_blk;
  const int splits = units > 0 ? max(1, min(grid / units, kt)) : 1;
  const int items = units * splits;
  const int n_out = blk_t * r;
  const int pstride = un.sub_t * un.rcw;  // a partial's floats

  // the blocks past n_used: zero rows of x, zero rows of s
  for (int64_t e = static_cast<int64_t>(used) * n_out + static_cast<int64_t>(blockIdx.x) * kThreads + tid;
       e < static_cast<int64_t>(n_blocks) * n_out; e += static_cast<int64_t>(grid) * kThreads)
    out[e] = 0.f;

  int uses = 0;  // fills of the ring so far: fill u goes to stage u % nst
  for (int item = blockIdx.x; item < items; item += grid) {
    const int unit = item / splits;
    const int split = item % splits;
    // the unit's block, first row and rank, rows and ranks
    int blk = unit, t0 = 0, r0 = 0, nt = blk_t, nr = r;
    if constexpr (UNITS) {
      blk = unit / per_blk;
      t0 = unit % per_blk / un.n_rc * un.sub_t;
      r0 = unit % per_blk % un.n_rc * kRankChunk;
      nt = min(un.sub_t, blk_t - t0);
      nr = min(kRankChunk, r - r0);
    }
    const int t_begin = static_cast<int>(static_cast<int64_t>(split) * kt / splits);
    const int n_tiles = static_cast<int>(static_cast<int64_t>(split + 1) * kt / splits) - t_begin;
    const int slot = blk < kThreads ? slots_s[blk] : block_slots[blk];
    if (slot < 0 || slot >= n_slots) __trap();
    const T* xb = x + (static_cast<int64_t>(blk) * blk_t + t0) * d_in;
    const float* ab = a + (static_cast<int64_t>(slot) * r + r0) * d_in;
    auto fill = [&](int tile) {
      const int st = (uses + tile) % nst;
      unsigned char* base = smem + st * stage_bytes;
      const int k0 = (t_begin + tile) * kKC;
      load_rows<float>(reinterpret_cast<float*>(base), kLdA, ab, d_in, nr, k0, d_in, vec);
      load_rows<T>(reinterpret_cast<T*>(base + a_bytes), kLdX, xb, d_in, nt, k0, d_in, vec);
      if (vec)
        mbar_arrive_cp_async(&bars[st]);
      else
        mbar_arrive(&bars[st]);
    };

    float acc[MT][NTW][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int n = 0; n < NTW; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    // up to nst tiles in flight; a stage is refilled once every warp is done
    // with it (never, when the split fits in the ring)
    for (int tile = 0; tile < nst && tile < n_tiles; ++tile) fill(tile);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = (uses + i) % nst;
      const unsigned char* base = smem + st * stage_bytes;
      mbar_wait(&bars[st], ((uses + i) / nst) & 1);
      shrink_products<MT, NTW>(acc, reinterpret_cast<const float*>(base),
                               reinterpret_cast<const T*>(base + a_bytes), wn * NTW, wk, sh.wk,
                               g, q);
      if (i + nst < n_tiles) {
        __syncthreads();
        fill(i + nst);
      }
    }
    uses += n_tiles;

    // the warps' partial sums meet in shared memory, in warp order
    const int rs = sh.r_pad + 1;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int n = 0; n < NTW; ++n) {
        const int tile = wn * NTW + n;
        if (tile < sh.nt) {
          float* rp = red + (wk * sh.x_rows + tile * 8 + 2 * q) * rs + m * 16 + g;
          rp[0] = acc[m][n][0];
          rp[rs] = acc[m][n][1];
          rp[8] = acc[m][n][2];
          rp[rs + 8] = acc[m][n][3];
        }
      }
    }
    __syncthreads();
    // the unit's [nt, nr] tile: into out (rows r apart), or contiguous into
    // its partial
    float* ob = out + (static_cast<int64_t>(blk) * blk_t + t0) * r + r0;
    float* dst = splits == 1 ? ob : part + static_cast<int64_t>(item) * pstride;
    const bool rows_apart = UNITS && splits == 1 && nr != r;  // a rank chunk of out
    for (int e = tid; e < nt * nr; e += kThreads) {
      const int tok = e / nr, rank = e % nr;
      float v = red[tok * rs + rank];
      for (int w = 1; w < sh.wk; ++w) v += red[(w * sh.x_rows + tok) * rs + rank];
      dst[rows_apart ? tok * r + rank : e] = v;
    }

    if (splits > 1) {
      // the last split of the unit to finish sums all of them, in order.
      // The barrier orders every thread's partial store before thread 0's
      // count, whose release publishes them and whose acquire, in the last
      // split, makes the other splits' partials visible to its loads (L2).
      __syncthreads();
      if (tid == 0) is_last = atomic_add_acq_rel(arrived + unit, 1) == splits - 1;
      __syncthreads();
      if (is_last) {
        const float* pb = part + static_cast<int64_t>(unit) * splits * pstride;
        // float4 where every vector lies in one row of out and is aligned
        const bool v4 = nr == r ? (blk_t * r) % 4 == 0 && (t0 * r) % 4 == 0 && (nt * r) % 4 == 0
                                : nr % 4 == 0 && r % 4 == 0;
        if (v4 && pstride % 4 == 0)
          merge_splits<float4>(pb, pstride, ob, nt, nr, r, splits, reinterpret_cast<float4*>(red));
        else
          merge_splits<float>(pb, pstride, ob, nt, nr, r, splits, red);
        if (tid == 0) arrived[unit] = 0;  // ready for the next call on this stream
      }
    }
    __syncthreads();  // before the next item reuses `red` and the ring
  }
}

// dst[0:4] = v, or its first `left` elements (0 < left < 4, or not vec)
__device__ __forceinline__ void store4(float* dst, float4 v, int left, bool vec) {
  if (left <= 0) return;
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  const float e[4] = {v.x, v.y, v.z, v.w};
  for (int i = 0; i < 4 && i < left; ++i) dst[i] = e[i];
}

// Row stride of the B tile in shared memory: r padded to 4, then by 4 or 8
// so that it is an odd number of 16-byte units (the float4 reads of rows
// lane, lane + 32, ... of a quarter warp hit distinct bank groups).
__host__ __device__ inline int expand_ldb(int r4) { return r4 + ((r4 / 4) % 2 == 0 ? 4 : 8); }

__host__ __device__ inline int expand_rows(int blk_t, int tm) {
  return (blk_t + 4 * tm - 1) / (4 * tm) * (4 * tm);
}

// Copy w columns of `rows` rows (row i at src + i * ld_src) to
// dst + i * ld_dst, zero-padded to w4: 16-byte cp.async when vec (w and
// ld_src multiples of 4, src aligned), else element by element.
__device__ __forceinline__ void load_rank_rows(float* dst, int ld_dst, const float* __restrict__ src,
                                               int ld_src, int w, int rows, int w4, bool vec) {
  const int chunks = w4 / 4;
  for (int c = threadIdx.x; c < rows * chunks; c += kThreads) {
    const int row = c / chunks, k = 4 * (c % chunks);
    float* d = dst + row * ld_dst + k;
    const float* s = src + static_cast<int64_t>(row) * ld_src + k;
    if (vec) {
      attn::cp_async16(d, s);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) d[e] = k + e < w ? s[e] : 0.f;
    }
  }
}

// The expand CTA's shared memory, in floats: nbuf buffers of (B columns
// [kExpandDT][ldb], s rows [rows][rc4]), the store stage [4·TM][kExpandDT],
// and with more than one rank chunk the parked register tiles
// [rows][kExpandDT].
struct ExpandSmem {
  int rc4, ldb, rows, n_ch, buf;
  size_t floats(int tm) const {
    return static_cast<size_t>(n_ch > 1 ? 2 : 1) * buf + static_cast<size_t>(4 * tm) * kExpandDT +
           (n_ch > 1 ? static_cast<size_t>(rows) * kExpandDT : 0);
  }
};

__host__ __device__ inline ExpandSmem expand_smem(int sub_t, int r, int rc, int tm) {
  ExpandSmem m;
  m.rc4 = (rc + 3) & ~3;
  m.ldb = expand_ldb(m.rc4);
  m.rows = expand_rows(sub_t, tm);
  m.n_ch = (r + rc - 1) / rc;
  m.buf = kExpandDT * m.ldb + m.rows * m.rc4;
  return m;
}

// grid (n_blocks · n_sub, ceil(d_out / kExpandDT)), 128 threads; see the
// note at the top. rc: ranks a chunk (r itself up to kExpandOneShot). Warp w
// computes tokens tp + w·TM .. + TM of each pass, lane l the columns l,
// l + 32, ... of the CTA's kExpandDT.
template <typename T, int TM>
__global__ void __launch_bounds__(kThreads)
sgmv_expand_kernel(const float* __restrict__ s, const float* __restrict__ b,
                   const int* __restrict__ block_slots, const int* __restrict__ n_used_p,
                   float* __restrict__ y, int n_blocks, int blk_t, int d_out, int r, int rc,
                   int n_slots, bool vec_in, bool vec_y) {
  extern __shared__ __align__(16) float fsmem[];
  const Units un = units_of(blk_t, r);
  int blk = blockIdx.x, t0 = 0, nt = blk_t;  // the CTA's block, first row, rows
  if (un.n_sub > 1) {
    blk = blockIdx.x / un.n_sub;
    t0 = blockIdx.x % un.n_sub * un.sub_t;
    nt = min(un.sub_t, blk_t - t0);
  }
  const int c0 = blockIdx.y * kExpandDT;
  const int ncols = min(kExpandDT, d_out - c0);
  const int tid = threadIdx.x;
  const int slot = block_slots[blk];  // read beside n_used: one round trip
  const int used = n_used_p ? min(max(*n_used_p, 0), n_blocks) : n_blocks;
  float* yb = y + (static_cast<int64_t>(blk) * blk_t + t0) * d_out + c0;
  if (blk >= used) {  // zero rows of s: store the zeros, read no weights
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int e = tid; e < nt * (kExpandDT / 4); e += kThreads) {
      const int t = e / (kExpandDT / 4), c = 4 * (e % (kExpandDT / 4));
      store4(yb + static_cast<int64_t>(t) * d_out + c, z, ncols - c, vec_y);
    }
    return;
  }
  if (slot < 0 || slot >= n_slots) __trap();
  const ExpandSmem sm = expand_smem(un.sub_t, r, rc, TM);
  float* ys = fsmem + (sm.n_ch > 1 ? 2 : 1) * sm.buf;  // [4·TM][kExpandDT]
  float* park = ys + 4 * TM * kExpandDT;                // [rows][kExpandDT]
  const float* bsrc = b + (static_cast<int64_t>(slot) * d_out + c0) * r;
  const float* ssrc = s + (static_cast<int64_t>(blk) * blk_t + t0) * r;

  // chunk ch's B columns and rows of s into buffer buf, every load in flight
  auto load = [&](int ch, int buf) {
    const int k0 = ch * rc;
    const int w = min(rc, r - k0);
    float* bs = fsmem + buf * sm.buf;
    load_rank_rows(bs, sm.ldb, bsrc + k0, r, w, ncols, (w + 3) & ~3, vec_in);
    load_rank_rows(bs + kExpandDT * sm.ldb, sm.rc4, ssrc + k0, r, w, nt, (w + 3) & ~3, vec_in);
    attn::cp_async_commit();
  };

  const int w = tid >> 5, lane = tid & 31;
  load(0, 0);
  for (int ch = 0; ch < sm.n_ch; ++ch) {
    if (ch + 1 < sm.n_ch) {  // the next chunk loads while this one computes
      load(ch + 1, (ch + 1) & 1);
      attn::cp_async_wait<1>();
    } else {
      attn::cp_async_wait<0>();
    }
    __syncthreads();
    float* bs = fsmem + (ch & 1) * sm.buf;
    const float* ss = bs + kExpandDT * sm.ldb;
    const int w4 = (min(rc, r - ch * rc) + 3) & ~3;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      for (int e = tid; e < ncols * sm.ldb; e += kThreads) bs[e] = round_bf16(bs[e]);
      __syncthreads();
    }
    const bool last = ch + 1 == sm.n_ch;
    for (int tp = 0; tp < nt; tp += 4 * TM) {
      float acc[TM][kExpandCJ];
      float* pk = park + (tp + w * TM) * kExpandDT + lane;
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kExpandCJ; ++j) acc[i][j] = ch ? pk[i * kExpandDT + 32 * j] : 0.f;
      const float* srow = ss + (tp + w * TM) * sm.rc4;
      for (int k = 0; k < w4; k += 4) {
        float4 bv[kExpandCJ];
#pragma unroll
        for (int j = 0; j < kExpandCJ; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + (lane + 32 * j) * sm.ldb + k);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float4 sv = *reinterpret_cast<const float4*>(srow + i * sm.rc4 + k);
#pragma unroll
          for (int j = 0; j < kExpandCJ; ++j) acc[i][j] = dot4(sv, bv[j], acc[i][j]);
        }
      }
      if (!last) {  // park the tile: this thread takes it up at the next chunk
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kExpandCJ; ++j) pk[i * kExpandDT + 32 * j] = acc[i][j];
        continue;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kExpandCJ; ++j)
          ys[(w * TM + i) * kExpandDT + lane + 32 * j] = acc[i][j];
      __syncthreads();
      const int rows = min(4 * TM, nt - tp);
      for (int e = tid; e < rows * (kExpandDT / 4); e += kThreads) {
        const int t = e / (kExpandDT / 4), c = 4 * (e % (kExpandDT / 4));
        store4(yb + static_cast<int64_t>(tp + t) * d_out + c,
               *reinterpret_cast<const float4*>(ys + t * kExpandDT + c), ncols - c, vec_y);
      }
      __syncthreads();
    }
    if (!last) __syncthreads();  // this buffer is free before chunk ch + 2 loads into it
  }
}

// ---- host side ----------------------------------------------------------

struct ShrinkPlan {
  int nst;
  size_t smem;
};

// The deepest ring (up to kMaxStages) that, with the warps' partials after
// it, stays within kRingBudget, or one stage; the merge reuses the
// partials' space.
template <typename T> ShrinkPlan shrink_plan(int blk_t, int r) {
  const ShrinkShape sh = shrink_shape(blk_t, r);
  const size_t stage = shrink_stage_bytes<T>(sh);
  const size_t red = shrink_red_bytes(sh);
  int nst = kMaxStages;
  while (nst > 1 && nst * stage + red > static_cast<size_t>(kRingBudget)) --nst;
  return {nst, nst * stage + red};
}

// The kernel for (T, rank tiles, token tiles per warp).
template <typename T> using ShrinkKernel = void (*)(const T*, const float*, const int*, const int*,
                                                    float*, float*, int*, int, int, int, int, int,
                                                    int, bool);

template <typename T, int MT, bool UNITS> ShrinkKernel<T> shrink_kernel_ntw(int ntw) {
  if (ntw == 1) return sgmv_shrink_kernel<T, MT, 1, UNITS>;
  if (ntw == 2) return sgmv_shrink_kernel<T, MT, 2, UNITS>;
  return sgmv_shrink_kernel<T, MT, 4, UNITS>;
}

// A block of more than one unit has 64-rank chunks (4 rank tiles) or
// row slices of 65..128 rows (9..16 token tiles, four a warp), so UNITS is
// built only for 4 rank tiles or 4 token tiles a warp.
template <typename T> ShrinkKernel<T> shrink_kernel(int blk_t, int r) {
  const ShrinkShape sh = shrink_shape(blk_t, r);
  const Units un = units_of(blk_t, r);
  if (un.n_sub * un.n_rc > 1) {
    if (sh.mt == 4) return shrink_kernel_ntw<T, 4, true>(sh.ntw);
    if (sh.mt == 1) return sgmv_shrink_kernel<T, 1, 4, true>;
    if (sh.mt == 2) return sgmv_shrink_kernel<T, 2, 4, true>;
    return sgmv_shrink_kernel<T, 3, 4, true>;
  }
  if (sh.mt == 1) return shrink_kernel_ntw<T, 1, false>(sh.ntw);
  if (sh.mt == 2) return shrink_kernel_ntw<T, 2, false>(sh.ntw);
  if (sh.mt == 3) return shrink_kernel_ntw<T, 3, false>(sh.ntw);
  return shrink_kernel_ntw<T, 4, false>(sh.ntw);
}

template <typename T> cudaError_t shrink_ctas(int blk_t, int r, int* ctas) {
  const ShrinkPlan p = shrink_plan<T>(blk_t, r);
  const ShrinkKernel<T> kernel = shrink_kernel<T>(blk_t, r);
  cudaError_t err = attn::allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, p.smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && per_sm < 1) err = cudaErrorInvalidConfiguration;
  *ctas = per_sm * sms;
  return err;
}

template <typename T>
cudaError_t launch_shrink(const void* x, const float* a, const int* slots, const int* n_used,
                          float* out, float* part, int* arrived, int n_blocks, int blk_t,
                          int d_in, int r, int n_slots, int grid, cudaStream_t stream) {
  const ShrinkPlan p = shrink_plan<T>(blk_t, r);
  if (p.smem > static_cast<size_t>(kMaxSmem)) return cudaErrorInvalidValue;
  const ShrinkKernel<T> kernel = shrink_kernel<T>(blk_t, r);
  cudaError_t err = attn::allow_smem(kernel, p.smem);
  if (err != cudaSuccess) return err;
  // 16-byte copies take 16-byte aligned rows of A (f32) and x
  const bool vec = d_in % (16 / sizeof(T)) == 0 && d_in % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a) % 16 == 0;
  kernel<<<grid, kThreads, p.smem, stream>>>(static_cast<const T*>(x), a, slots, n_used, out,
                                             part, arrived, n_blocks, blk_t, d_in, r, n_slots,
                                             p.nst, vec);
  return cudaGetLastError();
}

template <typename T, int TM>
cudaError_t launch_expand_tm(const float* s, const float* b, const int* slots, const int* n_used,
                             float* y, int n_blocks, int blk_t, int d_out, int r, int n_slots,
                             cudaStream_t stream) {
  const Units un = units_of(blk_t, r);
  // one chunk of every rank up to kExpandOneShot, chunks of kRankChunk above
  const int rc = ((r + 3) & ~3) <= kExpandOneShot ? r : kRankChunk;
  const size_t smem = expand_smem(un.sub_t, r, rc, TM).floats(TM) * sizeof(float);
  auto kernel = sgmv_expand_kernel<T, TM>;
  cudaError_t err = attn::allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const bool vec_in = r % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const bool vec_y = d_out % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const dim3 grid(n_blocks * un.n_sub, (d_out + kExpandDT - 1) / kExpandDT);
  kernel<<<grid, kThreads, smem, stream>>>(s, b, slots, n_used, y, n_blocks, blk_t, d_out, r, rc,
                                           n_slots, vec_in, vec_y);
  return cudaGetLastError();
}

// the register tile's tokens by the rows a CTA takes
template <typename T>
cudaError_t launch_expand(const float* s, const float* b, const int* slots, const int* n_used,
                          float* y, int n_blocks, int blk_t, int d_out, int r, int n_slots,
                          cudaStream_t stream) {
  const int sub_t = units_of(blk_t, r).sub_t;
  if (sub_t <= 8)
    return launch_expand_tm<T, 2>(s, b, slots, n_used, y, n_blocks, blk_t, d_out, r, n_slots,
                                  stream);
  if (sub_t <= 16)
    return launch_expand_tm<T, 4>(s, b, slots, n_used, y, n_blocks, blk_t, d_out, r, n_slots,
                                  stream);
  return launch_expand_tm<T, 8>(s, b, slots, n_used, y, n_blocks, blk_t, d_out, r, n_slots,
                                stream);
}

// what the kernels index: rows, units and every output offset in range
bool shape_ok(int n_blocks, int blk_t, int r) {
  return n_blocks >= 1 && blk_t >= 1 && r >= 1 &&
         static_cast<int64_t>(blk_t) * r <= INT32_MAX &&
         static_cast<int64_t>(n_blocks) * units_of(blk_t, r).n_sub <= INT32_MAX;
}

}  // namespace

extern "C" {

// Constants the Python wrapper mirrors (sgmv.shrink_work, sgmv.units) and
// checks when it binds the library.
int sgmv_shrink_tile() { return kKC; }
int sgmv_rank_chunk() { return kRankChunk; }
int sgmv_sub_blk_t() { return kSubBlk; }

// The shrink grid for (blk_t, r, x_dtype): as many CTAs as the card holds
// at once of the kernel (blk_t, r) takes. Returns it (> 0), or minus a CUDA
// error code.
int sgmv_shrink_ctas(int blk_t, int r, int x_dtype) {
  if (!shape_ok(1, blk_t, r)) return -static_cast<int>(cudaErrorInvalidValue);
  int ctas = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (x_dtype == kF32) err = shrink_ctas<float>(blk_t, r, &ctas);
  if (x_dtype == kBF16) err = shrink_ctas<__nv_bfloat16>(blk_t, r, &ctas);
  return err == cudaSuccess ? ctas : -static_cast<int>(err);
}

// x: [n_blocks·blk_t, d_in] (x_dtype); a: [n_slots, r, d_in] f32;
// block_slots: [n_blocks] int32; n_used: one int32 (null: n_blocks);
// out: [n_blocks·blk_t, r] f32; part: [grid·sub_t·rcw] f32 scratch (a
// unit's rows and ranks); arrived: [n_blocks·n_sub·n_rc] int32 (one a
// unit), zero before and after the call; grid from
// sgmv_shrink_ctas. x_dtype is also the type weights are rounded to.
// dtype codes: 0 f32, 1 bf16.
int sgmv_shrink_launch(const void* x, const void* a, const void* block_slots, const void* n_used,
                       void* out, void* part, void* arrived, int n_blocks, int blk_t, int d_in,
                       int r, int n_slots, int grid, int x_dtype, void* stream) {
  if (!shape_ok(n_blocks, blk_t, r) || d_in < 1 || grid < 1) return cudaErrorInvalidValue;
  const float* ap = static_cast<const float*>(a);
  const int* slots = static_cast<const int*>(block_slots);
  const int* nu = static_cast<const int*>(n_used);
  float* o = static_cast<float*>(out);
  float* p = static_cast<float*>(part);
  int* ar = static_cast<int*>(arrived);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_dtype == kF32)
    return launch_shrink<float>(x, ap, slots, nu, o, p, ar, n_blocks, blk_t, d_in, r, n_slots,
                                grid, st);
  if (x_dtype == kBF16)
    return launch_shrink<__nv_bfloat16>(x, ap, slots, nu, o, p, ar, n_blocks, blk_t, d_in, r,
                                        n_slots, grid, st);
  return cudaErrorInvalidValue;
}

// s: [n_blocks·blk_t, r] f32; b: [n_slots, d_out, r] f32;
// block_slots: [n_blocks] int32; n_used: one int32 (null: n_blocks);
// y: [n_blocks·blk_t, d_out] f32. round_dtype: the type weights are
// rounded to before the f32 product.
int sgmv_expand_launch(const void* s, const void* b, const void* block_slots, const void* n_used,
                       void* y, int n_blocks, int blk_t, int d_out, int r, int n_slots,
                       int round_dtype, void* stream) {
  if (!shape_ok(n_blocks, blk_t, r) || d_out < 1) return cudaErrorInvalidValue;
  const float* sp = static_cast<const float*>(s);
  const float* bp = static_cast<const float*>(b);
  const int* slots = static_cast<const int*>(block_slots);
  const int* nu = static_cast<const int*>(n_used);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (round_dtype == kF32)
    return launch_expand<float>(sp, bp, slots, nu, yp, n_blocks, blk_t, d_out, r, n_slots, st);
  if (round_dtype == kBF16)
    return launch_expand<__nv_bfloat16>(sp, bp, slots, nu, yp, n_blocks, blk_t, d_out, r,
                                        n_slots, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"
