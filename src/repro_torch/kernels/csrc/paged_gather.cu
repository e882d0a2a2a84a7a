// Paged-KV page gather for Hopper: copy each sequence's KV pages, named by
// its block table, out of the shared page arena into one contiguous run.
//
// Replaces the Pallas TPU kernel paged_gather_pages in
// src/repro/kernels/paged_gather.py, which does no work in its body: a
// scalar-prefetched block table feeds the BlockSpec index_map, so the DMA
// engine itself picks the physical page for every (g, b, j) grid step.
//
//   arena  [ng, n_pages, bs, F]  any element type (copied as bytes)
//   tables [B, MB] int32          physical page per logical block, -1 pad
//   out    [ng, B, MB, bs, F]     out[g, b, j] = arena[g, tables[b, j] mod n_pages]
//
// The page index is a floor modulo, ((t % n) + n) % n, as JAX's % is: -1
// (table padding, idle rows) reads the last page, which the serving arena
// reserves as its trash page, and an entry >= n_pages wraps. C's % would
// give -1. Output page p is (g, e) = (p / (B·MB), p % (B·MB)): e indexes
// the [B, MB] table as one run.
//
// What bounds it on an H100: bytes. It moves every gathered byte once in
// and once out and does no arithmetic, so its floor is one read of each
// distinct page plus one write of the output at 3.35 TB/s. The kernel sees
// the output as one flat run of V-byte vectors (V = 16, 8, 4, 2 or 1: the
// widest that divides the page size and both pointers; the wrapper's
// vec_bytes picks it) and crosses page boundaries freely. A block is
// kUnroll·kThreads vectors (16 KiB at V = 16), one CTA each: thread t
// copies vectors t, t + kThreads, ... of its block (kUnroll loads in
// flight, then the stores), and each vector reads its own page's table
// entry (L1 serves the repeats). So a warp covers several of the int8
// cache's 256-byte scale pages and no thread idles, and a large page is
// spread over several CTAs. A thread splits its first vector's index into
// (group, table entry, offset) once, in 32 bits where the output allows,
// and walks the rest by adds alone.
//
// Designs measured on an H100 and not kept (PERF.md): one 256-thread CTA
// per page (the first port) left 240 of 256 threads idle at the 256-byte
// pages and was bounded by the block scheduler there (5x slower); a
// persistent grid of a few CTAs per SM walking the blocks lost 5-7 % at
// the long gathers; and Hopper's bulk copies (cp.async.bulk through a
// shared-memory ring on an mbarrier) were 0.5-2 % slower than this loop at
// 32-80 KiB pages and slower still below.
//
// Byte offsets are 64-bit (one gemma2-9b K leaf's arena is ~3.2 GB); a
// page holds at most 1 GiB, an output at most 2^31 - 1 pages and blocks.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/paged_gather.py). The
// entry point launches on the caller's stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kBlockVecs = static_cast<int64_t>(kUnroll) * kThreads;

__device__ __forceinline__ int page_of(const int* __restrict__ tables, int e, int n_pages) {
  int t = __ldg(tables + e);
  if (static_cast<unsigned>(t) >= static_cast<unsigned>(n_pages)) {
    t %= n_pages;  // floor modulo: -1 -> the trash page n_pages - 1
    if (t < 0) t += n_pages;
  }
  return t;
}

// A vector's place in the output: its page's group g and table entry e,
// and its offset within the page (in vectors).
struct Pos {
  int off, g, e;
};

__device__ __forceinline__ Pos split(int64_t n, int page_vecs, int bmb) {
  if (n <= 0xffffffffLL) {
    const uint32_t m = static_cast<uint32_t>(n);
    const uint32_t page = m / static_cast<uint32_t>(page_vecs);
    const uint32_t g = page / static_cast<uint32_t>(bmb);
    return {static_cast<int>(m - page * page_vecs), static_cast<int>(g),
            static_cast<int>(page - g * bmb)};
  }
  const int64_t page = n / page_vecs;
  const int64_t g = page / bmb;
  return {static_cast<int>(n - page * page_vecs), static_cast<int>(g),
          static_cast<int>(page - g * bmb)};
}

// p += d, both split as above (d.off < page_vecs, d.e < bmb)
__device__ __forceinline__ void advance(Pos& p, const Pos& d, int page_vecs, int bmb) {
  p.off += d.off;
  if (p.off >= page_vecs) {
    p.off -= page_vecs;
    ++p.e;
  }
  p.e += d.e;
  if (p.e >= bmb) {
    p.e -= bmb;
    ++p.g;
  }
  p.g += d.g;
}

// Vector v (of total_vecs) is byte range [v·V, v·V + V) of the output.
// Block b is vectors [b·kBlockVecs, (b + 1)·kBlockVecs).
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ arena, const int* __restrict__ tables, V* __restrict__ out,
              int n_pages, int bmb, int page_vecs, int64_t total_vecs) {
  const int64_t v = blockIdx.x * kBlockVecs + threadIdx.x;
  if (v >= total_vecs) return;
  Pos p = split(v, page_vecs, bmb);
  const Pos step = split(kThreads, page_vecs, bmb);
  const int64_t group_vecs = static_cast<int64_t>(n_pages) * page_vecs;
  V val[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    if (v + u * kThreads < total_vecs)
      val[u] = arena[p.g * group_vecs +
                     static_cast<int64_t>(page_of(tables, p.e, n_pages)) * page_vecs + p.off];
    if (u + 1 < kUnroll) advance(p, step, page_vecs, bmb);
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (v + u * kThreads < total_vecs) out[v + u * kThreads] = val[u];
}

template <typename V>
cudaError_t launch(const void* arena, const int* tables, void* out, int n_pages, int bmb,
                   int64_t page_bytes, int64_t n_out_pages, cudaStream_t stream) {
  const int page_vecs = static_cast<int>(page_bytes / static_cast<int64_t>(sizeof(V)));
  const int64_t total_vecs = page_vecs * n_out_pages;
  const int64_t grid = (total_vecs + kBlockVecs - 1) / kBlockVecs;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  gather_kernel<V><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      static_cast<const V*>(arena), tables, static_cast<V*>(out), n_pages, bmb, page_vecs,
      total_vecs);
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t width) {
  return reinterpret_cast<uintptr_t>(p) % width == 0;
}

}  // namespace

extern "C" {

// arena: [ng, n_pages, page_bytes] bytes; tables: [b, mb] int32;
// out: [ng, b, mb, page_bytes] bytes. page_bytes = bs · F · element size.
// vec_bytes: the vector width (vec_bytes in paged_gather.py); the grid is
// one CTA per block of kUnroll · kThreads vectors. Returns
// cudaErrorInvalidValue for a width the pointers or the page size do not
// allow.
int paged_gather_launch(const void* arena, const void* tables, void* out, int ng, int n_pages,
                        int b, int mb, long long page_bytes, int vec_bytes, void* stream) {
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t pb = page_bytes;
  const int64_t bmb = static_cast<int64_t>(b) * mb;
  const int64_t n = ng * bmb;
  if (ng <= 0 || n_pages <= 0 || b <= 0 || mb <= 0 || pb <= 0 || n > 0x7fffffffLL ||
      pb > (1LL << 30) || vec_bytes <= 0 || pb % vec_bytes || !aligned(arena, vec_bytes) ||
      !aligned(out, vec_bytes))
    return cudaErrorInvalidValue;
  const int bm = static_cast<int>(bmb);
  switch (vec_bytes) {
    case 16: return launch<uint4>(arena, tb, out, n_pages, bm, pb, n, st);
    case 8: return launch<uint2>(arena, tb, out, n_pages, bm, pb, n, st);
    case 4: return launch<uint32_t>(arena, tb, out, n_pages, bm, pb, n, st);
    case 2: return launch<uint16_t>(arena, tb, out, n_pages, bm, pb, n, st);
    case 1: return launch<uint8_t>(arena, tb, out, n_pages, bm, pb, n, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
