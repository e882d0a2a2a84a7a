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
// reserves as its trash page. C's % would give -1.
//
// What bounds it on an H100: bytes. It moves every gathered byte once in
// and once out and does no arithmetic. One CTA copies one whole page
// (bs·F contiguous elements, 32 KiB for a bf16 Llama-3.1-8B page) with
// 16-byte vector loads and stores, neighbouring threads on neighbouring
// addresses, a few loads in flight per thread; the only address math is
// one table read per CTA. Narrower vectors are used only when the page
// size or a pointer is not 16-byte aligned.
//
// Plain C interface, built with nvcc and bound with ctypes
// (repro_torch/kernels/_build.py, repro_torch/kernels/paged_gather.py). The
// entry point launches on the caller's stream and returns cudaGetLastError().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

template <typename V>
__global__ void __launch_bounds__(kThreads)
paged_gather_kernel(const V* __restrict__ arena, const int* __restrict__ tables,
                    V* __restrict__ out, int n_pages, int b, int mb,
                    int64_t page_vecs) {
  // blockIdx.x enumerates (g, i, j) with j fastest: the output page order
  const int64_t page = blockIdx.x;
  const int j = static_cast<int>(page % mb);
  const int i = static_cast<int>((page / mb) % b);
  const int64_t g = page / (static_cast<int64_t>(mb) * b);
  int t = tables[static_cast<int64_t>(i) * mb + j] % n_pages;
  if (t < 0) t += n_pages;  // floor modulo: -1 -> the trash page n_pages-1
  const V* src = arena + (g * n_pages + t) * page_vecs;
  V* dst = out + page * page_vecs;
  for (int64_t k0 = threadIdx.x; k0 < page_vecs; k0 += kThreads * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = k0 + static_cast<int64_t>(u) * kThreads;
      if (k < page_vecs) v[u] = src[k];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t k = k0 + static_cast<int64_t>(u) * kThreads;
      if (k < page_vecs) dst[k] = v[u];
    }
  }
}

template <typename V>
cudaError_t launch(const void* arena, const int* tables, void* out, int ng,
                   int n_pages, int b, int mb, int64_t page_bytes,
                   cudaStream_t stream) {
  const int64_t n_out_pages = static_cast<int64_t>(ng) * b * mb;
  paged_gather_kernel<V><<<static_cast<unsigned>(n_out_pages), kThreads, 0, stream>>>(
      static_cast<const V*>(arena), tables, static_cast<V*>(out), n_pages, b, mb,
      page_bytes / static_cast<int64_t>(sizeof(V)));
  return cudaGetLastError();
}

bool aligned(const void* p, int64_t page_bytes, int64_t width) {
  return reinterpret_cast<uintptr_t>(p) % width == 0 && page_bytes % width == 0;
}

}  // namespace

extern "C" {

// arena: [ng, n_pages, page_bytes] bytes; tables: [b, mb] int32;
// out: [ng, b, mb, page_bytes] bytes. page_bytes = bs · F · element size.
int paged_gather_launch(const void* arena, const void* tables, void* out, int ng,
                        int n_pages, int b, int mb, long long page_bytes,
                        void* stream) {
  const int* tb = static_cast<const int*>(tables);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t pb = page_bytes;
  const int64_t n_out_pages = static_cast<int64_t>(ng) * b * mb;
  if (ng <= 0 || n_pages <= 0 || b <= 0 || mb <= 0 || pb <= 0 ||
      n_out_pages > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if (aligned(arena, pb, 16) && aligned(out, pb, 16))
    return launch<uint4>(arena, tb, out, ng, n_pages, b, mb, pb, st);
  if (aligned(arena, pb, 4) && aligned(out, pb, 4))
    return launch<uint32_t>(arena, tb, out, ng, n_pages, b, mb, pb, st);
  if (aligned(arena, pb, 2) && aligned(out, pb, 2))
    return launch<uint16_t>(arena, tb, out, ng, n_pages, b, mb, pb, st);
  return launch<uint8_t>(arena, tb, out, ng, n_pages, b, mb, pb, st);
}

}  // extern "C"
