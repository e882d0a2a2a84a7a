"""Paged-KV page gather for Hopper: the paged decode step's page fetch.

Python face of ``csrc/paged_gather.cu`` (built by ``_build.py``, bound
with ctypes). Replaces the Pallas TPU kernel
``repro.kernels.paged_gather.paged_gather_pages``, which routes each
page by a scalar-prefetched block table read in its BlockSpec
``index_map`` (pure DMA, no work in the kernel body).

``paged_gather_pages(arena [ng, n_pages, bs, F], tables [B, MB] int32)``
returns ``[ng, B, MB·bs, F]``: each row's pages, in table order, as one
contiguous run. ``-1`` (table padding, idle rows) reads the last page
(``tables mod n_pages`` with a floor modulo), which the serving arena
reserves as its trash page.

What bounds it on an H100: bytes (one read of each distinct page and one
write of the output, no arithmetic). The kernel copies the output as one
flat run of vectors that crosses page boundaries, a block of
``BLOCK_VECS`` vectors to a CTA, so a warp covers several 256-byte
pages and a large page is spread over several CTAs. ``vec_bytes`` picks
the vector width from the page size and the two pointers alone (never
the tables, which stay on the device); ``gather_plan`` and
``gather_work`` mirror the launch for the CPU tests: the grid, and the
(output page, byte range) pieces each CTA copies. See the source's note.
It copies ``element_size·F`` bytes per row, so any arena dtype works.

The wrapper takes the plain PyTorch version (``paged_gather_pages_plain``)
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises (also for an input that requires grad: the kernel has no
backward, ``_build.refuse_grad``). ``launches`` counts kernel launches,
one per wrapper call.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

# kernel launches; incremented only where the kernel launches
launches: Dict[str, int] = {"paged_gather_pages": 0}

_LIB: Optional[ctypes.CDLL] = None

# One 256-thread CTA per block of VEC_UNROLL·VEC_THREADS vectors, each
# thread VEC_UNROLL vectors in flight (the kernel's kThreads, kUnroll).
VEC_THREADS = 256
VEC_UNROLL = 4
BLOCK_VECS = VEC_UNROLL * VEC_THREADS


class GatherPlan(NamedTuple):
    """How one ``paged_gather_pages`` call runs: ``grid`` CTAs, each
    copying a block of ``BLOCK_VECS`` vectors of ``vec_bytes``."""
    page_bytes: int
    n_out_pages: int
    vec_bytes: int
    grid: int


def vec_bytes(page_bytes: int, arena_ptr: int, out_ptr: int) -> int:
    """The widest of 16, 8, 4, 2, 1 bytes that divides the page size and
    both pointers (or their alignments): the lowest set bit of the three,
    capped at 16."""
    low = page_bytes | arena_ptr | out_ptr | 16
    return low & -low


def gather_plan(page_bytes: int, n_out_pages: int, arena_align: int,
                out_align: int) -> GatherPlan:
    """The launch the kernel makes for ``n_out_pages`` (ng·B·MB) output
    pages of ``page_bytes`` at these pointer alignments: one CTA per
    block (the entry point computes the same grid)."""
    vec = vec_bytes(page_bytes, arena_align, out_align)
    return GatherPlan(page_bytes, n_out_pages, vec,
                      -(-n_out_pages * page_bytes // (vec * BLOCK_VECS)))


def gather_work(plan: GatherPlan, cta: int) -> List[Tuple[int, int, int]]:
    """The pieces CTA ``cta`` of ``plan`` copies, as (output page, first
    byte, end byte) within the page: the output's bytes from
    ``cta``·run to (``cta`` + 1)·run, run = ``BLOCK_VECS`` vectors, cut at
    page boundaries."""
    pb, work = plan.page_bytes, []
    run = BLOCK_VECS * plan.vec_bytes
    start = cta * run
    end = min(start + run, plan.n_out_pages * pb)
    while start < end:
        page, lo = divmod(start, pb)
        hi = min(pb, lo + end - start)
        work.append((page, lo, hi))
        start += hi - lo
    return work


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/paged_gather.cu``."""
    global _LIB
    if _LIB is None:
        lib = _build.load("paged_gather")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.paged_gather_launch.argtypes = [p, p, p, i, i, i, i,
                                            ctypes.c_longlong, i, p]
        lib.paged_gather_launch.restype = i
        _LIB = lib
    return _LIB


def _check(arena: torch.Tensor, tables: torch.Tensor) -> None:
    if arena.dim() != 4:
        raise ValueError(f"paged_gather_pages: arena must be [ng, n_pages, "
                         f"bs, F], got {tuple(arena.shape)}")
    if tables.dim() != 2:
        raise ValueError(f"paged_gather_pages: tables must be [B, MB], got "
                         f"{tuple(tables.shape)}")
    if arena.device != tables.device:
        raise ValueError("paged_gather_pages: arena and tables on different "
                         "devices")


def paged_gather_pages_plain(arena: torch.Tensor,
                             tables: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch ``paged_gather_pages`` (torch's ``%`` is a floor
    modulo, as JAX's is)."""
    _check(arena, tables)
    ng, n_pages, bs, f = arena.shape
    b, mb = tables.shape
    return arena[:, tables.long() % n_pages].reshape(ng, b, mb * bs, f)


def paged_gather_pages(arena: torch.Tensor,
                       tables: torch.Tensor) -> torch.Tensor:
    """arena: [ng, n_pages, bs, F] (any dtype); tables: [B, MB] int32, -1
    padded. Returns [ng, B, MB·bs, F] in arena's dtype."""
    _check(arena, tables)
    if arena.device.type == "cpu":
        return paged_gather_pages_plain(arena, tables)
    if arena.device.type != "cuda":
        raise ValueError(f"paged_gather_pages: expected CUDA or CPU tensors, "
                         f"got {arena.device}")
    _build.refuse_grad("paged_gather_pages", arena)
    if tables.dtype != torch.int32:
        raise TypeError("paged_gather_pages: tables must be int32")
    if not (arena.is_contiguous() and tables.is_contiguous()):
        raise ValueError("paged_gather_pages: tensors must be contiguous")
    ng, n_pages, bs, f = arena.shape
    b, mb = tables.shape
    out = torch.empty((ng, b, mb * bs, f), dtype=arena.dtype,
                      device=arena.device)
    if out.numel() == 0:
        return out
    page_bytes = bs * f * arena.element_size()
    lib = _lib()
    with _build.on_device(arena.device):
        err = lib.paged_gather_launch(
            arena.data_ptr(), tables.data_ptr(), out.data_ptr(), ng, n_pages,
            b, mb, page_bytes,
            vec_bytes(page_bytes, arena.data_ptr(), out.data_ptr()),
            torch.cuda.current_stream(arena.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_gather_pages: kernel launch failed with "
                           f"CUDA error {err}")
    launches["paged_gather_pages"] += 1
    return out
