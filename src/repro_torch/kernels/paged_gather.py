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

What bounds it on an H100: bytes (one read and one write of every
gathered element, no arithmetic). The design moves whole pages with
16-byte vector copies, one CTA per output page, and does no address math
beyond one table read per page; it copies ``element_size·F`` bytes per
row, so any arena dtype works.

The wrapper takes the plain PyTorch version (``paged_gather_pages_plain``)
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

# kernel launches; incremented only where the kernel launches
launches: Dict[str, int] = {"paged_gather_pages": 0}

_LIB: Optional[ctypes.CDLL] = None


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
                                            ctypes.c_longlong, p]
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
    err = _lib().paged_gather_launch(
        arena.data_ptr(), tables.data_ptr(), out.data_ptr(), ng, n_pages, b,
        mb, bs * f * arena.element_size(),
        torch.cuda.current_stream(arena.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_gather_pages: kernel launch failed with "
                           f"CUDA error {err}")
    launches["paged_gather_pages"] += 1
    return out
