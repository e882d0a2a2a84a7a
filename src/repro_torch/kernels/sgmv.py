"""SGMV kernels for Hopper: the paper's Batch LoRA Inference hot loop.

Python face of ``csrc/sgmv.cu`` (built by ``_build.py``, bound with
ctypes). Replaces the Pallas TPU kernels of ``repro.kernels.sgmv``:

* ``sgmv_shrink`` (TPU: ``sgmv_shrink`` / ``_shrink_kernel``):
  ``s = x · A[block_slots[i]]ᵀ`` per adapter-homogeneous block of
  ``blk_t`` rows, f32 accumulation over ``d_in``.
* ``sgmv_expand`` (TPU: ``sgmv_expand`` / ``_expand_kernel``):
  ``y = s · B[block_slots[i]]ᵀ`` per block, f32 out.

Both take ``n_used``, the number of leading blocks that hold tokens (the
grouping plan's, an int32 tensor on the device; ``None`` means every
block, as on the TPU). The blocks past it hold zero rows of x, so their
outputs are zero: the kernels store the zeros and read no weights for
them, and the host never learns ``n_used``.

What bounds them on an H100: bytes (at rank r both products do about
2·r FLOPs per element they read or write). ``sgmv_shrink`` is one launch
of as many CTAs as the card holds at once; each reads ``n_used`` and
takes its share of the used blocks' ``d_in`` (``shrink_work`` mirrors
that split), keeps up to four 128-column tiles in flight as 16-byte
``cp.async`` into a ring of shared-memory stages, runs bf16 products on
the tensor cores (f32 on CUDA cores), and the last split of a block to
finish sums the splits' partials in split order (deterministic).
``sgmv_expand`` keeps each CTA's B columns in flight at once, register
tiles of outputs and 16-byte stores. See the source's note.

Each wrapper takes the plain PyTorch version (``*_plain``) only for a
tensor on the CPU. For a CUDA tensor it launches the kernel or raises;
the kernels take the adapter pool in f32 only, the serving pool's dtype
(``init_lora_stack``), ranks up to ``MAX_RANK`` and blocks of up to
``MAX_BLK_T`` rows. ``launches`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.kernels import _build

DEFAULT_BLK_T = 128
# the kernels' limits and shrink's d_in tile (csrc/sgmv.cu kMaxRank,
# kMaxBlk, kKC; checked against the library when it is bound)
MAX_RANK = 64
MAX_BLK_T = 128
SHRINK_TILE = 128

# kernel launches per wrapper; incremented only where a kernel launches
launches: Dict[str, int] = {"sgmv_shrink": 0, "sgmv_expand": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None
# shrink grid per (device, blk_t, r, x dtype code)
_CTAS: Dict[Tuple[int, int, int, int], int] = {}
# per (device, stream): shrink's int32 arrival counts, one per block (zero
# between calls: the kernel's merging CTA resets its count, so they are
# zeroed once, when made or grown), and its f32 partial-sum scratch
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/sgmv.cu``."""
    global _LIB
    if _LIB is None:
        lib = _build.load("sgmv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sgmv_shrink_launch.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                           i, i, i, p]
        lib.sgmv_shrink_launch.restype = i
        lib.sgmv_expand_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           p]
        lib.sgmv_expand_launch.restype = i
        lib.sgmv_shrink_ctas.argtypes = [i, i, i]
        lib.sgmv_shrink_ctas.restype = i
        for name in ("sgmv_shrink_tile", "sgmv_max_rank", "sgmv_max_blk_t"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        got = (lib.sgmv_shrink_tile(), lib.sgmv_max_rank(),
               lib.sgmv_max_blk_t())
        if got != (SHRINK_TILE, MAX_RANK, MAX_BLK_T):
            raise RuntimeError(f"sgmv: library constants {got} != "
                               f"{(SHRINK_TILE, MAX_RANK, MAX_BLK_T)}")
        _LIB = lib
    return _LIB


def shrink_splits(n_used: int, d_in: int, grid: int) -> int:
    """S, the splits of each used block's ``d_in`` tiles, as each CTA of
    ``sgmv_shrink``'s grid derives it on the device from ``n_used``."""
    kt = -(-d_in // SHRINK_TILE)
    return max(1, min(grid // n_used, kt)) if n_used > 0 else 1


def shrink_work(n_used: int, d_in: int,
                grid: int) -> List[List[Tuple[int, int, int, int]]]:
    """Mirror of ``sgmv_shrink``'s device-side work split: for each of the
    grid's CTAs, the items it takes, in order, as (block, split, first
    column, end column). Item i is (block i // S, split i % S) and CTA g
    takes items g, g + grid, ...; split j of a block covers d_in tiles
    [j·kt // S, (j+1)·kt // S) of ``SHRINK_TILE`` columns. With S > 1 item
    i's partial goes to scratch row i, and the block's last split to
    arrive sums rows block·S .. block·S + S - 1 in that order."""
    kt = -(-d_in // SHRINK_TILE)
    s = shrink_splits(n_used, d_in, grid)
    work: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(grid)]
    for cta in range(grid):
        for item in range(cta, n_used * s, grid):
            blk, split = divmod(item, s)
            t0, t1 = split * kt // s, (split + 1) * kt // s
            work[cta].append((blk, split, t0 * SHRINK_TILE,
                              min(t1 * SHRINK_TILE, d_in)))
    return work


def _check_common(name: str, x: torch.Tensor, w: torch.Tensor,
                  block_slots: torch.Tensor, blk_t: int,
                  n_used: Optional[torch.Tensor]) -> int:
    t = x.shape[0]
    if t % blk_t:
        raise ValueError(f"{name}: {t} rows is not a multiple of "
                         f"blk_t={blk_t}")
    if block_slots.shape != (t // blk_t,):
        raise ValueError(f"{name}: block_slots {tuple(block_slots.shape)} "
                         f"!= ({t // blk_t},)")
    if x.device != w.device or x.device != block_slots.device:
        raise ValueError(f"{name}: tensors on different devices")
    if n_used is not None:
        if n_used.numel() != 1 or n_used.dtype != torch.int32:
            raise ValueError(f"{name}: n_used must be one int32, got "
                             f"{n_used.dtype} {tuple(n_used.shape)}")
        if n_used.device != x.device:
            raise ValueError(f"{name}: n_used on {n_used.device}, x on "
                             f"{x.device}")
    return t // blk_t


def _check_cuda(name: str, w: torch.Tensor, blk_t: int, r: int,
                *tensors: torch.Tensor) -> None:
    for t in (w, *tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA or CPU tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes an f32 adapter pool, got "
                        f"{w.dtype}")
    if not (1 <= r <= MAX_RANK and 1 <= blk_t <= MAX_BLK_T):
        raise ValueError(f"{name}: the kernel takes rank 1..{MAX_RANK} and "
                         f"blk_t 1..{MAX_BLK_T}, got r={r}, blk_t={blk_t}")


def _code(name: str, dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    return _DTYPE_CODE[dtype]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _zero_past_used(out: torch.Tensor, n_used: Optional[torch.Tensor],
                    blk_t: int) -> torch.Tensor:
    """Rows of blocks at or past ``n_used`` set to zero (no host sync)."""
    if n_used is None:
        return out
    row_blk = torch.arange(out.shape[0], device=out.device) // blk_t
    return torch.where((row_blk < n_used.reshape(()))[:, None], out, 0.0)


def shrink_plain(x: torch.Tensor, a_stack: torch.Tensor,
                 block_slots: torch.Tensor, *, blk_t: int,
                 n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch ``sgmv_shrink``: weights rounded to ``x.dtype``,
    products in f32, zeros for the blocks past ``n_used``.
    x: [nb·blk_t, d_in] -> [nb·blk_t, r] f32."""
    nb = x.shape[0] // blk_t
    a_sel = a_stack[block_slots.long()].to(x.dtype).float()  # [nb, r, d]
    xb = x.float().reshape(nb, blk_t, x.shape[1])
    out = torch.einsum("ntd,nrd->ntr", xb, a_sel).reshape(nb * blk_t, -1)
    return _zero_past_used(out, n_used, blk_t)


def expand_plain(s: torch.Tensor, b_stack: torch.Tensor,
                 block_slots: torch.Tensor, *, blk_t: int,
                 compute_dtype: torch.dtype,
                 n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch ``sgmv_expand``: weights rounded to ``compute_dtype``,
    products in f32, zeros for the blocks past ``n_used``.
    s: [nb·blk_t, r] -> [nb·blk_t, d_out] f32."""
    nb = s.shape[0] // blk_t
    b_sel = b_stack[block_slots.long()].to(compute_dtype).float()
    sb = s.float().reshape(nb, blk_t, s.shape[1])
    out = torch.einsum("ntr,nor->nto", sb, b_sel).reshape(nb * blk_t, -1)
    return _zero_past_used(out, n_used, blk_t)


def _shrink_ctas(lib: ctypes.CDLL, device: torch.device, blk_t: int, r: int,
                 code: int) -> int:
    key = (device.index, blk_t, r, code)
    if key not in _CTAS:
        with torch.cuda.device(device):
            ctas = lib.sgmv_shrink_ctas(blk_t, r, code)
        if ctas <= 0:
            raise RuntimeError(f"sgmv_shrink: sizing the grid failed with "
                               f"CUDA error {-ctas}")
        _CTAS[key] = ctas
    return _CTAS[key]


def _scratch(device: torch.device, stream: int, n_blocks: int,
             n_part: int) -> Tuple[torch.Tensor, torch.Tensor]:
    key = (device.index, stream)
    arrived, part = _SCRATCH.get(key, (None, None))
    if arrived is None or arrived.numel() < n_blocks:
        arrived = torch.zeros(n_blocks, dtype=torch.int32, device=device)
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    _SCRATCH[key] = (arrived, part)
    return arrived, part


def sgmv_shrink(x: torch.Tensor, a_stack: torch.Tensor,
                block_slots: torch.Tensor, *, blk_t: int = DEFAULT_BLK_T,
                n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x: [T, d_in] with T = nb·blk_t adapter-homogeneous rows;
    a_stack: [R, r, d_in] (f32 on CUDA; rounded to x.dtype on load);
    block_slots: [nb] int32; n_used: one int32, the blocks that hold
    tokens (None: all). Returns [T, r] f32."""
    nb = _check_common("sgmv_shrink", x, a_stack, block_slots, blk_t,
                       n_used)
    n_slots, r, d_in = a_stack.shape
    if x.shape[1] != d_in:
        raise ValueError(f"sgmv_shrink: x width {x.shape[1]} != A width "
                         f"{d_in}")
    if x.device.type == "cpu":
        return shrink_plain(x, a_stack, block_slots, blk_t=blk_t,
                            n_used=n_used)
    _check_cuda("sgmv_shrink", a_stack, blk_t, r, x, block_slots)
    if block_slots.dtype != torch.int32:
        raise TypeError("sgmv_shrink: block_slots must be int32")
    code = _code("sgmv_shrink", x.dtype)
    lib = _lib()
    grid = _shrink_ctas(lib, x.device, blk_t, r, code)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    arrived, part = _scratch(x.device, stream, nb, grid * blk_t * r)
    out = torch.empty((x.shape[0], r), dtype=torch.float32, device=x.device)
    err = lib.sgmv_shrink_launch(
        x.data_ptr(), a_stack.data_ptr(), block_slots.data_ptr(),
        _ptr(n_used), out.data_ptr(), part.data_ptr(), arrived.data_ptr(),
        nb, blk_t, d_in, r, n_slots, grid, code, stream)
    if err:
        raise RuntimeError(f"sgmv_shrink: kernel launch failed with CUDA "
                           f"error {err}")
    launches["sgmv_shrink"] += 1
    return out


def sgmv_expand(s: torch.Tensor, b_stack: torch.Tensor,
                block_slots: torch.Tensor, *, blk_t: int = DEFAULT_BLK_T,
                compute_dtype: Optional[torch.dtype] = None,
                n_used: Optional[torch.Tensor] = None) -> torch.Tensor:
    """s: [T, r] f32; b_stack: [R, d_out, r] (f32 on CUDA; rounded to
    ``compute_dtype``, default its own dtype, on load); block_slots: [nb]
    int32; n_used: one int32, the blocks that hold tokens (None: all).
    Returns [T, d_out] f32."""
    nb = _check_common("sgmv_expand", s, b_stack, block_slots, blk_t,
                       n_used)
    n_slots, d_out, r = b_stack.shape
    if s.shape[1] != r:
        raise ValueError(f"sgmv_expand: s rank {s.shape[1]} != B rank {r}")
    compute_dtype = compute_dtype or b_stack.dtype
    if s.device.type == "cpu":
        return expand_plain(s, b_stack, block_slots, blk_t=blk_t,
                            compute_dtype=compute_dtype, n_used=n_used)
    _check_cuda("sgmv_expand", b_stack, blk_t, r, s, block_slots)
    if s.dtype != torch.float32 or block_slots.dtype != torch.int32:
        raise TypeError("sgmv_expand: s must be float32 and block_slots "
                        "int32")
    code = _code("sgmv_expand", compute_dtype)
    y = torch.empty((s.shape[0], d_out), dtype=torch.float32,
                    device=s.device)
    err = _lib().sgmv_expand_launch(
        s.data_ptr(), b_stack.data_ptr(), block_slots.data_ptr(),
        _ptr(n_used), y.data_ptr(), nb, blk_t, d_out, r, n_slots, code,
        torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"sgmv_expand: kernel launch failed with CUDA "
                           f"error {err}")
    launches["sgmv_expand"] += 1
    return y
