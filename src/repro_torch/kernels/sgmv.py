"""SGMV kernels for Hopper: the paper's Batch LoRA Inference hot loop.

Python face of ``csrc/sgmv.cu`` (built by ``_build.py``, bound with
ctypes). Replaces the Pallas TPU kernels of ``repro.kernels.sgmv``:

* ``sgmv_shrink`` (TPU: ``sgmv_shrink`` / ``_shrink_kernel``):
  ``s = x · A[block_slots[i]]ᵀ`` per adapter-homogeneous block of
  ``blk_t`` rows, f32 accumulation over ``d_in``.
* ``sgmv_expand`` (TPU: ``sgmv_expand`` / ``_expand_kernel``):
  ``y = s · B[block_slots[i]]ᵀ`` per block, f32 out.

What bounds them on an H100: bytes. At LoRA rank r both products do
about 2·r FLOPs per element read (x and A for shrink, B and y for
expand), far below the ~295 FLOP/byte the bf16 tensor cores need, so the
kernels use plain FMA on CUDA cores and spend their design on memory:
coalesced loads along the contiguous axis, weights rounded to the
activation type on load (no per-call cast of the f32 pool), and, at
decode, a split of ``d_in`` across CTAs so the few token blocks still
fill the card (a second fixed-order pass sums the partial products; no
atomics, so results are deterministic).

Each wrapper takes the plain PyTorch version (``*_plain``) only for a
tensor on the CPU. For a CUDA tensor it launches the kernel or raises;
the kernels take the adapter pool in f32 only, the serving pool's dtype
(``init_lora_stack``). ``launches`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build

DEFAULT_BLK_T = 128

# kernel launches per wrapper; incremented only where a kernel launches
launches: Dict[str, int] = {"sgmv_shrink": 0, "sgmv_expand": 0}

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None
_SM_COUNT: Dict[int, int] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/sgmv.cu``."""
    global _LIB
    if _LIB is None:
        lib = _build.load("sgmv")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.sgmv_shrink_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                           i, i, p]
        lib.sgmv_shrink_launch.restype = i
        lib.sgmv_expand_launch.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
        lib.sgmv_expand_launch.restype = i
        lib.sgmv_shrink_max_outputs.argtypes = []
        lib.sgmv_shrink_max_outputs.restype = i
        lib.sgmv_shrink_tile.argtypes = []
        lib.sgmv_shrink_tile.restype = i
        _LIB = lib
    return _LIB


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


def shrink_split(n_blocks: int, d_in: int, sm_count: int,
                 tile: int) -> Tuple[int, int]:
    """(splits, chunk): cut ``d_in`` into ``splits`` chunks of ``chunk``
    columns (a multiple of the kernel's ``tile``) so that
    ``n_blocks · splits`` CTAs give every SM about two of them."""
    want = max(1, -(-2 * sm_count // n_blocks))
    splits = max(1, min(want, -(-d_in // tile)))
    chunk = -(-(-(-d_in // splits)) // tile) * tile
    return -(-d_in // chunk), chunk


def _check_common(name: str, x: torch.Tensor, w: torch.Tensor,
                  block_slots: torch.Tensor, blk_t: int) -> int:
    t = x.shape[0]
    if t % blk_t:
        raise ValueError(f"{name}: {t} rows is not a multiple of "
                         f"blk_t={blk_t}")
    if block_slots.shape != (t // blk_t,):
        raise ValueError(f"{name}: block_slots {tuple(block_slots.shape)} "
                         f"!= ({t // blk_t},)")
    if x.device != w.device or x.device != block_slots.device:
        raise ValueError(f"{name}: tensors on different devices")
    return t // blk_t


def _check_cuda(name: str, w: torch.Tensor, *tensors: torch.Tensor) -> None:
    for t in (w, *tensors):
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA or CPU tensors, got "
                             f"{t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    if w.dtype != torch.float32:
        raise TypeError(f"{name}: the kernel takes an f32 adapter pool, got "
                        f"{w.dtype}")


def _code(name: str, dtype: torch.dtype) -> int:
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {dtype} not supported "
                        "(float32 or bfloat16)")
    return _DTYPE_CODE[dtype]


def shrink_plain(x: torch.Tensor, a_stack: torch.Tensor,
                 block_slots: torch.Tensor, *, blk_t: int) -> torch.Tensor:
    """Plain PyTorch ``sgmv_shrink``: weights rounded to ``x.dtype``,
    products in f32. x: [nb·blk_t, d_in] -> [nb·blk_t, r] f32."""
    nb = x.shape[0] // blk_t
    a_sel = a_stack[block_slots.long()].to(x.dtype).float()  # [nb, r, d]
    xb = x.float().reshape(nb, blk_t, x.shape[1])
    return torch.einsum("ntd,nrd->ntr", xb, a_sel).reshape(nb * blk_t, -1)


def expand_plain(s: torch.Tensor, b_stack: torch.Tensor,
                 block_slots: torch.Tensor, *, blk_t: int,
                 compute_dtype: torch.dtype) -> torch.Tensor:
    """Plain PyTorch ``sgmv_expand``: weights rounded to ``compute_dtype``,
    products in f32. s: [nb·blk_t, r] -> [nb·blk_t, d_out] f32."""
    nb = s.shape[0] // blk_t
    b_sel = b_stack[block_slots.long()].to(compute_dtype).float()
    sb = s.float().reshape(nb, blk_t, s.shape[1])
    return torch.einsum("ntr,nor->nto", sb, b_sel).reshape(nb * blk_t, -1)


def sgmv_shrink(x: torch.Tensor, a_stack: torch.Tensor,
                block_slots: torch.Tensor, *,
                blk_t: int = DEFAULT_BLK_T) -> torch.Tensor:
    """x: [T, d_in] with T = nb·blk_t adapter-homogeneous rows;
    a_stack: [R, r, d_in] (f32 on CUDA; rounded to x.dtype on load);
    block_slots: [nb] int32. Returns [T, r] f32."""
    nb = _check_common("sgmv_shrink", x, a_stack, block_slots, blk_t)
    n_slots, r, d_in = a_stack.shape
    if x.shape[1] != d_in:
        raise ValueError(f"sgmv_shrink: x width {x.shape[1]} != A width "
                         f"{d_in}")
    if x.device.type == "cpu":
        return shrink_plain(x, a_stack, block_slots, blk_t=blk_t)
    _check_cuda("sgmv_shrink", a_stack, x, block_slots)
    if block_slots.dtype != torch.int32:
        raise TypeError("sgmv_shrink: block_slots must be int32")
    lib = _lib()
    if blk_t * r > lib.sgmv_shrink_max_outputs():
        raise ValueError(f"sgmv_shrink: blk_t·r = {blk_t * r} exceeds the "
                         f"kernel's {lib.sgmv_shrink_max_outputs()} "
                         "accumulators per CTA")
    splits, chunk = shrink_split(nb, d_in, _sm_count(x.device),
                                 lib.sgmv_shrink_tile())
    out = torch.empty((x.shape[0], r), dtype=torch.float32, device=x.device)
    partial = (torch.empty((splits, x.shape[0], r), dtype=torch.float32,
                           device=x.device) if splits > 1 else out)
    err = lib.sgmv_shrink_launch(
        x.data_ptr(), a_stack.data_ptr(), block_slots.data_ptr(),
        out.data_ptr(), partial.data_ptr(), nb, blk_t, d_in, r, n_slots,
        splits, chunk, _code("sgmv_shrink", x.dtype),
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"sgmv_shrink: kernel launch failed with CUDA "
                           f"error {err}")
    launches["sgmv_shrink"] += 1
    return out


def sgmv_expand(s: torch.Tensor, b_stack: torch.Tensor,
                block_slots: torch.Tensor, *, blk_t: int = DEFAULT_BLK_T,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """s: [T, r] f32; b_stack: [R, d_out, r] (f32 on CUDA; rounded to
    ``compute_dtype``, default its own dtype, on load); block_slots: [nb]
    int32. Returns [T, d_out] f32."""
    nb = _check_common("sgmv_expand", s, b_stack, block_slots, blk_t)
    n_slots, d_out, r = b_stack.shape
    if s.shape[1] != r:
        raise ValueError(f"sgmv_expand: s rank {s.shape[1]} != B rank {r}")
    compute_dtype = compute_dtype or b_stack.dtype
    if s.device.type == "cpu":
        return expand_plain(s, b_stack, block_slots, blk_t=blk_t,
                            compute_dtype=compute_dtype)
    _check_cuda("sgmv_expand", b_stack, s, block_slots)
    if s.dtype != torch.float32 or block_slots.dtype != torch.int32:
        raise TypeError("sgmv_expand: s must be float32 and block_slots "
                        "int32")
    lib = _lib()
    y = torch.empty((s.shape[0], d_out), dtype=torch.float32,
                    device=s.device)
    err = lib.sgmv_expand_launch(
        s.data_ptr(), b_stack.data_ptr(), block_slots.data_ptr(),
        y.data_ptr(), nb, blk_t, d_out, r, n_slots,
        _code("sgmv_expand", compute_dtype),
        torch.cuda.current_stream(s.device).cuda_stream)
    if err:
        raise RuntimeError(f"sgmv_expand: kernel launch failed with CUDA "
                           f"error {err}")
    launches["sgmv_expand"] += 1
    return y
