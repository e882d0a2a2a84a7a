"""Flash-decode for Hopper: the decode step's attention over the ring cache.

Python face of ``csrc/decode_attention.cu`` (built by ``_build.py``,
bound with ctypes). Replaces the Pallas TPU kernel
``repro.kernels.decode_attention.flash_decode``: one query token per
sequence against a ring cache of ``C`` entries, GQA (head ``h`` reads kv
head ``h // g``), online softmax in f32, masked from stored positions
(``0 ≤ kv_pos ≤ q_pos``, optional sliding window or chunked window, where
chunks floor-divide positions), optional softcap, and int8 K/V with
per-(token, head) f32 scales dequantised as each tile loads. ``q_pos`` is
a scalar or one position per row (the TPU kernel takes a scalar; the
engine decodes each row at its own position). Masked scores are the
finite ``-1e30`` of the TPU kernel, so a row without any key (an idle
decode row) is the mean of V over its ring, as in the plain model code.

What bounds it on an H100: bytes, one pass over K and V. The ring is cut
into contiguous splits (``split_plan``), one CTA per (split, row, kv
head), each issuing all of its split's K/V loads at once; the last
split of each (row, kv head) to finish merges the splits' partial
softmaxes in split order, so two calls give bit-equal outputs. See the
source's note.

The wrapper takes the plain PyTorch version (``flash_decode_plain``)
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises. ``launches`` counts wrapper calls that launch the kernel (one,
whether the call makes one CUDA launch or two).
"""
from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, ref

# kernel launches; incremented only where the kernel launches
launches: Dict[str, int] = {"flash_decode": 0}

HEAD_DIMS = (32, 64, 128, 256)
# split plan: at least two CTAs on each of an H100's 132 SMs, splits of at
# least 32 keys (fewer partials to merge) where C has them, and a split's
# K/V and scores within 64 KiB of shared memory (three CTAs per SM fit)
SPLIT_CTAS = 2 * 132
MIN_SPLIT_KEYS = 32
SPLIT_SMEM = 64 * 1024
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_LIB: Optional[ctypes.CDLL] = None
# per (device, stream): int32 counts of the splits that have arrived, one
# per (row, kv head); zero between calls (the kernel's last split resets
# its count), so they are zeroed once, when made or grown
_ARRIVED: Dict[Tuple[int, int], torch.Tensor] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/decode_attention.cu``."""
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_decode_launch.argtypes = [p, p, p, p, p, p, p, p, p, p, p,
                                            i, i, i, i, i, i, i, i, i,
                                            f, i, i, f, p]
        lib.flash_decode_launch.restype = i
        _LIB = lib
    return _LIB


def split_plan(b: int, kh: int, c: int, g: int, hd: int,
               kv_itemsize: int) -> Tuple[int, int]:
    """``(keys_per_split, n_splits)`` for the decode kernel: the fewest
    splits that give ``SPLIT_CTAS`` CTAs over ``b * kh`` (row, kv head)
    pairs, no split under ``MIN_SPLIT_KEYS`` keys unless C is, none over
    what ``SPLIT_SMEM`` holds. Contiguous splits covering C exactly, none
    empty; the last one ragged. At the main path's shape (B 8, KH 8,
    C 256, g 4, hd 128, bf16): 5 splits of 52 keys, 320 CTAs."""
    # shared memory per key: K (padded 16 bytes) and V rows, a score per
    # query row, its position, and the int8 scales; per CTA: q in f32
    per_key = 2 * hd * kv_itemsize + 16 + 4 * g + 4 + (
        8 if kv_itemsize == 1 else 0)
    max_keys = max(1, (SPLIT_SMEM - 4 * g * (hd + 2)) // per_key)
    want = -(-SPLIT_CTAS // (b * kh))
    keys = max(-(-c // want), min(MIN_SPLIT_KEYS, c))
    keys = min(keys, max_keys)
    return keys, -(-c // keys)


def check_mask_args(name: str, window: Optional[int],
                    softcap: Optional[float]) -> None:
    if window is not None and window < 1:
        raise ValueError(f"{name}: window must be >= 1 or None, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"{name}: softcap must be > 0 or None, got "
                         f"{softcap}")


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           kv_pos: torch.Tensor, k_scale: Optional[torch.Tensor],
           v_scale: Optional[torch.Tensor], window: Optional[int],
           softcap: Optional[float]) -> None:
    name = "flash_decode"
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q [B, H, hd] and k, v [B, C, KH, hd],"
                         f" got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or h % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    if tuple(kv_pos.shape) != (b, k.shape[1]):
        raise ValueError(f"{name}: kv_pos {tuple(kv_pos.shape)} != "
                         f"{(b, k.shape[1])}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: give both k_scale and v_scale or neither")
    if k_scale is not None and (tuple(k_scale.shape) != tuple(k.shape[:3])
                                or k_scale.shape != v_scale.shape):
        raise ValueError(f"{name}: scales must be [B, C, KH] = "
                         f"{tuple(k.shape[:3])}")
    tensors = [q, k, v, kv_pos] + ([k_scale, v_scale]
                                   if k_scale is not None else [])
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    check_mask_args(name, window, softcap)


def flash_decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       kv_pos: torch.Tensor, q_pos: Any, *,
                       k_scale: Optional[torch.Tensor] = None,
                       v_scale: Optional[torch.Tensor] = None,
                       window: Optional[int] = None, chunked: bool = False,
                       softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch ``flash_decode``: int8 K/V dequantised whole, then
    ``ref.decode_attention_ref`` (f32 arithmetic, q's dtype out)."""
    _check(q, k, v, kv_pos, k_scale, v_scale, window, softcap)
    if k_scale is not None:
        k = k.float() * k_scale.float()[..., None]
        v = v.float() * v_scale.float()[..., None]
    return ref.decode_attention_ref(q, k, v, kv_pos, q_pos, window=window,
                                    chunked=chunked, softcap=softcap)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 kv_pos: torch.Tensor, q_pos: Any, *,
                 k_scale: Optional[torch.Tensor] = None,
                 v_scale: Optional[torch.Tensor] = None,
                 window: Optional[int] = None, chunked: bool = False,
                 softcap: Optional[float] = None) -> torch.Tensor:
    """q: [B, H, hd] f32 or bf16; k, v: [B, C, KH, hd] in q's dtype, or
    int8 with k_scale, v_scale [B, C, KH] f32; kv_pos: [B, C] int32
    (-1 = empty); q_pos: scalar or [B]. Returns [B, H, hd] in q's dtype."""
    if q.device.type == "cpu":
        return flash_decode_plain(q, k, v, kv_pos, q_pos, k_scale=k_scale,
                                  v_scale=v_scale, window=window,
                                  chunked=chunked, softcap=softcap)
    _check(q, k, v, kv_pos, k_scale, v_scale, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: expected CUDA or CPU tensors, got "
                         f"{q.device}")
    quant = k_scale is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_decode: q must be float32 or bfloat16, got "
                        f"{q.dtype}")
    want_kv = torch.int8 if quant else q.dtype
    if k.dtype != want_kv or v.dtype != want_kv:
        raise TypeError(f"flash_decode: k, v must be {want_kv} (q is "
                        f"{q.dtype}, scales {'given' if quant else 'absent'})"
                        f", got {k.dtype}, {v.dtype}")
    if kv_pos.dtype != torch.int32:
        raise TypeError("flash_decode: kv_pos must be int32")
    if quant and (k_scale.dtype != torch.float32
                  or v_scale.dtype != torch.float32):
        raise TypeError("flash_decode: scales must be float32")
    b, h, hd = q.shape
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head dim {hd} not in {HEAD_DIMS}")
    tensors = [q, k, v, kv_pos] + ([k_scale, v_scale] if quant else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_decode: tensors must be contiguous")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned")
    qp = torch.as_tensor(q_pos, dtype=torch.int32, device=q.device)
    qp = qp.expand(b).contiguous()
    c, kh = k.shape[1], k.shape[2]
    g = h // kh
    keys, n_splits = split_plan(b, kh, c, g, hd, k.element_size())
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    part_acc = part_ml = arrived = None
    if n_splits > 1:    # each split's (acc, m, l), merged by the last split
        part_acc = torch.empty(b * kh * n_splits * g * hd,
                               dtype=torch.float32, device=q.device)
        part_ml = torch.empty(b * kh * n_splits * g * 2,
                              dtype=torch.float32, device=q.device)
        key = (q.device.index, stream)
        arrived = _ARRIVED.get(key)
        if arrived is None or arrived.numel() < b * kh:
            arrived = _ARRIVED[key] = torch.zeros(
                b * kh, dtype=torch.int32, device=q.device)
    err = _lib().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quant else None,
        v_scale.data_ptr() if quant else None, kv_pos.data_ptr(),
        qp.data_ptr(), out.data_ptr(),
        part_acc.data_ptr() if n_splits > 1 else None,
        part_ml.data_ptr() if n_splits > 1 else None,
        arrived.data_ptr() if n_splits > 1 else None, b, c, kh, g, hd,
        _DTYPE_CODE[q.dtype], _DTYPE_CODE[k.dtype], keys, n_splits,
        hd ** -0.5, window or 0, int(chunked), softcap or 0.0, stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA "
                           f"error {err}")
    launches["flash_decode"] += 1
    return out
