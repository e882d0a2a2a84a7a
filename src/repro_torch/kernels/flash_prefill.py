"""Flash-attention prefill for Hopper: every prefill step's attention.

Python face of ``csrc/flash_prefill.cu`` (built by ``_build.py``, bound
with ctypes). Replaces the Pallas TPU kernel
``repro.kernels.flash_prefill.flash_prefill``: tiled causal, sliding-window
or chunked-local attention with an online softmax in f32 and an optional
softcap. The TPU kernel takes positions ``0..S-1`` and repeats K/V ``g``
times for GQA; here head ``h`` reads kv head ``h // g`` directly, and
``qpos`` [Sq] / ``kpos`` [Skv] may be given, with ``Sq ≠ Skv``, so a
suffix or chunked prefill attends over the cached prefix followed by the
fresh suffix (the reference model's ``blockwise_attention`` mask: a key
is visible iff ``kpos ≥ 0``, ``kpos ≤ qpos`` when causal, and it lies in
the window or chunk). Masked scores are the finite ``-1e30`` of the TPU
kernel.

What bounds it on an H100 at the main path's prefill shapes: bytes (see
the source's note). bf16 runs both products on the tensor cores
(``mma.sync``, f32 accumulators, p rounded to bf16 for P·V), one CTA per
64 (position, head) rows of a kv group so the group's heads share each
K/V tile; f32 runs them on CUDA cores, since the tensor cores have no
f32 path that meets f32's tolerance.

The wrapper takes the plain PyTorch version (``flash_prefill_plain``)
only for a tensor on the CPU. For a CUDA tensor it launches the kernel or
raises. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_attention import HEAD_DIMS, check_mask_args

# kernel launches; incremented only where the kernel launches
launches: Dict[str, int] = {"flash_prefill": 0}

NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_LIB: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _lib() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/flash_prefill.cu``."""
    global _LIB
    if _LIB is None:
        lib = _build.load("flash_prefill")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.flash_prefill_launch.argtypes = [p, p, p, p, p, p,
                                             i, i, i, i, i, i, i,
                                             f, i, i, i, f, p]
        lib.flash_prefill_launch.restype = i
        _LIB = lib
    return _LIB


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           qpos: Optional[torch.Tensor], kpos: Optional[torch.Tensor],
           window: Optional[int], softcap: Optional[float]) -> None:
    name = "flash_prefill"
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: want q [B, Sq, H, hd] and k, v [B, Skv, "
                         f"KH, hd], got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if (k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]
            or q.shape[2] % k.shape[2]):
        raise ValueError(f"{name}: q {tuple(q.shape)} does not fit k "
                         f"{tuple(k.shape)}")
    for pos, n, label in ((qpos, q.shape[1], "qpos"),
                          (kpos, k.shape[1], "kpos")):
        if pos is not None and tuple(pos.shape) != (n,):
            raise ValueError(f"{name}: {label} {tuple(pos.shape)} != ({n},)")
    tensors = [t for t in (q, k, v, qpos, kpos) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError(f"{name}: tensors on different devices")
    check_mask_args(name, window, softcap)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        qpos: Optional[torch.Tensor] = None,
                        kpos: Optional[torch.Tensor] = None,
                        causal: bool = True, window: Optional[int] = None,
                        chunked: bool = False,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch ``flash_prefill``: the whole score matrix at once, in
    f32 (the kernel's arithmetic without the tiling), q's dtype out."""
    _check(q, k, v, qpos, kpos, window, softcap)
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    dev = q.device
    qp = (torch.arange(sq, device=dev) if qpos is None else qpos.long())
    kp = (torch.arange(skv, device=dev) if kpos is None else kpos.long())
    qg = q.reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * hd ** -0.5
    if softcap is not None:
        s = torch.tanh(s / softcap) * softcap
    qp, kp = qp[:, None], kp[None, :]
    valid = kp >= 0
    if causal:
        valid = valid & (kp <= qp)
    if window is not None:
        if chunked:  # torch's // on integer tensors floors, as JAX's does
            valid = valid & ((qp // window) == (kp // window))
        else:
            valid = valid & ((qp - kp) < window)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  qpos: Optional[torch.Tensor] = None,
                  kpos: Optional[torch.Tensor] = None, causal: bool = True,
                  window: Optional[int] = None, chunked: bool = False,
                  softcap: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, H, hd]; k, v: [B, Skv, KH, hd], f32 or bf16 (one dtype);
    qpos [Sq] / kpos [Skv] int positions (default ``arange``). Returns
    [B, Sq, H, hd] in q's dtype."""
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, qpos=qpos, kpos=kpos,
                                   causal=causal, window=window,
                                   chunked=chunked, softcap=softcap)
    _check(q, k, v, qpos, kpos, window, softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill: expected CUDA or CPU tensors, got "
                         f"{q.device}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill: q, k, v must share float32 or "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    b, sq, h, hd = q.shape
    skv, kh = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head dim {hd} not in {HEAD_DIMS}")
    qpos, kpos = (t if t is None else t.to(torch.int32)
                  for t in (qpos, kpos))
    tensors = [t for t in (q, k, v, qpos, kpos) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_prefill: tensors must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_prefill: q, k and v must be 16-byte aligned")
    out = torch.empty_like(q)
    err = _lib().flash_prefill_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        qpos.data_ptr() if qpos is not None else None,
        kpos.data_ptr() if kpos is not None else None, out.data_ptr(),
        b, sq, skv, h, kh, hd, _DTYPE_CODE[q.dtype], hd ** -0.5,
        int(causal), window or 0, int(chunked), softcap or 0.0,
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_prefill: kernel launch failed with CUDA "
                           f"error {err}")
    launches["flash_prefill"] += 1
    return out
