"""Device resolution for the port's entry points.

Every entry point (``Model``, ``EdgeLoRAEngine``, the serve CLI) takes a
device and defaults to ``cuda``. Asking for CUDA where there is none
raises: nothing falls back to the CPU behind the caller's back.
"""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``torch.device`` for ``device`` (None means ``cuda``); raises if a
    CUDA device is requested and CUDA is not available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (--device cpu) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r} (cuda or cpu)")
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """ModelConfig.dtype string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]
