"""Checkpointing (``repro.training.checkpoint``): tree ⇄ .npz with
path-flattened keys.

The format is the reference's, so a checkpoint written by either package
loads in the other: each leaf of a dict tree is saved under its path of
keys joined by ``::``, in the reference's leaf order (sorted keys), and a bf16 leaf — numpy has no bf16 — as its raw 16 bits, a
``uint16`` array under the key ``BF16::<path>``. Adapters save apart
from the base model, so the serving engine's "disk" can be a directory
of adapter checkpoints (the paper's swap source).
"""
from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

_SEP = "::"
_BF16 = "BF16" + _SEP


def _paths(tree: Any, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(path key, leaf) pairs in the reference's leaf order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    else:
        yield _SEP.join(prefix), tree


def save_checkpoint(path: str, tree: Any) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    out: Dict[str, np.ndarray] = {}
    for key, leaf in _paths(tree):
        t = torch.as_tensor(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            out[_BF16 + key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    np.savez(path, **out)


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shape/dtype/device
    template)."""
    with np.load(path) as data:
        arrays: Dict[str, torch.Tensor] = {}
        for k in data.files:
            if k.startswith(_BF16):
                arrays[k[len(_BF16):]] = torch.from_numpy(
                    data[k].view(np.int16)).view(torch.bfloat16)
            else:
                arrays[k] = torch.from_numpy(data[k])

    def restore(node: Any, prefix: Tuple[str, ...]) -> Any:
        if isinstance(node, dict):
            return {k: restore(v, prefix + (str(k),))
                    for k, v in node.items()}
        key = _SEP.join(prefix)
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {key!r}: shape "
                             f"{tuple(arr.shape)} != {tuple(node.shape)}")
        return arr.to(dtype=node.dtype, device=node.device)

    return restore(like, ())
