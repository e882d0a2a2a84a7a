"""Carry the JAX package's trees into the port, through numpy.

The caller converts JAX arrays to numpy (``np.asarray`` leaf by leaf);
bf16 arrives as an ``ml_dtypes.bfloat16`` array and crosses as its raw
16 bits. This module imports no JAX: it maps nested dicts of numpy
arrays onto the port's tensors path for path.

    params_from_numpy(model, tree)   -> registers the Model's parameters
    lora_pool_from_numpy(tree)       -> stacked pool, leaves [ng, R, r, d]
                                        (or one adapter, leaves [ng, r, d])
    cache_from_numpy(tree)           -> KV cache, leaves [ng, B, C, ...]
    router_head_from_numpy(head)     -> {'w': [d, n_adapters], 'b'} f32
    adamw_state_from_numpy(state)    -> AdamWState (step, mu, nu)
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.training.optimizer import AdamWState


def tensor_from_numpy(a: np.ndarray, device: Any = "cpu") -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor of the same dtype."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def tree_from_numpy(tree: Any, device: Any = "cpu") -> Any:
    if isinstance(tree, dict):
        return {k: tree_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(np.asarray(tree), device)


def params_from_numpy(model: Model, tree: Dict) -> Dict:
    """Load the JAX param tree into ``model`` path for path (shapes are
    checked against its config), each leaf in its own dtype: an MoE
    slot's ``moe`` subtree crosses as it is, its router [ng, d, E] f32,
    its experts' ``up``/``gate``/``down`` [ng, E, d, f] / [ng, E, f, d]
    and a ``shared`` expert's MLP; a Mamba-2 slot's ``ssm`` subtree with
    its ``dt_bias``, ``A_log`` and ``D`` in f32 whatever the model dtype;
    zamba2's unstacked ``shared_attn`` block; an encoder-decoder's
    ``encoder`` and ``decoder`` subtrees (LayerNorm ``scale``/``bias``,
    the decoder's ``cross`` block, each ``ln_post``), stacked over their
    layers. Returns ``model.params``."""
    return model.load_params(tree_from_numpy(tree, model.device))


def lora_pool_from_numpy(tree: Dict, device: Any = "cpu") -> Dict:
    """The stacked LoRA pool (or one adapter) as tensors, any tree: the
    stack's ``layers`` (and ``shared_attn``), or an encoder-decoder's
    ``encoder``, ``decoder`` and ``cross`` parts, leaves [n, (R,) r, d]."""
    return tree_from_numpy(tree, device)


def cache_from_numpy(tree: Dict, device: Any = "cpu") -> Dict:
    """A KV cache tree as tensors: k, v (or int8 k, v with bf16 k_scale,
    v_scale under ``kv_cache_quant``) and the int32 pos leaves."""
    return tree_from_numpy(tree, device)


def router_head_from_numpy(head: Dict, device: Any = "cpu") -> Dict:
    """A router head {'w': [d_model, n_adapters], 'b': [n_adapters]}."""
    return tree_from_numpy(head, device)


def adamw_state_from_numpy(state: Any, device: Any = "cpu") -> AdamWState:
    """The reference's ``AdamWState`` with numpy leaves (its step, first
    and second moment trees) as the port's."""
    step, mu, nu = state
    return AdamWState(tensor_from_numpy(np.asarray(step, np.int32), device),
                      tree_from_numpy(mu, device), tree_from_numpy(nu, device))
