"""Adaptive Adapter Selection (paper §3.2, Algorithm 1; §4.1).

Port of ``repro.core.router``. The router is a multi-label classifier:
the *shared base model* (already resident on the device) produces the
prompt's pooled hidden state, and a single Linear head maps it to one
suitability score per adapter. Selection is cache-aware: among the
top-k scored adapters, a resident one is preferred over the globally
best-but-cold one.

* ``LearnedRouter`` — base model trunk + trained head (trained in
  ``training/router_train.py``); on the card its trunk runs the
  ``flash_prefill`` kernel once per layer per call.
* ``OracleRouter`` — workload-synthesis stand-in, host-side numpy drawing
  from the reference's ``np.random.default_rng([seed, request_id])``
  stream, so its scores are bit-identical.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.adapter_cache import AdapterMemoryManager
from repro_torch.core.slots import Request
from repro_torch.models import transformer
from repro_torch.models.layers import rmsnorm


def select_adapter(scores: np.ndarray, manager: AdapterMemoryManager,
                   top_k: int) -> tuple:
    """Algorithm 1, lines 8-14: cache-aware top-k selection.

    Returns (adapter_id, was_cached). ``scores``: [n_adapters].
    """
    order = np.argsort(-scores)
    top = order[:top_k]
    for a in top:
        if int(a) in manager:
            return int(a), True
    return int(top[0]), False


class OracleRouter:
    """Scores peaked at the true adapter; ``accuracy`` controls how often
    the argmax lands on it (models an imperfect learned router).

    Scores are a pure function of ``(seed, request_id)`` — NOT of call
    order, so scheduling changes never re-roll a selection.
    """

    def __init__(self, n_adapters: int, accuracy: float = 0.95,
                 seed: int = 0) -> None:
        self.n_adapters = n_adapters
        self.accuracy = accuracy
        self.seed = seed

    def scores(self, request: Request) -> np.ndarray:
        rng = np.random.default_rng([self.seed, request.request_id])
        s = rng.uniform(0.0, 0.5, self.n_adapters)
        true = request.true_adapter if request.true_adapter is not None else 0
        if rng.uniform() < self.accuracy:
            s[true] = 1.0
        else:
            s[rng.integers(self.n_adapters)] = 1.0
            s[true] = 0.9
        return s

    # Oracle scoring is bookkeeping only — no model forward.
    costs_forward = False


def trunk_features(model: Any, params: Dict,
                   tokens: torch.Tensor) -> torch.Tensor:
    """The trunk's prompt features: the stack's hidden states mean-pooled
    over every position of the row (a padded row's padding included, as
    in the reference), then the final norm; f32 [B, d]. Attention takes
    the model's route (``model.attn_kernel``)."""
    x = model.embed(params, tokens)
    positions = torch.arange(tokens.shape[1], device=tokens.device)
    h, _ = transformer.forward_stack(params, x, model.cfg, positions,
                                     attn_kernel=model.attn_kernel)
    # mean-pool over the prompt (the paper leaves pooling unspecified;
    # mean is markedly more informative than last-token for the
    # synthetic profiling prompts)
    pooled = rmsnorm(params["final_norm"], h.mean(dim=1), model.cfg.norm_eps)
    return pooled.float()


class LearnedRouter:
    """Base-model trunk + Linear head (paper §4.1).

    head: {'w': [d_model, n_adapters], 'b': [n_adapters]} f32 on the
    model's device. The score pass reuses the frozen base weights; its
    compute ≈ one prompt forward, which the engine charges to the
    timeline (the paper's observed ≈prompt-decode overhead, Table 6).
    """

    costs_forward = True

    def __init__(self, model: Any, params: Dict, head: Dict) -> None:
        self.model = model
        self.params = params
        self.head = head

    def scores_batch(self, tokens: Any) -> np.ndarray:
        """tokens: [B, S] -> [B, n_adapters] sigmoid suitabilities."""
        with torch.inference_mode():
            toks = torch.as_tensor(tokens, device=self.model.device)
            feats = trunk_features(self.model, self.params, toks)
            logits = feats @ self.head["w"] + self.head["b"]
            return torch.sigmoid(logits).cpu().numpy()

    def scores(self, request: Request) -> np.ndarray:
        toks = np.asarray(request.prompt_tokens)[None, :]
        return self.scores_batch(toks)[0]
