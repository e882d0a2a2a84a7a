"""Synthetic tokenized data pipeline (a copy of ``repro.training.data``:
numpy only, so its arrays equal the reference's element for element).

No real corpora ship with the repo; the pipeline synthesizes structured
token streams that are *learnable* (Markov-ish per-task transition
matrices), which is what the examples and the router trainer need:

* ``lm_batches`` — next-token-predictable streams for LM fine-tuning;
  each task id gets its own transition structure, so a LoRA adapter
  fine-tuned on task t measurably beats the base model on task t.
* ``router_dataset`` — (prompt, multi-hot adapter label) pairs mirroring
  the paper's profiling-based router training data (§3.2): the label marks
  which adapters answer the prompt's task correctly.

The iterator protocol is deliberately tf.data-ish (stateless seeding,
epochless infinite streams, host prefetch irrelevant on CPU) so swapping a
real corpus in means replacing one generator function.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Tuple

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    n_tasks: int = 4
    seed: int = 0


def _task_transition(vocab: int, task: int, seed: int,
                     n_tasks: int = 8, affinity: float = 0.75) -> np.ndarray:
    """Row-stochastic transition matrix for one task.

    Each task has a preferred vocab block (its domain lexicon — the way
    math prompts use math tokens): ``affinity`` of the transition mass
    stays inside the block, the rest is task-specific dirichlet noise.
    This gives prompts a learnable task signature (what the paper's eval
    benchmarks provide naturally)."""
    rng = np.random.default_rng(seed * 1009 + task)
    base = rng.dirichlet(np.full(vocab, 0.05), size=vocab)
    block = vocab // max(n_tasks, 1)
    lo, hi = task % n_tasks * block, (task % n_tasks + 1) * block
    mask = np.zeros(vocab)
    mask[lo:hi] = 1.0
    in_block = base * mask
    in_block = in_block / np.maximum(in_block.sum(-1, keepdims=True), 1e-9)
    out = affinity * in_block + (1 - affinity) * base
    return out / out.sum(-1, keepdims=True)


def sample_task_tokens(rng: np.random.Generator, trans: np.ndarray,
                       n: int) -> np.ndarray:
    vocab = trans.shape[0]
    out = np.empty(n, np.int32)
    tok = rng.integers(vocab)
    for i in range(n):
        out[i] = tok
        tok = rng.choice(vocab, p=trans[tok])
    return out


def lm_batches(cfg: DataConfig, task: int = 0) -> Iterator[dict]:
    """Infinite stream of {'tokens': [B, S+1]} for next-token training."""
    trans = _task_transition(cfg.vocab_size, task, cfg.seed)
    rng = np.random.default_rng(cfg.seed + 17 * task)
    while True:
        toks = np.stack([
            sample_task_tokens(rng, trans, cfg.seq_len + 1)
            for _ in range(cfg.batch_size)])
        yield {"tokens": toks}


def router_dataset(cfg: DataConfig, n_adapters: int, n_samples: int,
                   adapters_per_task: int = 2,
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Profiling-style router data: prompts from task t are answerable by
    the ``adapters_per_task`` adapters assigned to t (multi-hot labels).

    Returns (prompts [N, S], labels [N, n_adapters] float, task_ids [N]).
    """
    rng = np.random.default_rng(cfg.seed + 999)
    # adapter -> task affinity (round-robin blocks, like the paper's six
    # task-specialized fine-tunes)
    labels_by_task = np.zeros((cfg.n_tasks, n_adapters), np.float32)
    for t in range(cfg.n_tasks):
        for j in range(adapters_per_task):
            labels_by_task[t, (t * adapters_per_task + j) % n_adapters] = 1.0
    trans = [_task_transition(cfg.vocab_size, t, cfg.seed)
             for t in range(cfg.n_tasks)]
    prompts = np.empty((n_samples, cfg.seq_len), np.int32)
    labels = np.empty((n_samples, n_adapters), np.float32)
    tasks = rng.integers(0, cfg.n_tasks, n_samples)
    for i, t in enumerate(tasks):
        prompts[i] = sample_task_tokens(rng, trans[t], cfg.seq_len)
        labels[i] = labels_by_task[t]
    return prompts, labels, tasks
