"""What decides ``correct``: the served tokens of a sample of the window's
finished requests, held against the plain reference.

The sample is drawn from the seed among the requests that finished
inside the window, with the longest one (prompt and served tokens)
always in it; ``checks/<cell>.json`` says how many. The reference runs
once over each prompt followed by its served tokens, with the weights
and the adapter the request names, and reads the logits at each position
that produced a served token. The number compared is the widest gap by
which a served token's logit lies below the reference's best at its
position (greedy decoding serves the top token, so a sound run reads
only its rounding there).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.harness import spec
from perfbench.harness.weights import AdapterBank

SALT = 0xC4EC
BLOCK = 8     # requests the reference holds at once


def finished(run: Any) -> List[Any]:
    """Requests whose every served token came inside the window."""
    out = []
    for rid, stamps in run.rec.tokens.items():
        req = run.requests[rid]
        if req.finish_time is not None and len(req.tokens) == len(stamps):
            out.append(req)
    return out


def sample(reqs: Sequence[Any], n: int, seed: int) -> List[Any]:
    """``n`` of ``reqs``, drawn from the seed, the longest among them."""
    if not reqs:
        return []
    reqs = sorted(reqs, key=lambda r: r.request_id)
    longest = max(range(len(reqs)),
                  key=lambda i: (reqs[i].prompt_len + len(reqs[i].tokens),
                                 -i))
    rest = [i for i in range(len(reqs)) if i != longest]
    rng = np.random.default_rng([seed, SALT])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [reqs[longest]] + [reqs[rest[i]] for i in sorted(pick)]


def reference_inputs(reqs: Sequence[Any], device: torch.device
                     ) -> List[Tuple[torch.Tensor, List[int]]]:
    """Per request: its prompt and served tokens but the last, and the
    positions whose logits produced the served tokens."""
    seqs = []
    for r in reqs:
        toks = np.concatenate([np.asarray(r.prompt_tokens, np.int64),
                               np.asarray(r.tokens[:-1], np.int64)])
        read = [r.prompt_len - 1 + i for i in range(len(r.tokens))]
        seqs.append((torch.from_numpy(toks).to(device), read))
    return seqs


def reference_logits(ref: Any, cfg: Dict, weights: Dict,
                     bank_trees: List[Dict], reqs: Sequence[Any],
                     device: torch.device, **kw: Any) -> List[torch.Tensor]:
    """The reference's logits at the served positions, ``BLOCK``
    requests at a time (``kw``: the reference's precision hooks)."""
    out: List[torch.Tensor] = []
    for i in range(0, len(reqs), BLOCK):
        part = reqs[i:i + BLOCK]
        ads = [bank_trees[r.adapter_id % len(bank_trees)] for r in part]
        out += ref.served_logits(cfg, weights, ads,
                                 reference_inputs(part, device), **kw)
    return out


def compare(cell: spec.Cell, run: Any, weights: Dict, bank: AdapterBank,
            device: torch.device, seed: int,
            log: Callable[[str], None]) -> Dict:
    t0 = time.perf_counter()
    limits = cell.checks
    reqs = sample(finished(run), limits["sample_requests"], seed)
    checks: Dict[str, Dict] = {
        "requests_compared": {"value": len(reqs), "limit": 1}}
    ok = len(reqs) >= 1
    if reqs:
        ref = spec.reference(cell.config, cell.root)
        trees = bank.on_device(device)
        logits = reference_logits(ref, cell.config, weights, trees, reqs,
                                  device)
        gap, n_tok = ref.widest_gap(logits, [r.tokens for r in reqs])
        limit = limits["widest_logit_gap"]
        checks["tokens_compared"] = {"value": n_tok, "limit": 1}
        checks["widest_logit_gap"] = {"value": gap, "limit": limit}
        ok = ok and gap <= limit
        del trees, logits
    log(f"reference: {len(reqs)} requests in "
        f"{time.perf_counter() - t0:.3f} s")
    return {"correct": bool(ok), "checks": checks}
