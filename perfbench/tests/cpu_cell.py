"""A cell cut to CPU size, for the tests: the same harness, the model at
a few layers and tiny widths, prompts of tens of tokens. The kernel
wrappers run their plain versions on CPU tensors."""
from __future__ import annotations

import copy
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from perfbench.harness import spec  # noqa: E402

SMALL_MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
               "head_dim": 16, "d_ff": 96, "vocab_size": 256}
SMALL_TRAFFIC = {"prompt_len": [20, 48], "max_finish_per_s": 400}
SMALL_ENGINE = {"max_ctx": 56, "prompt_buckets": [48], "n_slots": 4,
                "attn_kernel": True, "lora_backend": "sgmv"}


def small(cell: spec.Cell, **checks) -> spec.Cell:
    """``cell`` cut to CPU size, in place; an expert block to at most 8
    experts and top-2."""
    cfg = copy.deepcopy(cell.config)
    cfg.update(SMALL_MODEL)
    if cfg.get("moe"):
        cfg["moe"]["n_experts"] = min(cfg["moe"]["n_experts"], 8)
        cfg["moe"]["top_k"] = min(cfg["moe"]["top_k"], 2)
    # a whole period of the layer pattern and the expert interleave
    period = math.lcm(len(cfg["attn"]["layer_pattern"]),
                      (cfg.get("moe") or {}).get("moe_layer_period", 1))
    cfg["n_layers"] = max(cfg["n_layers"], period)
    # the window bites at decode past the bucket, as 4096 does at full size
    cfg["attn"]["sliding_window"] = 48
    cfg["lora"]["rank"] = 4
    tfc = copy.deepcopy(cell.traffic)
    tfc["requests"].update(SMALL_TRAFFIC)
    lo, hi = tfc["requests"]["output_len"]
    tfc["requests"]["output_len"] = [lo, min(hi, 8)]
    tfc["requests"]["tenants"] = min(tfc["requests"]["tenants"], 12)
    tfc["engine"].update(SMALL_ENGINE)
    tfc["pool"] = tfc["bank"] = 4
    cell.config, cell.traffic = cfg, tfc
    cell.checks = {**cell.checks, **checks}
    return cell


def small_cell(name: str, **checks) -> spec.Cell:
    return small(spec.load_cell(name), **checks)
