"""A cell cut to CPU size, for the tests: the same harness, the model at
a few layers and tiny widths, prompts of tens of tokens. The kernel
wrappers run their plain versions on CPU tensors."""
from __future__ import annotations

import copy
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


def small_cell(name: str, **checks) -> spec.Cell:
    cell = spec.load_cell(name)
    cfg = copy.deepcopy(cell.config)
    cfg.update(SMALL_MODEL)
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
