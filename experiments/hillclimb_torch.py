"""§Perf hillclimb driver on the PyTorch port: baseline + variants for the
three selected pairs (``experiments/hillclimb.py`` over
``repro_torch.launch.dryrun.run_combo``: fake tensors on a fake 16×16
mesh, no device).

Run: PYTHONPATH=src python experiments/hillclimb_torch.py
     PAIR=2 PYTHONPATH=src python experiments/hillclimb_torch.py

``PAIR`` (1, 2, 3 or all, the default) picks the pairs, as in the
reference, where ``sys.argv`` is reset before it is read. Each combo's
JSON lands in ``experiments/dryrun_torch/``.
"""
import os
import sys
from pathlib import Path

# runnable from the repo root without installing the package
_SRC = str(Path(__file__).resolve().parent.parent / "src")
if _SRC not in sys.path:
    sys.path.insert(0, _SRC)

from repro_torch.launch.dryrun import run_combo  # noqa: E402


def show(tag, r):
    t = r["roofline"]
    print(f"{tag:42s} comp={t['compute_s']*1e6:10.1f}µs "
          f"mem={t['memory_s']*1e6:10.1f}µs "
          f"coll={t['collective_s']*1e6:10.1f}µs "
          f"dom={r['dominant']:13s} useful={r['useful_flops_ratio']:.3f}")
    return r


def pair1():
    """llama4 decode_32k: worst useful ratio (MoE capacity waste)."""
    show("llama4/decode_32k BASELINE (paper-faithful)",
         run_combo("llama4-maverick-400b-a17b", "decode_32k",
                   verbose=False, variant="baseline"))
    show("llama4/decode_32k +gather-MoE",
         run_combo("llama4-maverick-400b-a17b", "decode_32k",
                   config_patch={"moe": {"gather_threshold": 4096}},
                   verbose=False, variant="gatherMoE"))
    show("llama4/decode_32k +gather-MoE +int8KV",
         run_combo("llama4-maverick-400b-a17b", "decode_32k",
                   config_patch={"moe": {"gather_threshold": 4096},
                                 "attn": {"kv_cache_quant": True}},
                   verbose=False, variant="gatherMoE_int8kv"))


def pair2():
    """mamba2 decode_32k: most collective-bound (FSDP weight gathers)."""
    show("mamba2/decode_32k BASELINE (paper-faithful)",
         run_combo("mamba2-130m", "decode_32k", verbose=False,
                   variant="baseline"))
    show("mamba2/decode_32k +replicate-small-weights",
         run_combo("mamba2-130m", "decode_32k",
                   rules_patch={"replicate_below": 64e6},
                   verbose=False, variant="replsmall"))
    show("mamba2/decode_32k +repl +no-model-shard(tiny d)",
         run_combo("mamba2-130m", "decode_32k",
                   rules_patch={"replicate_below": 64e6,
                                "ssm_inner": None, "ssm_heads": None},
                   verbose=False, variant="replsmall_nomodel"))


def pair3():
    """qwen2 decode_32k: paper-representative multi-tenant edge decode."""
    show("qwen2/decode_32k BASELINE (paper-faithful)",
         run_combo("qwen2-0.5b", "decode_32k", verbose=False,
                   variant="baseline"))
    show("qwen2/decode_32k +int8 KV cache",
         run_combo("qwen2-0.5b", "decode_32k",
                   config_patch={"attn": {"kv_cache_quant": True}},
                   verbose=False, variant="int8kv"))
    show("qwen2/decode_32k +int8KV +replicate-small",
         run_combo("qwen2-0.5b", "decode_32k",
                   config_patch={"attn": {"kv_cache_quant": True}},
                   rules_patch={"replicate_below": 64e6},
                   verbose=False, variant="int8kv_replsmall"))


if __name__ == "__main__":
    which = os.environ.get("PAIR", "all")
    if which in ("all", "1"):
        pair1()
    if which in ("all", "2"):
        pair2()
    if which in ("all", "3"):
        pair3()
