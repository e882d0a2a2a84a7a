"""On the card: one short run of a cell through `perfbench/run.py`, and
it is correct. Skips without a CUDA device."""
import json
import subprocess
import sys

import pytest
import torch

from perfbench.harness import spec


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen2-0.5b.tenants1k", "--seed", "2147483999",
                        "--seconds", "8", "--trace", "1"], cwd=spec.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert "flash_prefill_roofline" in line["metrics"]
