"""Each cell runs end to end at a CPU size and gives the result line the
contract asks for, correct, in both modes."""
import json

import pytest
import torch

from cpu_cell import small_cell
from perfbench.harness import bench, spec

CELLS = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
# per-layer metrics a CPU run can read (no kernel events, no peaks)
CPU_LAYER = {"host_outside_steps_pct", "prefill_step_ms", "decode_step_ms",
             "prefill_step_ms.rate", "pool_hit_pct",
             "ttft_p90_ms.pool", "device_idle_pct"}


def run_small(name, trace, seed=2 ** 31 + 11, seconds=1.5, **checks):
    torch.set_num_threads(2)
    return bench.run(small_cell(name, **checks), seed=seed, seconds=seconds,
                     trace=trace, device="cpu", t_process=0.0,
                     log=lambda m: None)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_and_prints_the_result_line(name, trace):
    out = run_small(name, trace)
    line = json.loads(json.dumps(out))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True
    assert line["attempted"] > 0 and line["failed"] == 0
    cell = spec.load_cell(name)
    if trace:
        want = {m["name"] for m in cell.per_layer} & CPU_LAYER
        assert line["device"]["busy_s"] > 0
        assert line["device"]["window_s"] > 0
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        want = {m["name"] for m in cell.end_to_end}
    assert want <= set(line["metrics"])
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    for k, v in line["metrics"].items():
        assert v["unit"] == units[k] and v["value"] > 0 or k == "pool_hit_pct"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}


def test_same_seed_same_requests():
    cell = small_cell(CELLS[0])
    a = bench.requests_for(cell, 2 ** 31 + 5, 2.0)
    b = bench.requests_for(cell, 2 ** 31 + 5, 2.0)
    c = bench.requests_for(cell, 2 ** 31 + 6, 2.0)
    key = [(r.prompt_len, r.output_len, r.adapter_id,
            r.prompt_tokens.tobytes()) for r in a]
    assert key == [(r.prompt_len, r.output_len, r.adapter_id,
                    r.prompt_tokens.tobytes()) for r in b]
    assert key != [(r.prompt_len, r.output_len, r.adapter_id,
                    r.prompt_tokens.tobytes()) for r in c]
    # stratified: every seed draws the same spread of lengths per block
    assert sorted(r.output_len for r in a) == sorted(r.output_len for r in c)
