"""What the harness loads, what it refuses to run without, and that a
new cell, configuration, traffic mix or metric is found by its name."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from cpu_cell import small_cell
from perfbench.harness import bench, spec

ROOT = spec.ROOT
ENV = {**os.environ, "OMP_NUM_THREADS": "2", "PYTHONPATH": ""}


def _python(code: str, cwd=ROOT) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=ENV,
                          capture_output=True, text=True, timeout=600)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r},
                {str(ROOT / 'perfbench' / 'tests')!r}]
import torch
torch.set_num_threads(2)
from cpu_cell import small_cell
from perfbench.harness import bench
from perfbench.run import forbidden_modules
out = bench.run(small_cell('qwen2-0.5b.tenants1k'), seed=3, seconds=1.0,
                trace=True, device='cpu', t_process=0.0, log=lambda m: None)
assert out['correct'], out
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print('FORBIDDEN', forbidden_modules())
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr[-3000:]
    tops = r.stdout.splitlines()[-2]
    assert "repro_torch" in tops
    assert r.stdout.splitlines()[-1] == "FORBIDDEN []"


def test_the_reference_loads_nothing_of_the_program():
    paths = sorted((ROOT / "perfbench" / "reference").glob("*.py"))
    assert paths
    for path in paths:
        code = f"""
import sys, importlib.util
spec = importlib.util.spec_from_file_location('ref', {str(path)!r})
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""
        r = _python(code, cwd=path.parent)
        assert r.returncode == 0, r.stderr[-3000:]
        tops = r.stdout.strip()
        for bad in ("repro_torch", "repro'", "jax", "perfbench"):
            assert bad not in tops, tops


def test_forbidden_names_are_compared_whole():
    from perfbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_extra"] = sys
        sys.modules["jaxlike.sub"] = sys
        assert run.forbidden_modules() == []
        sys.modules["repro.serving"] = sys
        assert run.forbidden_modules() == ["repro"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_without_cuda_it_exits_nonzero_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "sc2-7b.longctx", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""
    assert "needs 1 CUDA device" in r.stderr


def test_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    r = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "qwen2-0.5b.tenants1k", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=tmp_path, env=ENV,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_new_cell_config_traffic_and_metric_are_found_by_name(tmp_path):
    """Files dropped into the benchmark's folders, and entries added to
    BENCHMARK.json, are enough: no existing file changes."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    before = {p: p.read_bytes() for p in (tmp_path / "perfbench").rglob("*")
              if p.is_file()}
    base = small_cell("qwen2-0.5b.tenants1k")
    pb = tmp_path / "perfbench"
    (pb / "configs" / "tiny-new.json").write_text(json.dumps(
        {**base.config, "name": "tiny-new"}))
    (pb / "traffic" / "newmix.json").write_text(json.dumps(base.traffic))
    (pb / "checks" / "tiny-new.newmix.json").write_text(json.dumps(
        {"sample_requests": 5, "widest_logit_gap": 0.15}))
    (pb / "metrics" / "new_probe_count.py").write_text(
        "def read(run):\n    return float(len(run.rec.steps))\n")
    bench_json = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench_json["configs"].append(
        {"name": "tiny-new", "source": "test", "reduced": [], "why": "test",
         "file": "perfbench/configs/tiny-new.json"})
    bench_json["workloads"].append(
        {"name": "tiny-new.newmix", "config": "tiny-new",
         "traffic": "newmix", "chips": 1, "why": "test"})
    bench_json["per_layer"].append(
        {"name": "new_probe_count", "unit": "steps", "better": "higher",
         "source": "program_span", "layer": "engine loop",
         "moves": "prompt_tokens_per_s", "workloads": ["tiny-new.newmix"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))

    cell = spec.load_cell("tiny-new.newmix", root=tmp_path)
    assert cell.root == tmp_path and cell.config["name"] == "tiny-new"
    torch.set_num_threads(2)
    out = bench.run(cell, seed=4, seconds=1.0, trace=True, device="cpu",
                    t_process=0.0, log=lambda m: None)
    assert out["correct"] is True
    assert out["metrics"]["new_probe_count"]["value"] > 0
    for p, data in before.items():
        assert p.read_bytes() == data, p
