"""``tools/trace_report_torch.py`` against ``tools/trace_report.py``.

A trace from a CPU serve of the port (paged KV under preemption churn,
so the report's arena peak and scheduler sections have rows, and one
under ``dlora``, with its merge switches), exported to JSON, goes
through both tools: as subprocesses, stdout and the exit code are equal
byte for byte; in process, the report at another ``--top`` and the
refusals of a missing file, invalid JSON and a trace without its raw
section are equal too.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))  # tools/ from the root

from repro_torch import bridge  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.trace import EngineTracer  # noqa: E402
from tools import trace_report, trace_report_torch  # noqa: E402

from test_torch_engine import _FakeTime  # noqa: E402
from test_torch_policies import (Weights, configs, ecfg_kwargs,  # noqa: E402
                                 one_torch_thread,  # noqa: F401 (fixture)
                                 trace_kwargs)

# (policy, kv, engine settings, workload settings): tests/test_trace.py's
# preemption churn (an arena of ten 8-token pages under four slots), and
# dlora's merged and unmerged steps
SERVES = {
    "churn": ("edgelora", "paged",
              dict(n_slots=4, max_ctx=64, kv_block_size=8,
                   kv_arena_blocks=10),
              dict(seed=1, rate=16.0, duration=1.0, input_range=(8, 24),
                   output_range=(24, 39))),
    "dlora": ("dlora", "dense", {}, {}),
}


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    """{serve: path of its exported trace}, each from a port serve under
    a fake timer."""
    weights = Weights(5)
    _, tcfg = configs()
    out = {}
    for name, (policy, kv, ekw, wkw) in SERVES.items():
        tracer = EngineTracer()
        eng = torch_engine.EdgeLoRAEngine(
            tcfg, torch_engine.EngineConfig(**ecfg_kwargs(policy, kv, **ekw)),
            params=bridge.tree_from_numpy(weights.params), tracer=tracer,
            device="cpu", timer=_FakeTime(),
            adapter_source=lambda aid: bridge.lora_pool_from_numpy(
                weights.adapters[aid]))
        eng.serve(workload.generate_trace(workload.WorkloadConfig(
            **trace_kwargs(tcfg, **wkw))))
        path = tmp_path_factory.mktemp("trace") / f"{name}.json"
        tracer.export(path)
        out[name] = path
    return out


TOOLS = ("trace_report.py", "trace_report_torch.py")


@pytest.fixture(scope="module")
def reports(traces):
    """{serve: [(exit code, stdout, stderr) of each of TOOLS]}, every
    tool on every trace in subprocesses side by side."""
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT}",
               OMP_NUM_THREADS="1")
    procs = {(serve, tool): subprocess.Popen(
        [sys.executable, f"tools/{tool}", str(path)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for serve, path in traces.items() for tool in TOOLS}
    outs = {key: p.communicate(timeout=240) for key, p in procs.items()}
    return {serve: [(procs[serve, tool].returncode, *outs[serve, tool])
                    for tool in TOOLS] for serve in traces}


@pytest.mark.parametrize("serve", sorted(SERVES))
def test_report_equals_the_reference_tool(reports, serve):
    want, got = reports[serve]
    assert want[0] == got[0] == 0, (want[2], got[2])
    assert got[1] == want[1]
    got = got[1]
    assert got.startswith("# trace: policy=")
    if serve == "churn":
        assert "arena_peak_blocks=" in got and "preempt=" in got


def _main(module, args):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main([str(a) for a in args])
    return rc, out.getvalue(), err.getvalue()


def test_top_and_refusals_equal_the_reference(traces, tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    stripped = tmp_path / "stripped.json"
    data = json.loads(traces["churn"].read_text())
    data.pop("edgelora")
    stripped.write_text(json.dumps(data))
    cases = [[traces["dlora"], "--top", "2"], [traces["churn"], "--top", "1"],
             [tmp_path / "missing.json"], [bad], [stripped]]
    for args in cases:
        want = _main(trace_report, args)
        assert _main(trace_report_torch, args) == want, args
    assert [_main(trace_report_torch, a)[0] for a in cases] == [0, 0, 1, 1, 1]
