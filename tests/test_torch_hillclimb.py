"""``experiments/hillclimb_torch.py`` against ``experiments/hillclimb.py``.

The reference script is read, never imported: importing it sets
``XLA_FLAGS`` and imports the JAX dry-run. Both are parsed with ``ast``:

* the nine ``run_combo`` calls (arch, shape, ``config_patch``,
  ``rules_patch``, ``variant``, ``verbose``) and the tag each is shown
  under are equal, pair by pair;
* ``show`` prints the same line for the same result, and the ``__main__``
  block selects pairs as the reference's does (``PAIR`` from the
  environment, default ``all``; the reference resets ``sys.argv`` first,
  so its ``[pair]`` argument is never read);
* one pair runs on the port (mamba2-130m decode_32k, baseline against
  ``replicate_below``) in a subprocess with its own fake process group,
  the results in a temporary directory: the fields ``show`` reads, the
  variant names, and a collective term the rules patch moves.
"""
import ast
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
REFERENCE = ROOT / "experiments" / "hillclimb.py"
PORT = ROOT / "experiments" / "hillclimb_torch.py"


def _module(path):
    return ast.parse(path.read_text(), str(path))


def _calls(path):
    """{pair: [(tag, run_combo args, run_combo kwargs)]} in call order."""
    out = {}
    for fn in _module(path).body:
        if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("pair")):
            continue
        rows = out.setdefault(fn.name, [])
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "show"):
                tag, combo = node.args
                assert combo.func.id == "run_combo"
                rows.append((ast.literal_eval(tag),
                             [ast.literal_eval(a) for a in combo.args],
                             {k.arg: ast.literal_eval(k.value)
                              for k in combo.keywords}))
    return out


def _function(path, name):
    """Compile one top-level function of ``path`` alone."""
    fn = next(n for n in _module(path).body
              if isinstance(n, ast.FunctionDef) and n.name == name)
    ns = {}
    exec(compile(ast.Module([fn], []), str(path), "exec"), ns)
    return ns[name]


def _main_block(path):
    node = next(n for n in _module(path).body if isinstance(n, ast.If)
                and "__name__" in ast.unparse(n.test))
    return node.body


def test_nine_calls_equal_the_reference():
    want, got = _calls(REFERENCE), _calls(PORT)
    assert sorted(want) == ["pair1", "pair2", "pair3"]
    assert sum(len(v) for v in want.values()) == 9
    assert got == want


def test_show_prints_the_reference_line():
    result = {"roofline": {"compute_s": 1.234e-4, "memory_s": 5.5e-3,
                           "collective_s": 9.04e-4},
              "dominant": "memory_s", "useful_flops_ratio": 0.9471}
    lines = []
    for path in (REFERENCE, PORT):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert _function(path, "show")("tag", result) is result
        lines.append(buf.getvalue())
    assert lines[0] == lines[1] and "dom=memory_s" in lines[0]


def test_pair_selection_equals_the_reference():
    """The port's ``__main__`` block is the reference's without the dead
    ``sys.argv`` read (``experiments/hillclimb.py``, its first line)."""
    want, got = _main_block(REFERENCE), _main_block(PORT)
    assert "sys.argv" in ast.unparse(want[0])
    assert [ast.dump(n) for n in got] == [ast.dump(n) for n in want[1:]]
    assert "os.environ.get('PAIR', 'all')" in ast.unparse(got[0])


# calls of the port script, through its own ``show`` and ``run_combo``;
# argv[1]: the calls, argv[2]: the result directory, argv[3]: the script
_PAIR = r"""
import importlib.util, json, sys
spec = importlib.util.spec_from_file_location("hillclimb_torch", sys.argv[3])
hc = importlib.util.module_from_spec(spec)
spec.loader.exec_module(hc)
from repro_torch.launch import dryrun
dryrun.OUT_DIR = sys.argv[2]
for tag, args, kwargs in json.loads(sys.argv[1]):
    r = hc.show(tag, hc.run_combo(*args, **kwargs))
    print("RESULT:" + json.dumps(r), flush=True)
"""


def test_mamba2_pair_runs_on_the_port(tmp_path):
    calls = _calls(PORT)["pair2"][:2]
    assert [c[2]["variant"] for c in calls] == ["baseline", "replsmall"]
    # one thread: fake tensors compute nothing, and the suite's other
    # workers share the cores; each call in its own process (its own
    # fake process group), side by side
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PAIR, json.dumps([call]), str(tmp_path),
         str(PORT)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env, cwd=ROOT) for call in calls]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
    lines = [l for out, _ in outs for l in out.splitlines()]
    shown = [l for l in lines if l.startswith("mamba2/")]
    base, repl = [json.loads(l[len("RESULT:"):]) for l in lines
                  if l.startswith("RESULT:")]
    assert [s.split(" comp=")[0].strip() for s in shown] == [
        c[0] for c in calls]
    for r, (_, args, kwargs) in zip((base, repl), calls):
        assert (r["arch"], r["shape"], r["status"], r["variant"]) == (
            *args, "ok", kwargs["variant"])
        assert set(r["roofline"]) >= {"compute_s", "memory_s",
                                      "collective_s"}
        assert r["dominant"] in r["roofline"]
        assert 0 < r["useful_flops_ratio"] <= 1
    # replicating the small weights moves the collectives, not the work
    assert repl["roofline"]["collective_s"] != base["roofline"]["collective_s"]
    assert repl["flops"] == base["flops"]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "mamba2-130m__decode_32k__16x16__baseline.json",
        "mamba2-130m__decode_32k__16x16__replsmall.json"]
