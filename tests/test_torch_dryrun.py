"""The port's dry-run layer (``launch/analysis.py``, ``launch/dryrun.py``,
``launch/report.py``) against the reference's.

Analysis: the counterparts of ``tests/test_sharding_analysis.py``'s
three ``jaxpr_cost`` tests (a loop of matmuls counted by its trips, a
gradient through checkpointed layers counted ≥ 3.5× its forward, a
matmul's bytes with and without fusion), then ``step_cost`` of reduced
llama3-8b, mamba2 and dbrx steps against the reference's ``jaxpr_cost``
of the same steps, both at the reference's 32 MB cutoff:

* ``mxu_flops``: the prefill and decode steps equal the reference's once
  its dot_generals with a contraction of 1 are set aside. Those are
  outer and batched elementwise products (the SSD's
  ``einsum('bh,bhp,bhn->bhpn')`` and its chunked form, mamba2 only):
  ``jnp.einsum`` lowers them to dot_general, ``torch.einsum`` to a
  broadcast multiply, so the port counts them as elementwise (VPU)
  work. The train step (remat on) differs by two things, computed from
  the config below: JAX's grad jaxpr keeps the cotangent of the first
  layer's input (the embedding output, which nothing consumes: its q, k,
  v projections' and LoRA shrinks' input gradients) where torch's
  autograd never computes it, and ``torch.utils.checkpoint`` reruns a
  group's whole forward where JAX recomputes only what the backward
  reads (llama3-8b: each group's MLP down projection again). mamba2's
  train step is not held: the two autodiffs differentiate the SSD's
  einsums into matmuls of other shapes (2.6 % fewer flops in the port on
  the reduced config); its prefill and decode steps are held.
* ``bytes``: the decode step within 3 % of the reference's; prefill
  between 0.50× and 0.80× of it, train between 0.45× and 0.60×. The
  readings (torch 2.13, jax as installed): prefill 0.746 / 0.531 /
  0.686, decode 0.994 / 1.019 / 0.986 (llama3-8b / mamba2 / dbrx),
  train 0.559 / 0.485 (llama3-8b / dbrx). The reference's scan bodies start
  each iteration with nothing fused, so the residual stream and every
  carried value are charged again at each consumer in each layer, and
  its transposes and slices are moves; the port's loop keeps small
  values fused from one layer to the next, and its transposes and slices
  are views.

Pipeline: the reference's four ``test_dryrun_pipeline_small_mesh``
cases and a whisper train case on a 2×4 fake mesh with a reduced
config: flops, bytes and args/dev above 0, the replicate fallback's
collective bytes a part of the total, and args/dev equal to Σ leaf bytes
/ shards from the reference's ``param_specs`` on its ``eval_shape``
trees. One full combo (mamba2-130m × decode_32k on the 16×16 mesh)
through ``run_combo`` and its JSON. All of them run in one subprocess
(its own fake process group), one after another. Then the report's
tables from result files.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.core.lora import LoRAMode as JaxLoRAMode  # noqa: E402
from repro.distributed import sharding as JS  # noqa: E402
from repro.launch.analysis import jaxpr_cost  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.launch import report  # noqa: E402
from repro_torch.launch.analysis import step_cost  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import optimizer, train  # noqa: E402

from test_torch_model import numpy_lora, numpy_params, to_jax  # noqa: E402
from test_torch_policies import one_torch_thread  # noqa: E402,F401 (fixture)
from test_torch_training import configs  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_CUTOFF = 32e6       # the reference's jaxpr_cost default (TPU VMEM)


# ---------------------------------------------------------------------------
# analysis: the reference's jaxpr_cost tests
# ---------------------------------------------------------------------------


def test_step_cost_counts_loop_trips():
    def f(x, w):
        for wi in w:
            x = x @ wi
        return x

    cost = step_cost(f, torch.ones(64, 64), torch.ones(10, 64, 64))
    assert cost["mxu_flops"] == 2 * 64 * 64 * 64 * 10


def test_step_cost_counts_grad_and_remat():
    from torch.utils.checkpoint import checkpoint

    def loss_grad(w, x):
        w = w.detach().requires_grad_(True)
        c = x
        for wi in w:
            c = checkpoint(lambda c, wi: torch.tanh(c @ wi), c, wi,
                           use_reentrant=False)
        return torch.autograd.grad(torch.sum(c ** 2), w)

    cost = step_cost(loss_grad, torch.randn(8, 64, 64) / 8,
                     torch.randn(16, 64))
    fwd = 2 * 16 * 64 * 64 * 8
    # fwd + remat-fwd + 2 backward GEMMs (dx and dW) ≈ 4x fwd
    assert cost["mxu_flops"] >= 3.5 * fwd


def test_step_cost_dot_bytes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(1024, 4096, dtype=torch.bfloat16)
        w = torch.empty(4096, 8192, dtype=torch.bfloat16)
    cost = step_cost(torch.matmul, x, w, n_chips=1, fused_cutoff=0)
    expect = 2 * (1024 * 4096 + 4096 * 8192 + 1024 * 8192)
    assert cost["bytes"] == expect
    # with the default cutoff (the H100's 50 MB L2) the 16MB output is
    # treated as fused
    assert step_cost(torch.matmul, x, w, n_chips=1)["bytes"] == 2 * (
        1024 * 4096 + 4096 * 8192)


def test_elided_attention_blocks_count_as_every_block():
    """Under ``elide_repeats`` (the dry-run's serving steps) the plain
    blockwise attention runs one (q block, kv block) iteration that
    counts for all 4 × 4: the same flops and bytes as running them all,
    and an output of the same shape."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import attention
    from repro_torch.models.layers import elide_repeats

    cfg = reduced_config(get_config("llama3-8b"))
    # the masks the loop builds from positions are real
    with FakeTensorMode(allow_non_fake_inputs=True):
        q = torch.empty(2, 64, 4, 16)
        k = torch.empty(2, 64, 2, 16)
        v = torch.empty(2, 64, 2, 16)
    pos = torch.arange(64)

    def attend(q, k, v):
        return attention.blockwise_attention(
            q, k, v, pos, pos, kind="global", cfg=cfg, block_q=16,
            block_kv=16)

    with torch.no_grad():
        full = step_cost(attend, q, k, v, fused_cutoff=1e4)
        with elide_repeats():
            one = step_cost(attend, q, k, v, fused_cutoff=1e4)
    assert one["out"].shape == full["out"].shape == (2, 64, 4, 16)
    for key in ("mxu_flops", "vpu_flops", "bytes"):
        assert one[key] == full[key] > 0, key


def test_elision_refuses_real_tensors():
    """``elide_repeats`` around a step on real tensors raises, where one
    iteration standing for all would return wrong values."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import attention
    from repro_torch.models.layers import elide_repeats

    cfg = reduced_config(get_config("llama3-8b"))
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 64, 4, 16, generator=gen)
    k = torch.randn(2, 64, 2, 16, generator=gen)
    pos = torch.arange(64)
    with torch.no_grad(), elide_repeats():
        with pytest.raises(RuntimeError, match="real tensors"):
            attention.blockwise_attention(q, k, k, pos, pos, kind="global",
                                          cfg=cfg, block_q=16, block_kv=16)


# ---------------------------------------------------------------------------
# analysis: reduced steps against the reference's jaxpr_cost
# ---------------------------------------------------------------------------


def _contract1_flops(jaxpr, mult=1.0):
    """Flops of the reference's dot_generals with a contraction of 1
    (scan bodies × their length, as ``jaxpr_cost`` counts)."""
    total = 0.0
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name == "dot_general":
            (lc, _), _ = eqn.params["dimension_numbers"]
            lhs = eqn.invars[0].aval
            if math.prod(lhs.shape[d] for d in lc) == 1:
                total += mult * 2.0 * math.prod(eqn.outvars[0].aval.shape)
        elif name == "scan":
            total += _contract1_flops(eqn.params["jaxpr"].jaxpr,
                                      mult * eqn.params["length"])
        else:
            for v in eqn.params.values():
                for item in (v if isinstance(v, (tuple, list)) else (v,)):
                    inner = getattr(item, "jaxpr", None)
                    if inner is not None or hasattr(item, "eqns"):
                        inner = getattr(inner, "jaxpr", inner) or item
                        total += _contract1_flops(
                            inner if hasattr(inner, "eqns") else item, mult)
    return total


class _Steps:
    """One reduced f32 model in both packages on bridged weights, a pool
    of adapters and a single train adapter."""

    B, S = 2, 32

    def __init__(self, arch):
        jcfg, tcfg = configs(arch)
        self.cfg = tcfg
        self.jm, self.tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
        params = numpy_params(self.jm)
        pool = numpy_lora(self.jm, n_slots=jcfg.lora.max_resident)
        self.lora = numpy_lora(self.jm)
        self.jp, self.jpool = to_jax(params, jnp.float32), to_jax(
            pool, jnp.float32)
        self.tp = bridge.params_from_numpy(self.tm, params)
        self.tpool = bridge.lora_pool_from_numpy(pool)
        rng = np.random.default_rng(0)
        self.tokens = rng.integers(0, tcfg.vocab_size,
                                   (self.B, self.S + 1)).astype(np.int32)
        self.slots = np.array([1, 3], np.int32)
        self.pos = np.array([5, 9], np.int32)

    def ref(self, kind):
        jm, sc = self.jm, self.cfg.lora.scale
        slots = jnp.asarray(self.slots)
        if kind == "prefill":
            jx = jax.make_jaxpr(lambda p, po, t, c: jm.prefill(
                p, {"tokens": t}, c, po,
                JaxLoRAMode("batched", slots, sc, "einsum", False)))(
                self.jp, self.jpool, jnp.asarray(self.tokens[:, :-1]),
                jm.init_cache(self.B, 64))
        elif kind == "decode":
            jx = jax.make_jaxpr(lambda p, po, t, c: jm.decode_step(
                p, t, c, jnp.asarray(self.pos), po,
                JaxLoRAMode("batched", slots, sc, "einsum", False)))(
                self.jp, self.jpool, jnp.asarray(self.tokens[:, 0]),
                jm.init_cache(self.B, 64))
        else:
            jl = to_jax(self.lora, jnp.float32)
            step = jax_train.make_train_step(jm, remat=True, peak_lr=1e-3,
                                             warmup=1, total_steps=4)
            jx = jax.make_jaxpr(step)(
                jax_train.TrainState(self.jp, jl, jax_opt.adamw_init(jl)),
                {"tokens": jnp.asarray(self.tokens)})
        cost = jaxpr_cost(jx, n_chips=1, vmem_cutoff=REF_CUTOFF)
        return cost, _contract1_flops(jx.jaxpr)

    def port(self, kind):
        tm, sc = self.tm, self.cfg.lora.scale
        mode = LoRAMode("batched", torch.from_numpy(self.slots), sc,
                        "einsum")
        kw = dict(n_chips=1, fused_cutoff=REF_CUTOFF)
        # arguments made outside the count, as the reference's are
        # arguments of its jaxpr
        cache = tm.init_cache(self.B, 64)
        if kind == "prefill":
            with torch.no_grad():
                return step_cost(lambda p, t, c, po: tm.prefill(
                    p, {"tokens": t}, c, po, mode), self.tp,
                    torch.from_numpy(self.tokens[:, :-1]), cache,
                    self.tpool, **kw)
        if kind == "decode":
            with torch.no_grad():
                return step_cost(lambda p, t, c, po: tm.decode_step(
                    p, t, c, torch.from_numpy(self.pos), po, mode),
                    self.tp, torch.from_numpy(self.tokens[:, 0]), cache,
                    self.tpool, **kw)
        tl = bridge.lora_pool_from_numpy(self.lora)
        step = train.make_train_step(tm, remat=True, peak_lr=1e-3, warmup=1,
                                     total_steps=4)
        return step_cost(step, train.TrainState(self.tp, tl,
                                                optimizer.adamw_init(tl)),
                         {"tokens": torch.from_numpy(self.tokens)}, **kw)


@pytest.fixture(scope="module", params=["llama3-8b", "mamba2-130m",
                                        "dbrx-132b"])
def steps(request):
    return _Steps(request.param)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_serving_step_cost_matches_reference(steps, kind):
    ref, contract1 = steps.ref(kind)
    got = steps.port(kind)
    assert got["mxu_flops"] == ref["mxu_flops"] - contract1, (
        got["mxu_flops"], ref["mxu_flops"], contract1)
    if steps.cfg.ssm is None:
        assert contract1 == 0
    ratio = got["bytes"] / ref["bytes"]
    if kind == "decode":
        assert abs(ratio - 1) <= 0.03, ratio
    else:
        assert 0.50 <= ratio <= 0.80, ratio


@pytest.mark.parametrize("steps", ["llama3-8b", "dbrx-132b"], indirect=True)
def test_train_step_cost_matches_reference(steps):
    cfg = steps.cfg
    ref, _ = steps.ref("train")
    got = steps.port("train")
    t, d, r = steps.B * steps.S, cfg.d_model, cfg.lora.rank
    # the first layer's input cotangent, in JAX's grad jaxpr only: the
    # q, k, v projections' dx (out [T, d], contracting q/kv widths) and
    # their LoRA shrinks' dx (contracting r)
    dead = 2 * t * d * (cfg.q_size + 2 * cfg.kv_size) + 3 * 2 * t * d * r
    # torch.utils.checkpoint reruns each group's MLP down projection,
    # whose output no backward op reads (not on MoE slots: their experts
    # are recomputed by both)
    rerun = 0 if cfg.moe is not None else (
        cfg.n_layers * 2 * t * d * cfg.d_ff)
    assert got["mxu_flops"] == ref["mxu_flops"] - dead + rerun
    assert 0.45 <= got["bytes"] / ref["bytes"] <= 0.60


# ---------------------------------------------------------------------------
# the pipeline on a 2x4 fake mesh (subprocesses)
# ---------------------------------------------------------------------------

PIPELINE_CASES = [
    ("qwen2-0.5b", "train", 64, 4),
    ("qwen2-0.5b", "decode", 128, 8),
    ("mamba2-130m", "decode", 128, 8),
    ("dbrx-132b", "prefill", 64, 4),
    ("whisper-medium", "train", 64, 4),
]

# every pipeline case on one 2x4 mesh, then the full 16x16 combos through
# run_combo (their JSON in argv[2])
_PIPELINE = r"""
import json, sys
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun, mesh as M
from repro_torch.launch.analysis import step_cost

mesh = M.make_mesh((2, 4), ("data", "model"))
for arch, kind, seq, batch in json.loads(sys.argv[1]):
    cfg = reduced_config(get_config(arch))
    shape = InputShape("tiny_" + kind, seq, batch, kind)
    with dryrun.traced(mesh, train=kind == "train") as rec:
        with rec["fake"]:
            fn, kwargs = dryrun.input_specs(cfg, shape, mesh)
        args_dev = dryrun._arg_bytes_per_device(kwargs, mesh)
        jc = step_cost(fn, n_chips=8, **kwargs)
    out = {"flops": jc["mxu_flops"], "bytes": jc["bytes"],
           "coll": rec["collectives"]["total"],
           "fallback": rec["collectives"]["fallback"], "args_dev": args_dev,
           "replicated": rec["replicated_ops"]}
    print("RESULT:" + json.dumps(["-".join(map(str, (arch, kind, seq,
                                                     batch))), out]),
          flush=True)
M.release_mesh()
dryrun.OUT_DIR = sys.argv[2]
combos = [dryrun.run_combo("mamba2_130m", "decode_32k", verbose=False),
          dryrun.run_combo("qwen2_0_5b", "long_500k", verbose=False)]
print("RESULT:" + json.dumps(["combos", combos]), flush=True)
"""


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """{case id: result, 'combos': [mamba2 decode_32k, qwen2 long_500k],
    'out_dir': run_combo's result directory}, from one subprocess."""
    out_dir = tmp_path_factory.mktemp("dryrun_torch")
    # one thread: fake tensors compute nothing, and the suite's other
    # workers (real-timer serves among them) share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-c", _PIPELINE, json.dumps(PIPELINE_CASES),
         str(out_dir)], capture_output=True, text=True, timeout=600,
        env=env, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = dict(json.loads(l[len("RESULT:"):])
               for l in proc.stdout.splitlines() if l.startswith("RESULT:"))
    res["out_dir"] = out_dir
    return res


class FakeMesh:
    shape = {"data": 2, "model": 4}


def _resident(tree, mesh=FakeMesh()):
    """Σ leaf bytes / shards under the reference's ``param_specs``."""
    specs = jax.tree_util.tree_leaves(JS.param_specs(tree, mesh),
                                      is_leaf=lambda s: isinstance(s, JP))
    return sum(_per_device(leaf, spec, mesh)
               for leaf, spec in zip(jax.tree_util.tree_leaves(tree), specs))


def _per_device(leaf, spec, mesh=FakeMesh()):
    n = 1
    for entry in spec:
        for a in ((entry,) if isinstance(entry, str) else (entry or ())):
            n *= mesh.shape[a]
    return math.prod(leaf.shape) * jnp.dtype(leaf.dtype).itemsize / n


def _reference_args_dev(arch, kind, seq, batch):
    """The per-device bytes of the reference's dry-run arguments for a
    reduced config on a (data 2, model 4) mesh: its ``input_specs`` trees
    from ``eval_shape``, placed by its ``param_specs``."""
    jm = jax_build_model(jax_reduced_config(jax_get_config(arch)))
    cfg, key = jm.cfg, jax.random.PRNGKey(0)
    bspec = ("data",) if batch % 2 == 0 else None
    sds = jax.ShapeDtypeStruct
    total = _resident(jax.eval_shape(jm.init, key))
    if kind == "train":
        lora = jax.eval_shape(jm.init_lora, key)
        total += 3 * _resident(lora)                  # lora, mu, nu
        total += 4                                    # the int32 step
        total += _per_device(sds((batch, seq + 1), jnp.int32),
                             (bspec, None))
        if cfg.encoder is not None:
            total += _per_device(sds((batch, cfg.encoder.n_frames,
                                      cfg.d_model), jnp.bfloat16),
                                 (bspec, None, None))
        return total
    total += _resident(jax.eval_shape(lambda k: jm.init_lora(
        k, n_slots=cfg.lora.max_resident, dtype=jnp.bfloat16), key))
    total += _resident(jax.eval_shape(lambda: jm.init_cache(batch, seq)))
    vec = _per_device(sds((batch,), jnp.int32), (bspec,))
    if kind == "prefill":
        return total + _per_device(sds((batch, seq), jnp.int32),
                                   (bspec, None)) + vec
    return total + 3 * vec                            # tokens, pos, slots


@pytest.mark.parametrize("arch,kind,seq,batch", PIPELINE_CASES)
def test_dryrun_pipeline_small_mesh(pipeline, arch, kind, seq, batch):
    out = pipeline[f"{arch}-{kind}-{seq}-{batch}"]
    assert out["flops"] > 0
    assert out["bytes"] > 0
    assert out["args_dev"] > 0
    assert 0 <= out["fallback"] <= out["coll"]
    assert out["args_dev"] == _reference_args_dev(arch, kind, seq, batch)


def test_long_500k_skips_as_the_reference():
    from repro.configs import ARCH_IDS
    from repro_torch.launch import dryrun
    assert dryrun.LONG_OK == {a: jax_get_config(a).supports_long_context
                              for a in ARCH_IDS}


def test_run_combo_full_mesh(pipeline):
    r, s = pipeline["combos"]
    assert (r["status"], r["mesh"], r["n_chips"]) == ("ok", "16x16", 256)
    for key in ("trace_s", "arg_bytes_per_device", "flops", "vpu_flops",
                "hbm_bytes", "collectives", "roofline", "model_flops",
                "useful_flops_ratio", "dominant", "tokens",
                "replicated_ops", "collective_fallback_share",
                "dominant_without_fallback", "torch"):
        assert key in r, key
    assert r["tokens"] == 128 and r["flops"] > 0 and r["hbm_bytes"] > 0
    assert r["dominant"] in r["roofline"]
    assert r["dominant_without_fallback"] in r["roofline"]
    assert r["torch"] == torch.__version__
    assert set(r["collectives"]) >= {"all-gather", "all-reduce",
                                     "reduce-scatter", "all-to-all",
                                     "collective-permute", "count", "total",
                                     "fallback"}
    coll = r["collectives"]
    assert 0 <= coll["fallback"] <= coll["total"]
    assert r["collective_fallback_share"] == (
        coll["fallback"] / coll["total"] if coll["total"] else 0.0)
    assert s["status"] == "skipped"
    out_dir = pipeline["out_dir"]
    saved = sorted(p.name for p in out_dir.iterdir())
    assert saved == ["mamba2_130m__decode_32k__16x16.json",
                     "qwen2_0_5b__long_500k__16x16.json"]
    assert json.loads((out_dir / saved[0]).read_text()) == r


def test_report_tables(tmp_path, monkeypatch):
    monkeypatch.setattr(report, "OUT_DIR", str(tmp_path))
    rows = [
        {"arch": "mamba2_130m", "shape": "decode_32k", "mesh": "16x16",
         "status": "ok", "dominant": "collective_s",
         "useful_flops_ratio": 0.5, "arg_bytes_per_device": 2.5e9,
         "roofline": {"compute_s": 1e-4, "memory_s": 2e-3,
                      "collective_s": 3e-3},
         "collective_fallback_share": 0.75,
         "dominant_without_fallback": "memory_s", "torch": "2.13.0"},
        {"arch": "qwen2_0_5b", "shape": "long_500k", "mesh": "16x16",
         "status": "skipped"},
    ]
    for r in rows:
        (tmp_path / f"{r['arch']}__{r['shape']}__16x16.json").write_text(
            json.dumps(r))
    table = report.table("16x16")
    assert "H100" in table.splitlines()[0]
    assert "torch 2.13.0" in table.splitlines()[0]
    assert ("| mamba2_130m | decode_32k | 100.0µs | 2.00ms | 3.00ms | "
            "**collective** | 75.0% | memory | 0.50 | 2.50GB |") in table
    assert ("| qwen2_0_5b | long_500k | — | — | — | SKIP | — | — | — | — |"
            in table)
    assert report.summary_stats("16x16").startswith("Combos: 1 ok, 1 skipped")
