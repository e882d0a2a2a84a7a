"""The port's example scripts (``examples/*_torch.py``) against the
reference's (``examples/*.py``), on the same weights: the JAX package's,
carried across with ``repro_torch.bridge``; the reference side replays its
example's calls through ``repro`` (or runs the example itself, with its
config and engine patched).

* quickstart, on fan-in weights and adapters drawn with numpy (the
  example's own weights are ill-conditioned in f32, see
  ``test_quickstart_matches_reference_f32``): one batched forward, the
  per-request check and 8 greedy decode steps. In f32 the batched logits
  are within F32_TOL of max|logit| and the decoded tokens equal, on the
  engine's CPU route and on the kernel route's CPU (plain) versions; in
  bf16 the port's printed max err is within BF16_ERR_FACTOR of the
  reference's. The example's own pool write puts adapter i in slot i of
  every layer group.
* multi-tenant serve: the reference example itself and the port's, in
  f32 under a deterministic timer (``_FakeTime``): equal stdout, token
  streams and summaries under ``edgelora`` and ``edgelora_no_aas``, and
  the reference's ``llamacpp`` OOM message.
* SSM long context: the decode state's bytes equal (the example's bf16
  config and f32), and f32 logits at positions 10, 10 000 and 500 000
  within F32_TOL of max|logit|.
* training: 3 LoRA steps per task from the reference's
  ``init_train_state`` state, the train losses within F32_TOL
  (relative), as ``tests/test_torch_training.py`` holds a step, and the
  evaluation losses within F32_TOL on the reference's trained adapters;
  a 40-prompt router set; checkpoints round-trip bit-equal.
* the three scripts that finish in seconds run as ``--device cpu``
  subprocesses.
"""
import dataclasses
import functools
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.core.lora import LoRAMode as JaxLoRAMode  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.training import checkpoint, optimizer, train  # noqa: E402

from test_torch_engine import (_FakeTime, _adapter, _numpy_tree,  # noqa: E402
                               _param, _summary_json)
from test_torch_model import (numpy_lora, numpy_params, rel_err,  # noqa: E402
                              to_numpy)
from test_torch_policies import one_torch_thread  # noqa: E402,F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]
# f32 arithmetic of both packages in different orders: logits and losses
# within 1e-5 of their largest magnitude
F32_TOL = 1e-5
# bf16 rounding differs between XLA and torch (fusion, accumulation
# order), so the batched vs per-request error of one package is not the
# other's; the port's may be up to 4x the reference's on the same weights
BF16_ERR_FACTOR = 4.0


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


quickstart = _load("examples/quickstart_torch.py", "quickstart_torch")
multitenant = _load("examples/serve_multitenant_torch.py",
                    "serve_multitenant_torch")
ssm_example = _load("examples/serve_ssm_long_context_torch.py",
                    "serve_ssm_long_context_torch")
train_example = _load("examples/train_lora_adapter_torch.py",
                      "train_lora_adapter_torch")


def _configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                dtype=dtype),
            dataclasses.replace(reduced_config(get_config(arch)),
                                dtype=dtype))


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------


def _reference_quickstart(jm, params, pool, tokens):
    """``examples/quickstart.py`` after its weights, replayed (each call
    jitted: the example runs them eagerly)."""
    cfg = jm.cfg

    def mode(ids):
        return JaxLoRAMode("batched", ids, cfg.lora.scale)

    forward = jax.jit(lambda p, t, pl, ids: jm.forward(
        p, {"tokens": t}, pl, mode(ids))[0])
    prefill = jax.jit(lambda p, t, c, pl, ids: jm.prefill(
        p, {"tokens": t}, c, pl, mode(ids)))
    decode = jax.jit(lambda p, t, c, pos, pl, ids: jm.decode_step(
        p, t, c, pos, pl, mode(ids)))
    adapter_ids = jnp.array([0, 1, 2, 3], jnp.int32)
    logits = forward(params, tokens, pool, adapter_ids)
    worst = 0.0
    for i in range(4):
        ref = forward(params, tokens[i:i + 1], pool, adapter_ids[i:i + 1])
        worst = max(worst, float(jnp.max(jnp.abs(
            logits[i:i + 1].astype(jnp.float32) - ref.astype(jnp.float32)))))
    cache = jm.init_cache(4, 64)
    lg, cache = prefill(params, tokens, cache, pool, adapter_ids)
    tok = jnp.argmax(lg, -1).astype(jnp.int32)
    out = [tok]
    for step in range(8):
        lg, cache = decode(params, tok, cache,
                           jnp.full((4,), 16 + step, jnp.int32), pool,
                           adapter_ids)
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
        out.append(tok)
    return {"logits": np.asarray(logits.astype(jnp.float32)),
            "max_err": worst,
            "decoded": jnp.stack(out, 1)[:, :8].tolist()}


def _quickstart_pair(dtype):
    """Fan-in weights and a pool of nonzero adapters (numpy, in
    ``dtype``), tokens, and the reference's result on them."""
    jcfg, tcfg = _configs("llama3-8b", dtype)
    jm = jax_build_model(jcfg)
    cast = jnp.dtype(dtype)
    params = jax.tree.map(lambda a: np.asarray(a).astype(cast),
                          numpy_params(jm))
    pool = numpy_lora(jm, n_slots=4)
    tokens = np.array(jax.random.randint(jax.random.PRNGKey(2), (4, 16), 0,
                                         jcfg.vocab_size))
    want = _reference_quickstart(
        jm, jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, pool), jnp.asarray(tokens))
    return tcfg, params, pool, tokens, want


def _port_quickstart(tcfg, params, pool, tokens, kernel):
    """The port's ``run`` on the bridged weights: the engine's CPU route
    (einsum, plain attention) or the kernel route's wrappers (their plain
    versions on the CPU)."""
    model = build_model(tcfg, "cpu", attn_kernel=kernel)
    tparams = bridge.params_from_numpy(model, params)
    return quickstart.run(model, tparams, bridge.lora_pool_from_numpy(pool),
                          torch.from_numpy(tokens),
                          backend="sgmv" if kernel else None)


def test_quickstart_matches_reference_f32(capsys):
    """On fan-in weights. The example's own adapters (A + 0.01, B =
    0.01·(i + 1), at LoRA scale 16) drive the attention scores to ~3000,
    where f32 softmax is ill-conditioned: on them each package's logits
    lie 5e-6 to 2e-4 of max|logit| from an f64 forward, so no f32 bound
    between the two holds there; they are compared in bf16 below."""
    tcfg, params, pool, tokens, want = _quickstart_pair("float32")
    assert want["max_err"] <= F32_TOL * np.abs(want["logits"]).max()
    for kernel in (False, True):
        got = _port_quickstart(tcfg, params, pool, tokens, kernel)
        assert rel_err(got["logits"].numpy(), want["logits"]) <= F32_TOL
        assert got["decoded"] == want["decoded"], kernel
        assert got["max_err"] <= F32_TOL * np.abs(want["logits"]).max()
    out = capsys.readouterr().out
    assert "batched multi-adapter forward: logits (4, 16, 512)" in out
    assert f"decoded 8 tokens/tenant: {want['decoded']}" in out


def test_quickstart_bf16_error_near_reference(capsys):
    """bf16 on the same fan-in weights: the reference example printed
    7.031e-02 on its own draws and pool write (adapters 0 and 3 only);
    here both packages print theirs on one set of weights."""
    tcfg, params, pool, tokens, want = _quickstart_pair("bfloat16")
    got = _port_quickstart(tcfg, params, pool, tokens, kernel=False)
    with capsys.disabled():
        print(f"\nquickstart bf16 max err: port {got['max_err']:.3e}, "
              f"reference {want['max_err']:.3e}")
    assert got["max_err"] <= BF16_ERR_FACTOR * want["max_err"]
    assert f"max err {got['max_err']:.3e}" in capsys.readouterr().out


def test_quickstart_main_loads_each_adapter_into_its_slot(monkeypatch):
    """The example's own weights (seeded torch generators): adapter i,
    drawn from generator 100 + i and shifted by 0.01·(i + 1), is in slot i
    of every layer group."""
    seen = {}
    monkeypatch.setattr(quickstart, "run",
                        lambda model, params, pool, tokens: seen.update(
                            model=model, pool=pool, tokens=tokens))
    quickstart.main(["--device", "cpu"])
    model, pool = seen["model"], seen["pool"]
    assert not model.attn_kernel and seen["tokens"].shape == (4, 16)
    assert torch.equal(quickstart.draw(model)[2], seen["tokens"])
    for slot in range(4):
        adapter = model.init_lora(quickstart._generator("cpu", 100 + slot))
        for got, a in zip(optimizer.tree_leaves(pool),
                          optimizer.tree_leaves(adapter)):
            assert torch.equal(got[:, slot], a + 0.01 * (slot + 1))


# ---------------------------------------------------------------------------
# multi-tenant serving
# ---------------------------------------------------------------------------


def _recording(base, streams, summaries, **inject):
    """``base`` (an engine class) with ``inject`` passed to every engine,
    each serve's summary and token streams recorded by policy."""
    class Recording(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **{**kw, **inject})

        def serve(self, trace, *args, **kw):
            s = super().serve(trace, *args, **kw)
            streams[self.ecfg.policy] = [list(r.tokens) for r in trace]
            summaries[self.ecfg.policy] = _summary_json(s)
            return s
    return Recording


def test_serve_multitenant_matches_reference(monkeypatch, capsys):
    jcfg, tcfg = _configs("llama3-8b")
    jm = jax_build_model(jcfg)
    params = _numpy_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                         np.random.default_rng(0), _param)
    lora_shapes = jax.eval_shape(jm.init_lora, jax.random.PRNGKey(0))
    adapters = {aid: _numpy_tree(lora_shapes,
                                 np.random.default_rng(100 + aid),
                                 _adapter(jcfg.lora.rank))
                for aid in range(32)}

    ref = _load("examples/serve_multitenant.py", "ref_serve_multitenant")
    jstreams, jsums, tstreams, tsums = {}, {}, {}, {}
    monkeypatch.setattr(ref, "reduced_config", lambda c: dataclasses.replace(
        jax_reduced_config(c), dtype="float32"))
    monkeypatch.setattr(ref, "EdgeLoRAEngine", _recording(
        jax_engine.EdgeLoRAEngine, jstreams, jsums,
        params=jax.tree.map(jnp.asarray, params)))
    monkeypatch.setattr(jax_engine.EdgeLoRAEngine, "_adapter_host",
                        lambda self, aid: jax.tree.map(jnp.asarray,
                                                       adapters[aid]))
    monkeypatch.setattr("repro.serving.engine.time", _FakeTime())
    ref.main()
    want = capsys.readouterr().out

    monkeypatch.setattr(multitenant, "EdgeLoRAEngine", _recording(
        torch_engine.EdgeLoRAEngine, tstreams, tsums))
    trace, results = multitenant.run(
        tcfg, "cpu", params=bridge.tree_from_numpy(params),
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(adapters[aid]),
        timer=_FakeTime())
    got = capsys.readouterr().out

    assert got == want, (got, want)
    assert sorted(jsums) == sorted(tsums) == ["edgelora", "edgelora_no_aas"]
    assert jstreams == tstreams and jsums == tsums
    assert len(trace) == 20 and all(r.tokens for r in trace)
    oom = results["llamacpp"]
    assert isinstance(oom, torch_engine.OutOfMemoryError)
    assert str(oom) == ("llama.cpp preloads all adapters: 32 × 0.05MB = "
                        "1.57MB > budget 0.39MB")
    assert f"({oom})" in want
    assert results["edgelora"].n_completed == 20


# ---------------------------------------------------------------------------
# SSM long context
# ---------------------------------------------------------------------------


def _state_bytes(jm):
    return sum(x.size * x.dtype.itemsize
               for x in jax.tree.leaves(jm.init_cache(1, 64)))


def test_ssm_long_context_matches_reference(capsys):
    jm = jax_build_model(jax_reduced_config(jax_get_config("mamba2-130m")))
    cfg = reduced_config(get_config("mamba2-130m"))
    jcfg, tcfg = _configs("mamba2-130m")
    jm32 = jax_build_model(jcfg)
    params = to_numpy(jax.jit(jm32.init)(jax.random.PRNGKey(0)))
    jparams = jax.tree.map(jnp.asarray, params)
    decode = jax.jit(jm32.decode_step)
    tok = jnp.zeros((1,), jnp.int32)
    cache = jm32.init_cache(1, 64)
    want = []
    for pos in ssm_example.POSITIONS:
        logits, cache = decode(jparams, tok, cache, jnp.int32(pos))
        want.append(np.asarray(logits))
    model = build_model(tcfg, "cpu")
    nbytes, got = ssm_example.long_context(
        model, bridge.params_from_numpy(model, params))
    assert nbytes == _state_bytes(jm32)
    assert ssm_example.POSITIONS == (10, 10_000, 500_000)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (1, tcfg.vocab_size)
        assert rel_err(g.numpy(), w) <= F32_TOL
    assert "decode at position  500000: logits (1, 512)" in (
        capsys.readouterr().out)
    # the example's own (bf16) config: 72.1 KB in both packages
    assert _state_bytes(jm) == sum(
        t.numel() * t.element_size()
        for t in optimizer.tree_leaves(
            build_model(cfg, "cpu").init_cache(1, 64))) == 72_064


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

TRAIN_STEPS, N_ROUTER, N_ROUTER_TRAIN = 3, 40, 32


class _Jitted:
    """A reference model whose ``forward`` runs jitted, for the
    reference example's own ``eval_loss`` (which calls it eagerly)."""

    def __init__(self, jm):
        self.cfg = jm.cfg
        self._fwd = {kind: jax.jit(lambda p, t, lora, kind=kind: jm.forward(
            p, {"tokens": t}, lora,
            JaxLoRAMode(kind, None, jm.cfg.lora.scale)))
            for kind in ("none", "single")}

    def forward(self, params, batch, lora, mode):
        return self._fwd[mode.kind](params, batch["tokens"], lora)


def _eval_batches(cfg, task):
    return jax_data.lm_batches(jax_data.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=48, batch_size=8, seed=999),
        task=task)


def _reference_training(jm, ref, steps, monkeypatch):
    """``examples/train_lora_adapter.py``'s fine-tunes and evaluation,
    replayed at ``steps`` steps a task (its own ``eval_loss``). Each task
    starts from ``init_train_state`` under key 0, drawn once here (the
    same arrays every time), and both tasks' ``train_loop`` share one
    compiled step."""
    cfg = jm.cfg
    dc = jax_data.DataConfig(vocab_size=cfg.vocab_size, seq_len=48,
                             batch_size=8)
    state0 = jax.jit(lambda k: jax_train.init_train_state(jm, k))(
        jax.random.PRNGKey(0))
    make_step = jax_train.make_train_step
    monkeypatch.setattr(jax_train, "make_train_step", functools.lru_cache()(
        lambda model, **kw: make_step(model, **kw)))
    adapters, hists = {}, {}
    for task in (0, 1):
        state, hists[task] = jax_train.train_loop(
            jm, jax_data.lm_batches(dc, task=task), steps, state=state0,
            peak_lr=5e-3, log_every=50, log_fn=lambda s: None)
        adapters[task] = state.lora
    evals, model = {}, _Jitted(jm)
    for task in (0, 1):
        evals[task, None] = ref.eval_loss(model, state0.params, None,
                                          _eval_batches(cfg, task))
        for a in (0, 1):
            evals[task, a] = ref.eval_loss(model, state0.params, adapters[a],
                                           _eval_batches(cfg, task))
    return state0, adapters, hists, evals


def test_train_lora_adapter_matches_reference(capsys, tmp_path,
                                              monkeypatch):
    """The train losses of the chained steps within F32_TOL. The
    evaluation losses are held on the reference's trained adapters,
    bridged: a chained AdamW step moves an element whose gradient is near
    zero by ±lr whichever way rounding turns its sign
    (``tests/test_torch_training.py``, LEAF_ATOL), so the port's own
    adapters differ by such moves and are evaluated, not compared."""
    jcfg, tcfg = _configs("llama3-8b")
    jm = jax_build_model(jcfg)
    ref = _load("examples/train_lora_adapter.py", "ref_train_lora_adapter")
    state0, jadapters, jhists, jevals = _reference_training(
        jm, ref, TRAIN_STEPS, monkeypatch)
    params, lora = to_numpy(state0.params), to_numpy(state0.lora)

    model = build_model(tcfg, "cpu")

    def new_state():
        tl = bridge.lora_pool_from_numpy(lora)
        return train.TrainState(bridge.params_from_numpy(model, params), tl,
                                optimizer.adamw_init(tl))

    got = train_example.run(model, new_state, TRAIN_STEPS,
                            n_router=N_ROUTER, n_router_train=N_ROUTER_TRAIN)
    for task in (0, 1):
        assert [i for i, _ in got["hist"][task]] == [
            i for i, _ in jhists[task]] == [0, TRAIN_STEPS - 1]
        for (_, a), (_, b) in zip(got["hist"][task], jhists[task]):
            assert abs(a - b) <= F32_TOL * abs(b), (task, a, b)
    assert sorted(got["eval"], key=str) == sorted(jevals, key=str)
    base = model.params
    for (task, a), want in jevals.items():
        adapter = (None if a is None
                   else bridge.lora_pool_from_numpy(to_numpy(jadapters[a])))
        loss = train_example.eval_loss(model, base, adapter,
                                       _eval_batches(jcfg, task))
        assert abs(loss - want) <= F32_TOL * abs(want), (task, a)
        assert np.isfinite(got["eval"][task, a])
    # the router's head is drawn from the port's generator (its training
    # against the reference's on one head: tests/test_torch_router.py)
    assert 0.0 <= got["router_acc"] <= 1.0 and got["chance"] > 0
    out = capsys.readouterr().out
    assert out.count("and verified") == 2
    for task, tree in got["adapters"].items():
        path = tmp_path / f"a{task}.npz"
        checkpoint.save_checkpoint(str(path), tree)
        back = checkpoint.load_checkpoint(str(path), tree)
        assert all(torch.equal(a, b) for a, b in zip(
            optimizer.tree_leaves(tree), optimizer.tree_leaves(back)))


# ---------------------------------------------------------------------------
# the scripts as written, on the CPU
# ---------------------------------------------------------------------------


SCRIPT_RUNS = {
    "quickstart_torch.py": "decoded 8 tokens/tenant: [[",
    "serve_multitenant_torch.py": "llamacpp                    OOM   "
                                  "(llama.cpp preloads all adapters",
    "serve_ssm_long_context_torch.py": "decode state: 72.1 KB",
}


@pytest.fixture(scope="module", autouse=True)
def script_runs():
    """The scripts as written, each in a subprocess started with the
    module (they run beside its other tests) on one intra-op thread: the
    serve's clock charges each step's wall time, and the suite's other
    workers share the cores."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen(
        [sys.executable, f"examples/{name}", "--device", "cpu"], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in SCRIPT_RUNS}
    yield procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
        proc.communicate()


@pytest.mark.parametrize("script", sorted(SCRIPT_RUNS))
def test_example_runs_on_cpu(script_runs, script):
    out, err = script_runs[script].communicate(timeout=240)
    assert script_runs[script].returncode == 0, err[-3000:]
    assert SCRIPT_RUNS[script] in out, out
    if script == "serve_multitenant_torch.py":
        rows = [l.split()[0] for l in out.splitlines()
                if l.startswith("edgelora")]
        assert rows == ["edgelora", "edgelora_no_aas"]
