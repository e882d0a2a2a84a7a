"""PyTorch port's serving engine vs the JAX package's.

* ``generate_trace`` gives byte-identical traces (same salted numpy
  streams).
* Engine parity in f32 on reduced Llama-3.1-8B: the same params, the
  same numpy-made adapters (nonzero B), more adapters than pool slots so
  the initial pool is fully overwritten, async swap-in on, and a fresh
  deterministic timer (``_FakeTime``: ``perf_counter`` advances a fixed
  tick per call) in each engine, so both virtual clocks see identical
  step durations. Token streams and the whole ``ServingSummary``,
  timing fields included, must be equal.
* The CLI serves on the CPU when asked to, and nothing outside the
  ported slices degrades silently (the paged arena, prefix cache and
  chunked prefill: ``tests/test_torch_paged.py``).
"""
import dataclasses
import json
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
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N_ADAPTERS = 6   # > max_resident (4) of the reduced config


class _FakeTime:
    """Deterministic step timer (the pattern of tests/test_trace.py)."""

    def __init__(self, tick=5e-4):
        self.t = 0.0
        self.tick = tick

    def perf_counter(self):
        self.t += self.tick
        return self.t


WORKLOADS = [
    dict(),
    dict(n_adapters=12, alpha=0.5, request_rate=5.0, duration=4.0,
         system_prompt_len=16, shared_prefix_frac=0.5, seed=7),
    dict(interactive_frac=0.5, long_prompt_frac=0.3, duration=6.0, seed=3),
]
REQUEST_FIELDS = ("request_id", "arrival_time", "prompt_len", "output_len",
                  "adapter_id", "true_adapter", "priority", "ttft_slo",
                  "tpot_slo")


@pytest.mark.parametrize("kw", WORKLOADS)
def test_generate_trace_matches_reference(kw):
    jt = jax_workload.generate_trace(jax_workload.WorkloadConfig(**kw))
    tt = workload.generate_trace(workload.WorkloadConfig(**kw))
    assert len(jt) == len(tt) > 0
    for a, b in zip(jt, tt):
        for f in REQUEST_FIELDS:
            assert getattr(a, f) == getattr(b, f), f
        pa, pb = np.asarray(a.prompt_tokens), np.asarray(b.prompt_tokens)
        assert pa.dtype == pb.dtype and pa.tobytes() == pb.tobytes()


def _configs():
    def f32(cfg):
        return dataclasses.replace(
            cfg, dtype="float32",
            lora=dataclasses.replace(cfg.lora, n_adapters=N_ADAPTERS))
    return (f32(jax_reduced_config(jax_get_config("llama3-8b"))),
            f32(reduced_config(get_config("llama3-8b"))))


def _numpy_tree(shapes, rng, draw):
    return jax.tree_util.tree_map_with_path(
        lambda path, sd: draw(jax.tree_util.keystr(path), sd.shape, rng)
        .astype(np.float32), shapes)


def _param(name, shape, rng):
    # fan-in scale keeps the f32 argmax streams well conditioned (see
    # tests/test_torch_model.py)
    if "scale" in name:
        return 0.1 * rng.normal(size=shape)
    if name == "['embed']":
        return rng.normal(size=shape)
    return rng.normal(size=shape) / np.sqrt(shape[-2])


def _adapter(rank):
    def draw(name, shape, rng):
        if name.endswith("['A']"):
            return rng.normal(size=shape) / np.sqrt(rank)
        return 0.005 * rng.normal(size=shape)      # nonzero B
    return draw


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _configs()
    jm = jax_build_model(jcfg)
    params = _numpy_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                         np.random.default_rng(0), _param)
    lora_shapes = jax.eval_shape(jm.init_lora, jax.random.PRNGKey(0))
    adapters = {aid: _numpy_tree(lora_shapes, np.random.default_rng(100 + aid),
                                 _adapter(jcfg.lora.rank))
                for aid in range(N_ADAPTERS)}
    return params, adapters


def _engine_kwargs(cfg, policy):
    # a swap-in of ~4 fake ticks: loads overlap a few steps, so LOADING,
    # prefetch and the stall path all run
    load_s = 4 * 5e-4
    return dict(n_slots=4, policy=policy, max_ctx=64, prompt_buckets=(16, 32),
                async_swap=True, prefetch_depth=2,
                disk_bandwidth=cfg.lora_adapter_bytes() / load_s)


def _trace(mod, cfg):
    return mod.generate_trace(mod.WorkloadConfig(
        n_adapters=N_ADAPTERS, alpha=0.8, request_rate=40.0, duration=0.5,
        input_range=(4, 40), output_range=(2, 7), vocab_size=cfg.vocab_size,
        seed=5))


@pytest.mark.parametrize("policy", ["edgelora", "edgelora_no_aas"])
def test_engine_matches_reference_f32(monkeypatch, weights, policy):
    params, adapters = weights
    jcfg, tcfg = _configs()

    def jax_adapter(self, aid):
        return jax.tree.map(jnp.asarray, adapters[aid])

    monkeypatch.setattr(jax_engine.EdgeLoRAEngine, "_adapter_host",
                        jax_adapter)
    jeng = jax_engine.EdgeLoRAEngine(
        jcfg, jax_engine.EngineConfig(**_engine_kwargs(jcfg, policy)),
        params=jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr("repro.serving.engine.time", _FakeTime())
    jtrace = _trace(jax_workload, jcfg)
    jsum = jeng.serve(jtrace)

    teng = EdgeLoRAEngine(
        tcfg, EngineConfig(**_engine_kwargs(tcfg, policy)),
        params=bridge.tree_from_numpy(params), device="cpu",
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(
            adapters[aid]),
        timer=_FakeTime())
    assert teng.lora_backend == jeng.lora_backend == "einsum"
    ttrace = _trace(workload, tcfg)
    tsum = teng.serve(ttrace)

    assert jsum.n_completed == jsum.n_requests == len(jtrace) >= 8
    assert jsum.adapter_loads > 0 and jsum.decode_steps > 0
    for a, b in zip(jtrace, ttrace):
        assert a.tokens == b.tokens, a.request_id
        for f in ("selected_adapter", "first_token_time", "finish_time",
                  "generated", "rejected"):
            assert getattr(a, f) == getattr(b, f), (a.request_id, f)
    # exact equality, with NaN (empty SLO classes) equal to itself
    assert _summary_json(jsum) == _summary_json(tsum)


def _summary_json(summary):
    return json.dumps(dataclasses.asdict(summary), sort_keys=True,
                      default=float)


@pytest.mark.parametrize("change,msg", [
    (dict(policy="llamacpp"), "policy 'llamacpp'"),
    (dict(policy="dlora"), "policy 'dlora'"),
    (dict(tracer=object()), "tracer"),
])
def test_unported_features_raise(change, msg):
    _, tcfg = _configs()
    tracer = change.pop("tracer", None)
    with pytest.raises(NotImplementedError, match=msg):
        EdgeLoRAEngine(tcfg, EngineConfig(**change), tracer=tracer,
                       device="cpu")


def _run_cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)


def test_cli_serves_on_cpu():
    out = _run_cli("--device", "cpu", "--n-adapters", "6", "--rate", "3",
                   "--duration", "2", "--max-ctx", "64")
    assert out.returncode == 0, out.stderr
    row = out.stdout.strip().splitlines()[-1]
    assert row.startswith("policy=edgelora n=6 completed=")
    done, total = row.split("completed=")[1].split()[0].split("/")
    assert done == total and int(total) > 0
    assert "lora_backend=einsum kv_backend=dense device=cpu" in out.stderr


def test_cuda_requested_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = _configs()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        EdgeLoRAEngine(tcfg, EngineConfig())
