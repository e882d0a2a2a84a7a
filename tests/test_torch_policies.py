"""The port's ``llamacpp`` and ``dlora`` policies against the JAX
package's engine.

Reduced qwen2-0.5b in f32 (nonzero QKV bias), the same numpy-made params
and adapters (nonzero B) in both engines, the reference's tracing-test
settings (2 slots, max_ctx 48, buckets 16/32), and a fresh deterministic
timer in each (``_FakeTime``), so both virtual clocks see the same step
durations: token streams, the step counters and the whole
``ServingSummary`` must be equal, on dense and paged KV. Then the
reference's own policy tests on the port: dlora's merge and unmerge
cases (``tests/test_dlora_policy.py``), llamacpp's merged-execution
regressions (``tests/test_engine_regressions.py``) and the preload OOM
check.
"""
import dataclasses
import json

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
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import workload  # noqa: E402

from test_torch_engine import (_adapter, _FakeTime, _numpy_tree,  # noqa: E402
                               _param)

ARCH = "qwen2-0.5b"
N_ADAPTERS = 5      # > max_resident (4) of the reduced config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread: the reduced models are too
    small to gain from more, and spare threads would only contend with
    the JAX package's in the same process."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(n_adapters=N_ADAPTERS, dtype="float32"):
    def f(cfg):
        return dataclasses.replace(cfg, dtype=dtype, lora=dataclasses.replace(
            cfg.lora, n_adapters=n_adapters))
    return (f(jax_reduced_config(jax_get_config(ARCH))),
            f(reduced_config(get_config(ARCH))))


def _weight(name, shape, rng):
    if name.endswith(("['bq']", "['bk']", "['bv']")):
        return 0.1 * rng.normal(size=shape)     # nonzero QKV bias
    return _param(name, shape, rng)


class Weights:
    """Params and ``n`` adapters drawn once with numpy, handed to both
    packages."""

    def __init__(self, n_adapters):
        jcfg, _ = configs(n_adapters)
        jm = jax_build_model(jcfg)
        self.params = _numpy_tree(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
            np.random.default_rng(0), _weight)
        shapes = jax.eval_shape(jm.init_lora, jax.random.PRNGKey(0))
        self.adapters = {
            aid: _numpy_tree(shapes, np.random.default_rng(100 + aid),
                             _adapter(jcfg.lora.rank))
            for aid in range(n_adapters)}


@pytest.fixture(scope="module")
def weights():
    return Weights(16)


def ecfg_kwargs(policy, kv="dense", **kw):
    """``tests/test_trace.py``'s ``_ecfg`` settings."""
    base = dict(n_slots=2, max_ctx=48, prompt_buckets=(16, 32),
                policy=policy, kv_backend=kv)
    if policy == "llamacpp":
        base["memory_budget"] = 1e12
    base.update(kw)
    return base


def trace_kwargs(cfg, seed=0, rate=4.0, duration=3.0, input_range=(4, 20),
                 output_range=(3, 6), **kw):
    """``tests/test_trace.py``'s ``_trace`` workload."""
    return dict(n_adapters=cfg.lora.n_adapters, request_rate=rate,
                duration=duration, input_range=input_range,
                output_range=output_range, vocab_size=cfg.vocab_size,
                seed=seed, **kw)


def serve_pair(monkeypatch, weights, ecfg, wl, *, n_adapters=N_ADAPTERS,
               tracers=(None, None), routers=(None, None)):
    """Serve one trace in the reference's engine and in the port's, each
    under a fresh fake timer (and each with its router, if given).
    Returns ((summary, trace, engine) of the reference, the same of the
    port)."""
    jcfg, tcfg = configs(n_adapters)
    monkeypatch.setattr(
        jax_engine.EdgeLoRAEngine, "_adapter_host",
        lambda self, aid: jax.tree.map(jnp.asarray, weights.adapters[aid]))
    jeng = jax_engine.EdgeLoRAEngine(
        jcfg, jax_engine.EngineConfig(**ecfg),
        params=jax.tree.map(jnp.asarray, weights.params), tracer=tracers[0],
        router=routers[0])
    monkeypatch.setattr("repro.serving.engine.time", _FakeTime())
    jtrace = jax_workload.generate_trace(jax_workload.WorkloadConfig(**wl))
    jsum = jeng.serve(jtrace)

    teng = torch_engine.EdgeLoRAEngine(
        tcfg, torch_engine.EngineConfig(**ecfg),
        params=bridge.tree_from_numpy(weights.params), tracer=tracers[1],
        router=routers[1], device="cpu", timer=_FakeTime(),
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(
            weights.adapters[aid]))
    ttrace = workload.generate_trace(workload.WorkloadConfig(**wl))
    tsum = teng.serve(ttrace)
    return (jsum, jtrace, jeng), (tsum, ttrace, teng)


def summary_json(summary):
    """The whole summary, exact, with NaN (empty SLO classes) equal to
    itself."""
    return json.dumps(dataclasses.asdict(summary), sort_keys=True,
                      default=float)


def assert_same_run(ref, port):
    (jsum, jtrace, _), (tsum, ttrace, _) = ref, port
    assert jsum.n_completed == jsum.n_requests == len(jtrace) > 0
    for a, b in zip(jtrace, ttrace):
        assert a.tokens == b.tokens, a.request_id
        for f in ("selected_adapter", "first_token_time", "finish_time",
                  "generated", "rejected"):
            assert getattr(a, f) == getattr(b, f), (a.request_id, f)
    assert summary_json(jsum) == summary_json(tsum)


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["llamacpp", "dlora"])
def test_policy_matches_reference_f32(monkeypatch, weights, policy, kv):
    """Streams, step counters and the whole summary; the counters show
    which steps ran: llamacpp only merged ones, dlora both."""
    cfg = configs()[1]
    ref, port = serve_pair(monkeypatch, weights, ecfg_kwargs(policy, kv),
                           trace_kwargs(cfg))
    assert_same_run(ref, port)
    keys = set(port[2]._durations)
    assert keys == set(ref[2]._durations)
    kinds = {k[0] for k in keys}
    if policy == "llamacpp":
        assert kinds == {"prefill_merged", "decode_merged"}
    else:
        assert {"decode", "decode_merged"} <= kinds
    if kv == "paged":
        assert port[0].kv_stats["allocs"] > 0


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("policy,alpha", [("llamacpp", 1.0), ("dlora", 0.0)])
def test_policy_with_prefix_cache_and_chunks_matches_reference(
        monkeypatch, weights, policy, alpha, kv):
    """The merged suffix steps: chunked prefill (dense) and the prefix
    cache with chunks (paged) over tenants' system prompts, under
    llamacpp (merged only) and dlora on adapter-diverse traffic (both
    kinds of step)."""
    cfg = configs()[1]
    kw = dict(prefill_chunk=16)
    if kv == "paged":
        kw.update(prefix_cache=True, kv_block_size=8)
    ref, port = serve_pair(
        monkeypatch, weights, ecfg_kwargs(policy, kv, **kw),
        trace_kwargs(cfg, system_prompt_len=16, alpha=alpha,
                     input_range=(4, 30)))
    assert_same_run(ref, port)
    kinds = {k[0] for k in port[2]._durations}
    assert kinds == {k[0] for k in ref[2]._durations}
    sfx = "prefill_sfx_dense" if kv == "dense" else "prefill_sfx"
    assert f"{sfx}_merged" in kinds
    if policy == "dlora":
        assert sfx in kinds and "decode" in kinds
    if kv == "paged":
        assert port[0].prefix_stats["hit_requests"] > 0


# ---------------------------------------------------------------------------
# the reference's dlora policy tests (tests/test_dlora_policy.py)
# ---------------------------------------------------------------------------


def _dlora_serve(monkeypatch, weights, n_adapters, alpha, seed=0):
    cfg = configs(n_adapters)[1]
    return serve_pair(
        monkeypatch, weights,
        dict(n_slots=4, max_ctx=64, prompt_buckets=(16, 32), policy="dlora"),
        trace_kwargs(cfg, seed=seed, rate=5.0, duration=4.0, alpha=alpha,
                     input_range=(4, 16), output_range=(4, 8)),
        n_adapters=n_adapters)


@pytest.mark.parametrize("n_adapters,alpha,seed", [
    (8, 0.5, 0),      # the reference's completes-all cases
    (8, 3.0, 0),
    (1, 1.0, 0),      # a single adapter: runs merged
    (16, 0.0, 1),     # uniform adapter traffic: unmerges
])
def test_dlora_merges_and_unmerges_like_reference(monkeypatch, weights,
                                                  n_adapters, alpha, seed):
    ref, port = _dlora_serve(monkeypatch, weights, n_adapters, alpha, seed)
    assert_same_run(ref, port)
    summary, trace, eng = port
    assert summary.n_completed == len(trace)
    for r in trace:
        assert r.generated == r.output_len
        assert r.finish_time >= r.first_token_time >= r.arrival_time
    kinds = {k[0] for k in eng._durations}
    if n_adapters == 8:
        return
    if n_adapters == 1:
        # merged execution touches the pool only at the init prefill
        assert summary.adapter_loads <= eng.cfg.lora.max_resident
        assert kinds == {"prefill_merged", "decode_merged"}
    else:
        assert summary.adapter_loads > 0
        assert {"prefill", "decode"} <= kinds


# ---------------------------------------------------------------------------
# the reference's llamacpp regressions (tests/test_engine_regressions.py)
# ---------------------------------------------------------------------------


def _llamacpp_engine(kv="dense"):
    _, tcfg = configs(6)
    return torch_engine.EdgeLoRAEngine(
        tcfg, torch_engine.EngineConfig(**ecfg_kwargs("llamacpp", kv)),
        device="cpu")


def _tokens(trace):
    return {r.request_id: r.tokens for r in trace}


def _trace(seed=0):
    cfg = configs(6)[1]
    return workload.generate_trace(workload.WorkloadConfig(
        **trace_kwargs(cfg, seed=seed)))


def test_llamacpp_outputs_independent_of_pool_contents():
    """Merged steps run no LoRA: corrupting every pool slot changes no
    token."""
    t1, t2 = _trace(), _trace()
    _llamacpp_engine().serve(t1)
    eng = _llamacpp_engine()
    for mods in eng.lora_pool["layers"].values():
        for pair in mods.values():
            for leaf in pair.values():
                leaf.add_(37.0)
    eng.serve(t2)
    assert _tokens(t1) == _tokens(t2)
    assert all(r.tokens and len(r.tokens) == r.output_len for r in t1)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_llamacpp_never_runs_unmerged_steps(kv):
    eng = _llamacpp_engine(kv)

    def unmerged_forbidden(*args, **kwargs):
        raise AssertionError("llamacpp executed an unmerged batched step")

    for name in ("_prefill", "_decode", "_decode_paged"):
        if hasattr(eng, name):
            setattr(eng, name, unmerged_forbidden)
    trace = _trace(seed=1)
    summary = eng.serve(trace)
    assert summary.n_completed == len(trace)


def test_llamacpp_preload_oom_matches_reference():
    """Every adapter preloaded: 6 adapters over a budget of 5 raise, at
    init, with the reference's message."""
    jcfg, tcfg = configs(6)
    budget = 5 * tcfg.lora_adapter_bytes()
    kw = ecfg_kwargs("llamacpp", memory_budget=budget)
    with pytest.raises(jax_engine.OutOfMemoryError) as jerr:
        jax_engine.EdgeLoRAEngine(jcfg, jax_engine.EngineConfig(**kw))
    with pytest.raises(torch_engine.OutOfMemoryError) as terr:
        torch_engine.EdgeLoRAEngine(tcfg, torch_engine.EngineConfig(**kw),
                                    device="cpu")
    assert str(terr.value) == str(jerr.value)
    kw["memory_budget"] = 6 * tcfg.lora_adapter_bytes()
    torch_engine.EdgeLoRAEngine(tcfg, torch_engine.EngineConfig(**kw),
                                device="cpu")
