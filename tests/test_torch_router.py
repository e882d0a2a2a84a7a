"""The port's ``LearnedRouter`` and router-head training against the JAX
package's.

* ``scores_batch`` in f32 within 1e-5 of the reference's, with the
  attention kernel route off and on (on the CPU the ``flash_prefill``
  wrapper runs its plain version).
* ``train_router`` from the reference's initial head (injected by
  monkeypatching the port's ``init_router_head``): the final head within
  1e-4 and the same ``router_accuracy``; from the port's own head it
  beats chance as ``tests/test_training.py`` asks.
* The engine with ``edgelora`` and a *trained* router (clear score
  margins), ``router_batching`` on and off, dense and paged, f32, each
  engine under a fresh fake timer: streams, selections, ``router_steps``,
  the whole ``ServingSummary`` and the trace, ``router`` compute spans
  included, event for event. Batched and solo scoring are not asserted to
  select alike: the reference itself does not hold that (ROADMAP C).
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
from repro.core.router import LearnedRouter as JaxRouter  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.trace import EngineTracer as JaxTracer  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import router_train as jax_rt  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.router import LearnedRouter  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.trace import EngineTracer  # noqa: E402
from repro_torch.training import data, router_train  # noqa: E402

from test_torch_model import rel_err, to_numpy  # noqa: E402
from test_torch_policies import (N_ADAPTERS, Weights, configs,  # noqa: E402
                                 ecfg_kwargs, one_torch_thread,  # noqa: F401
                                 serve_pair, summary_json, trace_kwargs)

# f32 trunks of both packages, reassociated: scores within 1e-5 of
# max|score|; the head after 60 AdamW steps on features that agree to
# ~1e-6, within 1e-4 of max|w|
SCORE_TOL = 1e-5
HEAD_TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    return Weights(N_ADAPTERS)


@pytest.fixture(scope="module")
def trained(weights):
    """A head for N_ADAPTERS trained by the reference on the engine's
    params (reduced qwen2-0.5b, f32), and both packages' routers."""
    jcfg, tcfg = configs()
    jm = jax_build_model(jcfg)
    jp = jax.tree.map(jnp.asarray, weights.params)
    dc = jax_data.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                             batch_size=4, n_tasks=4)
    prompts, labels, _ = jax_data.router_dataset(dc, N_ADAPTERS, 96)
    head, _ = jax_rt.train_router(jm, jp, prompts, labels, epochs=3,
                                  batch_size=16, lr=3e-3,
                                  log_fn=lambda s: None)
    head = to_numpy(head)
    routers = {}
    for kernel in (False, True):
        tm = build_model(tcfg, "cpu", attn_kernel=kernel)
        tp = bridge.params_from_numpy(tm, weights.params)
        routers[kernel] = LearnedRouter(tm, tp,
                                        bridge.router_head_from_numpy(head))
    return JaxRouter(jm, jp, jax.tree.map(jnp.asarray, head)), routers


@pytest.mark.parametrize("kernel", [False, True], ids=["plain", "kernel"])
def test_scores_batch_matches_reference(trained, kernel):
    jrouter, routers = trained
    port = routers[kernel]
    assert port.costs_forward and port.model.attn_kernel == kernel
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, port.model.cfg.vocab_size, size=(4, 16)
                          ).astype(np.int32)
    want = jrouter.scores_batch(jnp.asarray(tokens))
    got = port.scores_batch(torch.from_numpy(tokens))
    assert got.shape == want.shape == (4, N_ADAPTERS)
    assert rel_err(got, want) <= SCORE_TOL
    assert rel_err(port.scores_batch(tokens), want) <= SCORE_TOL


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _reference_params(arch="qwen2-0.5b"):
    """The reference's own init (``model.init(PRNGKey(0))``), as
    tests/test_training.py trains its router on, in f32."""
    jm = jax_build_model(_f32(jax_reduced_config(jax_get_config(arch))))
    return jm, jm.init(jax.random.PRNGKey(0))


def _router_data(cfg):
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         batch_size=4, n_tasks=4)
    return data.router_dataset(dc, n_adapters=8, n_samples=200)


def test_train_router_matches_reference(monkeypatch):
    jm, jp = _reference_params()
    prompts, labels, _ = _router_data(jm.cfg)
    kw = dict(epochs=6, batch_size=16, lr=3e-3, log_fn=lambda s: None)
    jhead, jloss = jax_rt.train_router(jm, jp, prompts[:160], labels[:160],
                                       **kw)
    jacc = jax_rt.router_accuracy(jm, jp, jhead, prompts[160:],
                                  labels[160:])

    init = to_numpy(jax_rt.init_router_head(jax.random.PRNGKey(0),
                                            jm.cfg.d_model, 8))
    monkeypatch.setattr(router_train, "init_router_head",
                        lambda gen, d, n: bridge.router_head_from_numpy(init))
    tm = build_model(_f32(reduced_config(get_config("qwen2-0.5b"))), "cpu")
    tp = bridge.params_from_numpy(tm, to_numpy(jp))
    thead, tloss = router_train.train_router(tm, tp, prompts[:160],
                                             labels[:160], **kw)
    for k in ("w", "b"):
        assert rel_err(thead[k].numpy(), np.asarray(jhead[k])) <= HEAD_TOL, k
    assert abs(tloss - jloss) <= HEAD_TOL * jloss
    tacc = router_train.router_accuracy(tm, tp, thead, prompts[160:],
                                        labels[160:])
    assert tacc == jacc


def test_router_beats_chance():
    """tests/test_training.py's router test on the port alone: its own
    init and its own head init."""
    cfg = reduced_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    prompts, labels, _ = _router_data(cfg)
    head, _ = router_train.train_router(model, params, prompts[:160],
                                        labels[:160], epochs=6,
                                        batch_size=16, lr=3e-3,
                                        log_fn=lambda s: None)
    acc = router_train.router_accuracy(model, params, head, prompts[160:],
                                       labels[160:])
    assert acc > 0.45, f"router acc {acc} vs 0.25 chance"


def test_bce_with_logits_matches_reference():
    rng = np.random.default_rng(3)
    logits = (5 * rng.normal(size=(6, 8))).astype(np.float32)
    labels = (rng.uniform(size=(6, 8)) < 0.3).astype(np.float32)
    want = float(jax_rt.bce_with_logits(jnp.asarray(logits),
                                        jnp.asarray(labels)))
    got = float(router_train.bce_with_logits(torch.from_numpy(logits),
                                             torch.from_numpy(labels)))
    assert abs(got - want) <= 1e-6 * want


# ---------------------------------------------------------------------------
# the engine's SELECTING path with the learned router
# ---------------------------------------------------------------------------


def _margins(router, trace):
    """Each request's top-2 score margin under ``router`` (the
    reference's), to report beside a differing selection."""
    out = {}
    for r in trace:
        s = np.sort(np.asarray(router.scores(r)))[::-1]
        out[r.request_id] = float(s[0] - s[1])
    return out


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("batching", [True, False],
                         ids=["batched", "solo"])
def test_engine_learned_router_matches_reference(monkeypatch, weights,
                                                 trained, batching, kv):
    jrouter, routers = trained
    cfg = configs()[1]
    tracers = (JaxTracer(), EngineTracer())
    ref, port = serve_pair(
        monkeypatch, weights,
        ecfg_kwargs("edgelora", kv, n_slots=4, router_batching=batching),
        trace_kwargs(cfg, seed=4, rate=3000.0, duration=0.005),
        tracers=tracers, routers=(jrouter, routers[False]))
    (jsum, jtrace, jeng), (tsum, ttrace, teng) = ref, port
    assert jsum.n_completed == len(jtrace) >= 6
    sel = {r.request_id: r.selected_adapter for r in ttrace}
    want = {r.request_id: r.selected_adapter for r in jtrace}
    if sel != want:
        margins = _margins(jrouter, jtrace)
        diff = {k: (want[k], sel[k], margins[k]) for k in want
                if want[k] != sel[k]}
        pytest.fail(f"selections differ (ref, port, ref top-2 margin): "
                    f"{diff}")
    for a, b in zip(jtrace, ttrace):
        assert a.tokens == b.tokens, a.request_id
    assert 0 < tsum.router_steps == jsum.router_steps <= len(ttrace)
    assert summary_json(jsum) == summary_json(tsum)
    jtr, ttr = tracers
    assert len(ttr.events) == len(jtr.events) > 0
    for i, (a, b) in enumerate(zip(jtr.events, ttr.events)):
        assert json.dumps(a, sort_keys=True) == json.dumps(
            b, sort_keys=True), (i, a, b)
    spans = [e for e in ttr.events
             if e["kind"] == "compute" and e["name"].startswith("router ")]
    assert len(spans) == tsum.router_steps
    sizes = [e["args"]["key"][2] for e in spans]
    assert (max(sizes) > 1) == batching, sizes
