"""The port's MoE family against the JAX package's, on bridged weights:
dbrx-132b (16 experts top-4; reduced: 4 experts top-2) and
llama4-maverick (128 experts top-1, a shared expert, MoE on every other
layer, 3 chunked-local + 1 global attention; reduced: 4 experts).

* ``moe_block`` in f32, both dispatch paths: the capacity scatter
  (lossless when t·k <= 4096, finite past it: ``capacity_factor`` 0.5 at
  t·k > 4096, where choices drop) and the one-hot path
  (``gather_threshold``), each against the reference's same path. The
  routing (expert ids, queue positions, kept choices) and the expert
  buffer are exactly equal; outputs within 1e-5 of max|y|; aux losses
  within 1e-6 (relative). The reference's own two paths are never held
  equal to each other (its ``test_moe_onehot_dispatch_matches_capacity``
  fails on this stack: they differ by accumulation order).
* The model: prefill over right-padded rows with mixed adapters and three
  decode steps in f32 within 1e-5 of max|logit| (llama4 at a chunk of 16,
  so the chunked-local mask cuts at these lengths; LoRA on its MLPs and
  shared expert too); ``Model.forward``'s logits and summed aux, with
  dropped choices; one LoRA train step on dbrx (loss and aux within 1e-6,
  the updated adapter within 1e-5).
* Engines in f32 under the fake timer: streams, step counters and the
  whole summary equal the reference's — dbrx under ``edgelora``,
  ``llamacpp`` and ``dlora``, dense and paged, paged with the prefix
  cache and chunked prefill, dense with chunks; llama4 dense and paged,
  whose chunked-local rings refuse the prefix cache and chunks with the
  reference's message.

The file takes ~60 s on one CPU core.
"""
import dataclasses
import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.core.lora import LoRAMode as JaxLoRAMode  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import moe as jax_moe  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.models.transformer import slot_is_moe  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.training import optimizer, train  # noqa: E402

from test_torch_engine import _adapter, _FakeTime, _numpy_tree  # noqa: E402
from test_torch_model import (numpy_lora, numpy_params, rel_err,  # noqa: E402
                              to_jax, to_numpy)
from test_torch_policies import _weight, one_torch_thread  # noqa: E402,F401

DBRX, LLAMA4 = "dbrx-132b", "llama4-maverick-400b-a17b"
ARCHS = (DBRX, LLAMA4)
CHUNK = 16                  # llama4's chunked-local window at test sizes
MLP_TARGETS = ("q", "k", "v", "o", "up", "gate", "down")
# per case: (arch, overrides of the reduced config in both packages;
# ``attn.`` / ``moe.`` / ``lora.`` fields go to that sub-config)
CASES = {
    "dbrx": (DBRX, {}),
    "llama4": (LLAMA4, {"attn.sliding_window": CHUNK,
                        "lora.target_modules": MLP_TARGETS}),
}
F32_TOL = 1e-5
AUX_TOL = 1e-6
N_POOL, B, S, MAX_CTX = 4, 3, 24, 32
LENGTHS = np.array([24, 17, 9], np.int32)    # right-padded rows
SLOTS = np.array([2, 0, 3], np.int32)        # mixed adapters


def _apply(cfg, overrides):
    subs = {}
    top = {}
    for key, v in overrides.items():
        if "." in key:
            sub, name = key.split(".")
            subs.setdefault(sub, {})[name] = v
        else:
            top[key] = v
    for sub, fields in subs.items():
        top[sub] = dataclasses.replace(getattr(cfg, sub), **fields)
    return dataclasses.replace(cfg, **top)


def configs(case, **extra):
    """(reference config, port config): the reduced arch in f32 with the
    case's overrides and ``extra``."""
    arch, overrides = CASES[case]
    over = dict(overrides, dtype="float32", **extra)
    return tuple(_apply(reduce(get(arch)), over)
                 for get, reduce in ((jax_get_config, jax_reduced_config),
                                     (get_config, reduced_config)))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_resolves_arch(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.family == "moe"
    check_supported(tcfg)
    jr, tr = jax_reduced_config(jcfg), reduced_config(tcfg)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.moe.n_experts == 4


def test_moe_slots_and_lora_modules_match_reference():
    """MoE on every ``moe_layer_period``-th slot; an MoE slot's MLP LoRA
    only with a shared expert (on it): dbrx's MoE slots carry none,
    llama4's dense and MoE slots carry all seven."""
    for case in CASES:
        for targets in (("q", "v"), MLP_TARGETS):
            jcfg, tcfg = configs(case, **{"lora.target_modules": targets})
            jm, tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
            want = jax.eval_shape(lambda k, jm=jm: jm.init_lora(k, n_slots=2),
                                  jax.random.PRNGKey(0))
            got = tm.init_lora(torch.Generator().manual_seed(0), n_slots=2)
            assert (jax.tree.map(lambda a: a.shape, want)
                    == jax.tree.map(lambda t: tuple(t.shape), got))
            shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
            for p, slot in enumerate(shapes["layers"].values()):
                assert ("moe" in slot) == slot_is_moe(tcfg, p)
    _, tcfg = configs("llama4")
    assert [slot_is_moe(tcfg, p) for p in range(4)] == [False, True] * 2
    params = build_model(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    router = params["layers"]["slot1"]["moe"]["router"]
    assert router.dtype == torch.float32 and tuple(router.shape) == (
        1, tcfg.d_model, 4)


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

# (case, [b, s], moe overrides, LoRA on the shared expert): lossless
# capacity (t·k <= 4096), finite capacity (t·k > 4096 at cf 0.5: choices
# drop), the one-hot path
BLOCK_CASES = {
    "dbrx-lossless": ("dbrx", (3, 16), {}),
    "dbrx-capacity": ("dbrx", (2, 1100), {"moe.capacity_factor": 0.5}),
    "dbrx-onehot": ("dbrx", (3, 16), {"moe.gather_threshold": 4096}),
    "llama4-lossless": ("llama4", (3, 16), {}),
    "llama4-capacity": ("llama4", (2, 2100), {"moe.capacity_factor": 0.5}),
    "llama4-onehot": ("llama4", (3, 16), {"moe.gather_threshold": 4096}),
}


def _reference_routing(params, x, cfg):
    """The reference's routing and queue positions, in its own JAX ops
    (``repro.models.moe.moe_block``'s lines): (eids, pos, keep)."""
    m = cfg.moe
    t = x.shape[0] * x.shape[1]
    logits = jnp.einsum("td,de->te", jnp.asarray(x).reshape(t, -1),
                        jnp.asarray(params["router"]))
    _, eids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), m.top_k)
    flat = eids.reshape(-1)
    onehot = jax.nn.one_hot(flat, m.n_experts, dtype=jnp.int32)
    pos = jnp.take_along_axis(jnp.cumsum(onehot, axis=0) - onehot,
                              flat[:, None], axis=1)[:, 0]
    if 0 < t * m.top_k <= m.gather_threshold:
        cap = max(8, -(-2 * t * m.top_k // m.n_experts))
    else:
        cap = moe.capacity(t, m)
    return np.asarray(eids), np.asarray(pos), np.asarray(pos < cap)


def _recording(monkeypatch, mod, store):
    """Record the [E, C, d] buffer each ``_expert_ffn`` call receives."""
    fn = mod._expert_ffn

    def ffn(experts, x, **kw):
        store.append(np.asarray(x.detach() if isinstance(x, torch.Tensor)
                                else x))
        return fn(experts, x, **kw)

    monkeypatch.setattr(mod, "_expert_ffn", ffn)


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_moe_block_matches_reference(monkeypatch, name):
    case, (b, s), over = BLOCK_CASES[name]
    jcfg, tcfg = configs(case, **over)
    rng = np.random.default_rng(4)
    shapes = jax.eval_shape(lambda k: jax_moe.moe_init(k, jcfg,
                                                       dtype=jnp.float32),
                            jax.random.PRNGKey(0))
    params = jax.tree.map(lambda sd: (rng.normal(size=sd.shape) / np.sqrt(
        sd.shape[-2])).astype(np.float32), shapes)
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    lora = None
    if "shared" in params:      # batched LoRA on the shared expert
        d, f, r = jcfg.d_model, jcfg.d_ff, 4
        lora = {m: {"A": (rng.normal(size=(N_POOL, r, di)) / 2).astype(
            np.float32), "B": (0.05 * rng.normal(size=(N_POOL, do, r))
                               ).astype(np.float32)}
                for m, (di, do) in (("up", (d, f)), ("gate", (d, f)),
                                    ("down", (f, d)))}
    ids = rng.integers(0, N_POOL, b).astype(np.int32)
    jbufs, tbufs = [], []
    _recording(monkeypatch, jax_moe, jbufs)
    _recording(monkeypatch, moe, tbufs)
    jy, jaux = jax_moe.moe_block(
        to_jax(params, jnp.float32), jnp.asarray(x), jcfg,
        None if lora is None else to_jax(lora, jnp.float32),
        JaxLoRAMode("batched", jnp.asarray(ids), 2.0, "einsum", True))
    tp = bridge.tree_from_numpy(params)
    ty, taux = moe.moe_block(
        tp, torch.from_numpy(x), tcfg,
        None if lora is None else bridge.lora_pool_from_numpy(lora),
        LoRAMode("batched", torch.from_numpy(ids), 2.0, "einsum"))
    # routing: expert ids, queue positions, kept choices
    eids, pos, keep = _reference_routing(params, x, jcfg)
    _, teids, _ = moe.route(tp, torch.from_numpy(x).reshape(b * s, -1),
                            tcfg.moe)
    tpos = moe.queue_positions(teids.reshape(-1), tcfg.moe.n_experts)
    np.testing.assert_array_equal(teids.numpy(), eids)
    np.testing.assert_array_equal(tpos.numpy(), pos)
    if "capacity" in name:
        cap = moe.capacity(b * s, tcfg.moe)
        np.testing.assert_array_equal((tpos < cap).numpy(), keep)
        assert b * s * tcfg.moe.top_k > 4096 and cap < b * s
        assert not keep.all(), "no choice dropped"
    elif "lossless" in name:
        assert keep.all() and moe.capacity(b * s, tcfg.moe) == keep.size
    # the expert buffer, exactly (the scatter copies rows)
    assert len(jbufs) == len(tbufs) == 1
    np.testing.assert_array_equal(tbufs[0], jbufs[0])
    assert rel_err(ty.numpy(), np.asarray(jy)) <= F32_TOL
    for k in jaux:
        assert abs(float(taux[k]) - float(jaux[k])) <= AUX_TOL * abs(
            float(jaux[k])), (k, float(taux[k]), float(jaux[k]))


def test_capacity_matches_reference_formula():
    """``capacity`` from Python ints: t·k·cf / E, to a multiple of 128
    from 128 on, lossless t·k up to 4096."""
    m = get_config(DBRX).moe                        # E 16, k 4, cf 1.25
    assert moe.capacity(8, m) == 32                 # decode: t·k
    assert moe.capacity(1024, m) == 4096            # t·k = 4096: lossless
    assert moe.capacity(8192, m) == 2560            # [2, 4096]: 2560
    assert moe.capacity(1100, m) == 384             # 343 -> 384
    m4 = dataclasses.replace(get_config(LLAMA4).moe, n_experts=32)
    assert moe.capacity(2 * 8704, m4) == 768        # 680 -> 768
    assert moe.capacity(5000, dataclasses.replace(m4, n_experts=128)) == 48


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference(case):
    """The reference's prefill + three decode steps on numpy params and
    pool: (params, pool, tokens, [(tokens, pos)] of each decode step,
    logits of each step)."""
    jcfg, tcfg = configs(case)
    jm = jax_build_model(jcfg)
    params, pool = numpy_params(jm), numpy_lora(jm, n_slots=N_POOL)
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, S)).astype(np.int32)
    jp, jpool = to_jax(params, jnp.float32), to_jax(pool, jnp.float32)
    jmode = JaxLoRAMode("batched", jnp.asarray(SLOTS), jcfg.lora.scale,
                        "einsum", True)
    jl, jc = jax.jit(lambda p, t, c, n: jm.prefill(
        p, {"tokens": t}, c, jpool, jmode, lengths=n))(
        jp, jnp.asarray(tokens), jm.init_cache(B, MAX_CTX),
        jnp.asarray(LENGTHS))
    logits = [np.asarray(jl)]
    decode = jax.jit(lambda p, t, c, q: jm.decode_step(p, t, c, q, jpool,
                                                       jmode))
    nxt, pos, steps = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), \
        LENGTHS, []
    for _ in range(3):
        steps.append((nxt, pos))
        jl, jc = decode(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        logits.append(np.asarray(jl))
        nxt, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1
    return params, pool, tokens, steps, logits


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference_f32(case):
    """Right-padded rows (their pad tokens route and take queue places,
    as in the reference), mixed adapters, decode steps fed the
    reference's tokens; llama4's prompts cross a chunk boundary and its
    decode steps run on the chunked-local rings."""
    params, pool, tokens, steps, want = reference(case)
    _, tcfg = configs(case)
    for kernel in (False, True):
        tm = build_model(tcfg, "cpu", attn_kernel=kernel)
        tp = bridge.params_from_numpy(tm, params)
        tpool = bridge.lora_pool_from_numpy(pool)
        tmode = LoRAMode("batched", torch.from_numpy(SLOTS),
                         tcfg.lora.scale, "einsum")
        with torch.no_grad():
            tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                                tm.init_cache(B, MAX_CTX), tpool, tmode,
                                lengths=torch.from_numpy(LENGTHS))
            got = [tl.numpy()]
            for nxt, pos in steps:
                tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                                        torch.from_numpy(pos), tpool, tmode)
                got.append(tl.numpy())
        for i, (w, g) in enumerate(zip(want, got)):
            assert rel_err(g, w) <= F32_TOL, (kernel, i, rel_err(g, w))


def test_chunked_local_mask_is_real():
    """llama4 with a chunk past every position (no cut) moves its logits
    far from the reference's chunked ones."""
    params, pool, tokens, _, want = reference("llama4")
    _, tcfg = configs("llama4", **{"attn.sliding_window": 4096})
    tm = build_model(tcfg, "cpu")
    tp = bridge.params_from_numpy(tm, params)
    with torch.no_grad():
        tl, _ = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                           tm.init_cache(B, MAX_CTX),
                           bridge.lora_pool_from_numpy(pool),
                           LoRAMode("batched", torch.from_numpy(SLOTS),
                                    tcfg.lora.scale, "einsum"),
                           lengths=torch.from_numpy(LENGTHS))
    assert rel_err(tl.numpy(), want[0]) > 100 * F32_TOL


# (case, [b, s], overrides): the forward's sizes; dbrx at t·k > 4096 with
# cf 0.5, so its MoE layers drop choices
FORWARD_CASES = {
    "dbrx": ("dbrx", (B, S), {}),
    "llama4": ("llama4", (B, S), {}),
    "dbrx-drops": ("dbrx", (2, 1100), {"moe.capacity_factor": 0.5}),
}


@pytest.mark.parametrize("name", list(FORWARD_CASES))
def test_forward_and_aux_match_reference(monkeypatch, name):
    """``Model.forward`` with one adapter: logits within 1e-5 of
    max|logit|, the aux losses summed over the MoE layers within 1e-6."""
    case, (b, s), over = FORWARD_CASES[name]
    jcfg, tcfg = configs(case, **over)
    jm = jax_build_model(jcfg)
    params, lora = numpy_params(jm), numpy_lora(jm)
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (b, s)).astype(np.int32)
    kept = []
    capacity = moe.capacity

    def counting(t, m):
        cap = capacity(t, m)
        kept.append((t * m.top_k, cap))
        return cap

    monkeypatch.setattr(moe, "capacity", counting)
    want, jaux = jax.jit(lambda p, t, lo: jm.forward(
        p, {"tokens": t}, lo, JaxLoRAMode("single", None, jcfg.lora.scale)))(
        to_jax(params, jnp.float32), jnp.asarray(tokens),
        to_jax(lora, jnp.float32))
    tm = build_model(tcfg, "cpu")
    tp = bridge.params_from_numpy(tm, params)
    with torch.no_grad():
        got, aux = tm.forward(tp, {"tokens": torch.from_numpy(tokens)},
                              bridge.lora_pool_from_numpy(lora),
                              LoRAMode("single", None, tcfg.lora.scale),
                              attn_kernel=False)
    assert rel_err(got.numpy(), np.asarray(want)) <= F32_TOL
    assert set(aux) == set(jaux) == {"load_balance", "router_z"}
    for k in jaux:
        assert float(jaux[k]) > 0
        assert abs(float(aux[k]) - float(jaux[k])) <= AUX_TOL * float(
            jaux[k]), (k, float(aux[k]), float(jaux[k]))
    # one capacity dispatch per MoE layer (slot_is_moe reads p modulo the
    # period): dbrx's two, llama4's slots 1 and 3
    assert len(kept) == sum(slot_is_moe(tcfg, p)
                            for p in range(tcfg.n_layers)) == 2
    if name == "dbrx-drops":
        assert all(tk > 4096 and cap < tk / tcfg.moe.n_experts
                   for tk, cap in kept)


def test_lora_train_step_matches_reference():
    """One LoRA train step on reduced dbrx from bridged params: loss and
    aux within 1e-6, the updated adapter within 1e-5 (absolute,
    ``tests/test_torch_training.py``'s LEAF_ATOL)."""
    jcfg, tcfg = configs("dbrx")
    jm, tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
    params, lora = numpy_params(jm), numpy_lora(jm)
    tokens = np.random.default_rng(7).integers(
        0, tcfg.vocab_size, (3, 17)).astype(np.int32)
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=4, weight_decay=0.01)
    jl = to_jax(lora, jnp.float32)
    js, jmet = jax.jit(jax_train.make_train_step(jm, **kw))(
        jax_train.TrainState(to_jax(params, jnp.float32), jl,
                             jax_opt.adamw_init(jl)),
        {"tokens": jnp.asarray(tokens)})
    tl = bridge.lora_pool_from_numpy(lora)
    ts, tmet = train.make_train_step(tm, **kw)(
        train.TrainState(bridge.params_from_numpy(tm, params), tl,
                         optimizer.adamw_init(tl)),
        {"tokens": torch.from_numpy(tokens)})
    for k in ("loss", "load_balance", "router_z"):
        assert abs(float(tmet[k]) - float(jmet[k])) <= AUX_TOL * abs(
            float(jmet[k])), (k, float(tmet[k]), float(jmet[k]))
    want = jax.tree_util.tree_leaves(to_numpy(js.lora))
    got = optimizer.tree_leaves(ts.lora)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert float(np.abs(g.detach().numpy() - w).max()) <= 1e-5


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

N_ADAPTERS = 5      # > max_resident (4) of the reduced configs
SYS_LEN = 16


@functools.lru_cache(maxsize=None)
def engine_weights(case):
    jcfg, _ = configs(case, **{"lora.n_adapters": N_ADAPTERS})
    jm = jax_build_model(jcfg)
    params = _numpy_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                         np.random.default_rng(0), _weight)
    shapes = jax.eval_shape(jm.init_lora, jax.random.PRNGKey(0))
    adapters = {aid: _numpy_tree(shapes, np.random.default_rng(100 + aid),
                                 _adapter(jcfg.lora.rank))
                for aid in range(N_ADAPTERS)}
    return params, adapters


def _ecfg(policy, **kw):
    base = dict(n_slots=2, max_ctx=48, prompt_buckets=(16, 32),
                policy=policy)
    if policy == "llamacpp":
        base["memory_budget"] = 1e12
    base.update(kw)
    return base


def _wl(cfg, **kw):
    base = dict(n_adapters=cfg.lora.n_adapters, request_rate=4.0,
                duration=2.0, input_range=(4, 20), output_range=(3, 6),
                vocab_size=cfg.vocab_size, seed=0)
    base.update(kw)
    return base


def serve_pair(monkeypatch, case, ecfg, wl):
    """One trace in both engines, each under a fresh fake timer: equal
    streams, per-request times, step counters and summaries (``kv_stats``,
    ``swap_stats`` and ``prefix_stats`` included). Returns the port's
    (summary, trace, engine)."""
    params, adapters = engine_weights(case)
    jcfg, tcfg = configs(case, **{"lora.n_adapters": N_ADAPTERS})
    monkeypatch.setattr(
        jax_engine.EdgeLoRAEngine, "_adapter_host",
        lambda self, aid: jax.tree.map(jnp.asarray, adapters[aid]))
    jeng = jax_engine.EdgeLoRAEngine(
        jcfg, jax_engine.EngineConfig(**ecfg),
        params=jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr("repro.serving.engine.time", _FakeTime())
    jtrace = jax_workload.generate_trace(jax_workload.WorkloadConfig(
        **_wl(jcfg, **wl)))
    jsum = jeng.serve(jtrace)
    teng = torch_engine.EdgeLoRAEngine(
        tcfg, torch_engine.EngineConfig(**ecfg),
        params=bridge.tree_from_numpy(params), device="cpu",
        timer=_FakeTime(), adapter_source=lambda aid:
        bridge.lora_pool_from_numpy(adapters[aid]))
    ttrace = workload.generate_trace(workload.WorkloadConfig(
        **_wl(tcfg, **wl)))
    tsum = teng.serve(ttrace)
    assert jsum.n_completed == jsum.n_requests == len(jtrace) > 0
    for a, b in zip(jtrace, ttrace):
        assert a.tokens == b.tokens, a.request_id
        for f in ("selected_adapter", "first_token_time", "finish_time",
                  "generated", "rejected"):
            assert getattr(a, f) == getattr(b, f), (a.request_id, f)
    for f in ("prefill_steps", "decode_steps", "kv_stats", "swap_stats",
              "prefix_stats"):
        assert getattr(tsum, f) == getattr(jsum, f), f
    # the whole summary, NaN (an empty SLO class) equal to itself
    assert (json.dumps(dataclasses.asdict(tsum), sort_keys=True,
                       default=float)
            == json.dumps(dataclasses.asdict(jsum), sort_keys=True,
                          default=float))
    assert set(teng._durations) == set(jeng._durations)
    return tsum, ttrace, teng


@pytest.mark.parametrize("case,policy,kv", [
    ("dbrx", "edgelora", "dense"), ("dbrx", "edgelora", "paged"),
    ("dbrx", "llamacpp", "dense"), ("dbrx", "llamacpp", "paged"),
    ("dbrx", "dlora", "dense"), ("dbrx", "dlora", "paged"),
    ("llama4", "edgelora", "dense"), ("llama4", "edgelora", "paged"),
])
def test_engine_matches_reference_f32(monkeypatch, case, policy, kv):
    tsum, ttrace, teng = serve_pair(monkeypatch, case,
                                    _ecfg(policy, kv_backend=kv), {})
    merged = {k[0] for k in teng._durations if "merged" in k[0]}
    if policy == "llamacpp":
        assert merged and all("merged" in k[0] for k in teng._durations)
    if policy == "edgelora":
        assert not merged
    if kv == "paged":
        assert tsum.kv_stats["allocs"] > 0
    if case == "llama4":
        # past the chunk: decode steps on the chunked-local rings
        assert max(r.prompt_len + r.output_len for r in ttrace) > CHUNK


@pytest.mark.parametrize("kv", ["paged", "dense"])
def test_dbrx_prefix_cache_and_chunks_match_reference(monkeypatch, kv):
    """Paged with the prefix cache and 16-token chunks (suffix prefills
    over gathered pages), and dense with chunks (suffix prefills over the
    slots' rings): every prefill variant reaches the MoE blocks."""
    paged = kv == "paged"
    tsum, ttrace, teng = serve_pair(
        monkeypatch, "dbrx",
        _ecfg("edgelora_no_aas", kv_backend=kv, kv_block_size=8,
              prefix_cache=paged, prefill_chunk=16),
        dict(duration=1.5, request_rate=6.0, system_prompt_len=SYS_LEN,
             input_range=(4, 24)))
    step = "prefill_sfx" if paged else "prefill_sfx_dense"
    assert any(k[0] == step for k in teng._durations)
    if paged:
        ps = tsum.prefix_stats
        assert ps["hit_requests"] > 0 and ps["saved_prefill_tokens"] > 0, ps
    assert max(r.prompt_len for r in ttrace) > 16


@pytest.mark.parametrize("change", [
    dict(kv_backend="paged", prefix_cache=True), dict(prefill_chunk=16)])
def test_llama4_refuses_prefix_and_chunks_like_reference(change):
    jcfg, tcfg = configs("llama4", **{"lora.n_adapters": N_ADAPTERS})
    kw = _ecfg("edgelora", **change)
    with pytest.raises(ValueError) as jerr:
        jax_engine.EdgeLoRAEngine(jcfg, jax_engine.EngineConfig(**kw))
    with pytest.raises(ValueError) as terr:
        torch_engine.EdgeLoRAEngine(tcfg, torch_engine.EngineConfig(**kw),
                                    device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert "window-local ring" in str(terr.value)
