"""The port's dense attention variants against the JAX package's, on
bridged weights: gemma2-9b (alternating local/global slots, sliding-window
rings, attention and final logit softcaps, post-norms, scaled embeddings,
a GELU GLU), starcoder2-7b (all-local rings, QKV bias, a plain GELU MLP,
untied), chameleon-34b (QK-norm; the early-fusion VLM family, one token
stream) and the int8 KV cache (``kv_cache_quant``).

Reduced configs, with the same overrides in both packages so that every
feature bites: a window of 8 under prompts of up to 16 tokens (the local
rings wrap and the mask cuts), an attention softcap of 2 and a final one
of 5 (at the published 50 and 30 ``tanh(x/c)·c`` is ``x`` at these
scales), and gemma2 at 2 kv heads over 4 (a GQA group of 2, as the
published 16/8; ``reduced_config`` gives 4/4). The norm scales (post-norms,
QK-norm) are drawn nonzero and the QKV bias at 0.1.

* Prefill over right-padded rows with mixed adapters, then three decode
  steps: f32 logits within 1e-5 of max|logit|, bf16 within ``BF16_TOL``.
  int8 caches: the quantizer is bit-equal to the reference's on the same
  inputs; the prefill cache is bit-equal to the reference's ``cache_fill``
  of the K/V the port computed; each decode step, run from the
  reference's cache (``bridge.cache_from_numpy``: int8 values, bf16
  scales), leaves every leaf bit-equal to the reference's. (The two
  packages' f32 K/V differ by reassociation, ~1e-6 of their size, so a
  value that lands within that of a rounding boundary quantizes one step
  apart — 4 of 98,304 K and V entries after llama3's prefill here — and
  one such step moves the next logits by ~1e-3: a chain of steps on
  each package's own cache is held step by step from a common cache.)
* Each feature is real: the port with that one feature switched off moves
  the logits past 100× the f32 tolerance from the reference's.
* Engines in f32 under the fake timer (``_FakeTime``): token streams, step
  counters and the whole summary equal the reference's, dense and paged,
  with prompts longer than the window; ``llamacpp`` on starcoder2 (no
  ``gate``: a non-GLU MLP); chameleon with the prefix cache and chunked
  prefill. Window-local and int8 caches refuse both, with the reference's
  message.
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
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.models import attention as torch_attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import workload  # noqa: E402

from test_torch_engine import _adapter, _FakeTime, _numpy_tree  # noqa: E402
from test_torch_model import (BF16_TOL, numpy_lora, numpy_params,  # noqa: E402
                              rel_err, to_jax, to_numpy)
from test_torch_policies import _weight, one_torch_thread  # noqa: E402,F401

ARCHS = ("gemma2-9b", "starcoder2-7b", "chameleon-34b")
# per case: (arch, overrides of the reduced config in both packages;
# ``attn.`` fields go to its AttentionConfig)
WINDOW = 8
GEMMA2 = {"attn.sliding_window": WINDOW, "attn.attn_logit_softcap": 2.0,
          "final_logit_softcap": 5.0, "n_kv_heads": 2}
CASES = {
    "gemma2-9b": ("gemma2-9b", GEMMA2),
    "starcoder2-7b": ("starcoder2-7b", {"attn.sliding_window": WINDOW}),
    "chameleon-34b": ("chameleon-34b", {}),
    "gemma2-9b-int8": ("gemma2-9b", dict(GEMMA2,
                                         **{"attn.kv_cache_quant": True})),
    "llama3-8b-int8": ("llama3-8b", {"attn.kv_cache_quant": True}),
}
N_POOL, B, BUCKET, MAX_CTX = 4, 3, 16, 32
LENGTHS = np.array([16, 9, 5], np.int32)     # right-padded rows
SLOTS = np.array([2, 0, 3], np.int32)        # mixed adapters
BIAS_STD = 0.1
F32_TOL = 1e-5


def _apply(cfg, overrides):
    top = {k: v for k, v in overrides.items() if not k.startswith("attn.")}
    attn = {k[5:]: v for k, v in overrides.items() if k.startswith("attn.")}
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, **attn),
                               **top)


def configs(case, dtype="float32", n_adapters=None):
    arch, overrides = CASES[case]
    over = dict(overrides, dtype=dtype)
    out = []
    for get, reduce in ((jax_get_config, jax_reduced_config),
                        (get_config, reduced_config)):
        cfg = _apply(reduce(get(arch)), over)
        if n_adapters is not None:
            cfg = dataclasses.replace(cfg, lora=dataclasses.replace(
                cfg.lora, n_adapters=n_adapters))
        out.append(cfg)
    return tuple(out)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_resolves_arch(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    check_supported(tcfg)


def test_check_supported_lets_the_variants_through():
    """Local layers, chunked-local masks, QK-norm, both softcaps, int8 KV,
    post-norms and scaled embeddings; the VLM family without an encoder;
    attention without RoPE (the reference's ``project_qkv`` skips it)."""
    _, tcfg = configs("gemma2-9b")
    check_supported(_apply(tcfg, {"attn.chunked_local": True,
                                  "attn.qk_norm": True,
                                  "attn.kv_cache_quant": True}))
    assert get_config("chameleon-34b").family == "vlm"
    check_supported(_apply(tcfg, {"attn.rope": False}))


# ---------------------------------------------------------------------------
# model parity: logits and int8 caches
# ---------------------------------------------------------------------------


def _params(jm):
    """Fan-in-scale params with every norm scale (post-norms, QK-norm)
    nonzero and the QKV biases redrawn at BIAS_STD."""
    tree = numpy_params(jm)
    rng = np.random.default_rng(3)
    for slot in tree["layers"].values():
        for name in ("bq", "bk", "bv"):
            if name in slot["attn"]:
                b = slot["attn"][name]
                slot["attn"][name] = (BIAS_STD * rng.normal(size=b.shape)
                                      ).astype(np.float32)
    return tree


def _inputs(jm, tcfg, dtype):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp = to_jax(_params(jm), jdt)
    pool = numpy_lora(jm, n_slots=N_POOL)
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, BUCKET)).astype(np.int32)
    return to_numpy(jp), pool, tokens


def _leaf_bytes(cache):
    """Every cache leaf as (dtype, raw bytes)."""
    out = {}
    for slot, node in cache.items():
        for name, leaf in node.items():
            if isinstance(leaf, torch.Tensor):
                a = leaf.detach().cpu()
                dt = str(a.dtype).replace("torch.", "")
                raw = (a.view(torch.int16) if a.dtype == torch.bfloat16
                       else a).numpy().tobytes()
            else:
                a = np.asarray(leaf)
                dt, raw = str(a.dtype), a.tobytes()
            out[f"{slot}/{name}"] = (dt, raw)
    return out


@functools.lru_cache(maxsize=None)
def reference(case, dtype):
    """The reference's prefill + three decode steps: logits of each step,
    the cache after it (raw bytes) and the cache each decode step starts
    from (numpy)."""
    jcfg, tcfg = configs(case, dtype)
    jm = jax_build_model(jcfg)
    params, pool, tokens = _inputs(jm, tcfg, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jp, jpool = to_jax(params, jdt), to_jax(pool, jnp.float32)
    jmode = JaxLoRAMode("batched", jnp.asarray(SLOTS), jcfg.lora.scale,
                        "einsum", True)
    jl, jc = jax.jit(lambda p, t, c, n: jm.prefill(
        p, {"tokens": t}, c, jpool, jmode, lengths=n))(
        jp, jnp.asarray(tokens), jm.init_cache(B, MAX_CTX),
        jnp.asarray(LENGTHS))
    logits, caches = [np.asarray(jl, np.float32)], [_leaf_bytes(jc)]
    decode = jax.jit(lambda p, t, c, q: jm.decode_step(p, t, c, q, jpool,
                                                       jmode))
    nxt, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), LENGTHS
    tokens_in = []
    for _ in range(3):
        tokens_in.append((nxt, pos, jax.tree.map(np.asarray, jc)))
        jl, jc = decode(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        logits.append(np.asarray(jl, np.float32))
        caches.append(_leaf_bytes(jc))
        nxt, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1
    return params, pool, tokens, tokens_in, logits, caches


def _drop(tree, names):
    if isinstance(tree, dict):
        return {k: _drop(v, names) for k, v in tree.items()
                if k not in names}
    return tree


def port(case, dtype, off=None, *, attn_kernel=False):
    """The port on the reference's inputs (the decode steps fed the
    reference's tokens and positions; with an int8 cache, each from the
    reference's cache); ``off`` switches one feature off in the port's
    config only. Returns the logits and caches of each step."""
    params, pool, tokens, tokens_in, _, _ = reference(case, dtype)
    _, tcfg = configs(case, dtype)
    if off is not None:
        tcfg, drop = OFF[off](tcfg)
        params = _drop(params, drop)
    tm = build_model(tcfg, "cpu", attn_kernel=attn_kernel)
    tp = bridge.params_from_numpy(tm, params)
    tpool = bridge.lora_pool_from_numpy(pool)
    tmode = LoRAMode("batched", torch.from_numpy(SLOTS), tcfg.lora.scale,
                     "einsum")
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                        tm.init_cache(B, MAX_CTX), tpool, tmode,
                        lengths=torch.from_numpy(LENGTHS))
    logits, caches = [tl.float().numpy()], [_leaf_bytes(tc)]
    for nxt, pos, jcache in tokens_in:
        if tcfg.attn.kv_cache_quant:
            tc = bridge.cache_from_numpy(jcache)
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos), tpool, tmode)
        logits.append(tl.float().numpy())
        caches.append(_leaf_bytes(tc))
    return logits, caches


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference_f32(case):
    *_, want, want_caches = reference(case, "float32")
    got, got_caches = port(case, "float32")
    for w, g in zip(want, got):
        assert rel_err(g, w) <= F32_TOL
    _, tcfg = configs(case)
    if tcfg.attn.kv_cache_quant:
        # after each decode step every leaf bit for bit: int8 values,
        # bf16 scales, positions
        for step, (w, g) in enumerate(zip(want_caches[1:], got_caches[1:])):
            assert set(g) == set(w)
            for name in w:
                assert g[name] == w[name], (step, name)
        assert any(d == "int8" for d, _ in got_caches[0].values())


@pytest.mark.parametrize("case", ["gemma2-9b-int8", "llama3-8b-int8"])
def test_int8_prefill_cache_is_the_reference_quantization(monkeypatch,
                                                          case):
    """The port's int8 cache after prefill, bit for bit, is what the
    reference's ``cache_fill`` writes from the K/V the port computed."""
    fills = []
    fill = torch_attention.cache_fill

    def recording(cache, k, v, positions):
        fills.append((k.numpy().copy(), v.numpy().copy(),
                      positions.numpy().copy()))
        return fill(cache, k, v, positions)

    monkeypatch.setattr(torch_attention, "cache_fill", recording)
    _, caches = port(case, "float32")
    jcfg, _ = configs(case)
    template = jax_build_model(jcfg).init_cache(B, MAX_CTX)
    # groups run in order, slots in order within a group
    slots = sorted(template)
    for i, (k, v, positions) in enumerate(fills):
        slot, group = slots[i % len(slots)], i // len(slots)
        node = {n: leaf[group] for n, leaf in template[slot].items()}
        node = jax_attention.cache_fill(node, jnp.asarray(k), jnp.asarray(v),
                                        jnp.asarray(positions))
        for n, leaf in node.items():
            template[slot][n] = template[slot][n].at[group].set(leaf)
    # the port's prefill then invalidates pad positions (-1), as the
    # reference's does after its fills
    lengths = jnp.asarray(LENGTHS)
    for node in template.values():
        node["pos"] = jnp.where(node["pos"] < lengths[None, :, None],
                                node["pos"], -1)
    want = _leaf_bytes(template)
    got = caches[0]
    assert set(got) == set(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("case", ["gemma2-9b", "starcoder2-7b",
                                  "chameleon-34b"])
def test_forward_matches_reference_f32(case):
    """``Model.forward`` (training and scoring) on the full sequence, one
    adapter: logits within 1e-5 of max|logit|, both attention routes."""
    params, pool, tokens, *_ = reference(case, "float32")
    jcfg, tcfg = configs(case)
    jm = jax_build_model(jcfg)
    one = jax.tree.map(lambda a: a[:, 0], pool)       # pool slot 0
    want, _ = jm.forward(to_jax(params, jnp.float32), {"tokens": tokens},
                         to_jax(one, jnp.float32),
                         JaxLoRAMode("single", None, jcfg.lora.scale))
    tm = build_model(tcfg, "cpu")
    tp = bridge.params_from_numpy(tm, params)
    for kernel in (False, True):
        got, _ = tm.forward(tp, {"tokens": torch.from_numpy(tokens)},
                            bridge.lora_pool_from_numpy(one),
                            LoRAMode("single", None, tcfg.lora.scale),
                            attn_kernel=kernel)
        assert rel_err(got.numpy(), np.asarray(want)) <= F32_TOL


def _off_attn(field, value):
    def f(cfg):
        return _apply(cfg, {f"attn.{field}": value}), ()
    return f


OFF = {
    "window": _off_attn("sliding_window", 4096),
    "attn_softcap": _off_attn("attn_logit_softcap", None),
    "final_softcap": lambda cfg: (_apply(cfg, {"final_logit_softcap": None}),
                                  ()),
    "post_norm": lambda cfg: (_apply(cfg, {"post_norm": False}),
                              ("post1", "post2")),
    "scale_embeddings": lambda cfg: (_apply(cfg, {"scale_embeddings": False}),
                                     ()),
    "qk_norm": lambda cfg: (_apply(cfg, {"attn.qk_norm": False}),
                            ("q_norm", "k_norm")),
    "kv_cache_quant": _off_attn("kv_cache_quant", False),
}


@pytest.mark.parametrize("case,feature", [
    ("gemma2-9b", "window"), ("gemma2-9b", "attn_softcap"),
    ("gemma2-9b", "final_softcap"), ("gemma2-9b", "post_norm"),
    ("gemma2-9b", "scale_embeddings"), ("starcoder2-7b", "window"),
    ("chameleon-34b", "qk_norm"), ("llama3-8b-int8", "kv_cache_quant"),
])
def test_feature_is_real(case, feature):
    """Switching one feature off in the port moves its logits past 100×
    the tolerance from the reference's (with the feature on)."""
    *_, want, _ = reference(case, "float32")
    got, _ = port(case, "float32", off=feature)
    assert max(rel_err(g, w) for w, g in zip(want, got)) > 100 * F32_TOL


def test_scaled_embedding_is_rounded_to_the_param_dtype():
    """sqrt(d_model) rounded to bf16 first (59.75 at d 3584, not
    59.87), as the reference multiplies by it."""
    cfg = dataclasses.replace(get_config("gemma2-9b"), n_layers=2,
                              vocab_size=8)
    model = build_model(cfg, "cpu")
    params = {"embed": torch.ones(8, cfg.d_model, dtype=torch.bfloat16)}
    x = model.embed(params, torch.tensor([3]))
    assert x.dtype == torch.bfloat16 and float(x[0, 0]) == 59.75


def test_quantize_kv_matches_reference_bit_for_bit():
    """``_quantize_kv`` on the same inputs, ties at .5 (half to even)
    and an all-zero vector included; ``cache_fill`` and ``cache_update``
    write the same int8 values and bf16 scales."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] = np.arange(16) - 7.5 + 0.0          # .5 ties at scale 1
    x[0, 0, 1, 0] = 127.0                           # amax 127: scale 1
    jq, js = jax_attention._quantize_kv(jnp.asarray(x))
    tq, ts = torch_attention._quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jc = jax_attention.init_kv_cache(2, 4, 3, 16, jnp.float32, quant=True)
    tc = torch_attention.init_kv_cache(2, 4, 3, 16, torch.float32, quant=True)
    pos = np.arange(5, dtype=np.int32)
    jc = jax_attention.cache_fill(jc, jnp.asarray(x), jnp.asarray(x),
                                  jnp.asarray(pos))
    torch_attention.cache_fill(tc, torch.from_numpy(x), torch.from_numpy(x),
                               torch.from_numpy(pos))
    new = rng.normal(size=(2, 1, 3, 16)).astype(np.float32)
    step = np.array([5, 2], np.int32)
    jc = jax_attention.cache_update(jc, jnp.asarray(new), jnp.asarray(new),
                                    jnp.asarray(step))
    torch_attention.cache_update(tc, torch.from_numpy(new),
                                 torch.from_numpy(new),
                                 torch.from_numpy(step))
    assert _leaf_bytes({"s": tc}) == _leaf_bytes({"s": jc})


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

N_ADAPTERS = 5      # > max_resident (4) of the reduced configs
SYS_LEN, CHUNK = 16, 16


@functools.lru_cache(maxsize=None)
def engine_weights(case):
    jcfg, _ = configs(case, n_adapters=N_ADAPTERS)
    jm = jax_build_model(jcfg)
    def weight(name, shape, rng):
        # gemma2 scales its embedding up by sqrt(d): drawn at 1/sqrt(d),
        # its tied logits stay O(1), inside the final softcap's range
        # (at unit stddev they saturate it and tie)
        if name == "['embed']" and jcfg.scale_embeddings:
            return rng.normal(size=shape) / np.sqrt(shape[-1])
        return _weight(name, shape, rng)

    params = _numpy_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                         np.random.default_rng(0), weight)
    shapes = jax.eval_shape(jm.init_lora, jax.random.PRNGKey(0))
    adapters = {aid: _numpy_tree(shapes, np.random.default_rng(100 + aid),
                                 _adapter(jcfg.lora.rank))
                for aid in range(N_ADAPTERS)}
    return params, adapters


def _ecfg(policy, **kw):
    """``tests/test_trace.py``'s settings: prompts of 4-20 tokens in
    buckets of 16 and 32 against a window of 8."""
    base = dict(n_slots=2, max_ctx=48, prompt_buckets=(16, 32),
                policy=policy)
    if policy == "llamacpp":
        base["memory_budget"] = 1e12
    base.update(kw)
    return base


def _wl(cfg, **kw):
    base = dict(n_adapters=cfg.lora.n_adapters, request_rate=4.0,
                duration=3.0, input_range=(4, 20), output_range=(3, 6),
                vocab_size=cfg.vocab_size, seed=0)
    base.update(kw)
    return base


def serve_pair(monkeypatch, case, ecfg, wl):
    """One trace in both engines, each under a fresh fake timer; returns
    ((summary, trace, engine) of the reference, the same of the port)."""
    params, adapters = engine_weights(case)
    jcfg, tcfg = configs(case, n_adapters=N_ADAPTERS)
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
    assert (json.dumps(dataclasses.asdict(jsum), sort_keys=True,
                       default=float)
            == json.dumps(dataclasses.asdict(tsum), sort_keys=True,
                          default=float))
    assert set(teng._durations) == set(jeng._durations)
    return (jsum, jtrace, jeng), (tsum, ttrace, teng)


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("case", ["gemma2-9b", "starcoder2-7b",
                                  "gemma2-9b-int8"])
def test_engine_matches_reference_f32(monkeypatch, case, kv):
    """Prompts past the window: the local rings wrap in prefill (the
    paged view rebuilds what the dense ring lost to pad writes,
    ``kvpool.dense_ring_positions``)."""
    _, (tsum, ttrace, teng) = serve_pair(monkeypatch, case,
                                         _ecfg("edgelora", kv_backend=kv),
                                         {})
    assert max(r.prompt_len for r in ttrace) > WINDOW
    assert max(r.prompt_len + r.output_len for r in ttrace) > 2 * WINDOW
    if kv == "paged":
        assert tsum.kv_stats["allocs"] > 0
        # the int8 arena pages the values and their scales alike
        leaves = set(teng.cache["slot0"])
        want = {"k", "v"} | ({"k_scale", "v_scale"}
                             if teng.cfg.attn.kv_cache_quant else set())
        assert leaves == want


def test_llamacpp_on_starcoder2_matches_reference(monkeypatch):
    """Merged steps only, on a non-GLU MLP: the adapter (and its merge
    cost) carries q, k, v, o, up, down and no gate."""
    _, (tsum, _, teng) = serve_pair(monkeypatch, "starcoder2-7b",
                                    _ecfg("llamacpp"), {})
    assert {k[0] for k in teng._durations} == {"prefill_merged",
                                               "decode_merged"}
    mods = set(teng.lora_pool["layers"]["slot0"])
    assert mods == {"q", "k", "v", "o", "up", "down"}


def test_chameleon_prefix_cache_and_chunks_match_reference(monkeypatch):
    """Global bf16-free rings: the prefix cache and chunked prefill
    both run (suffix steps over cached prefixes, prefix hits)."""
    (jsum, _, _), (tsum, ttrace, teng) = serve_pair(
        monkeypatch, "chameleon-34b",
        _ecfg("edgelora_no_aas", kv_backend="paged", kv_block_size=8,
              prefix_cache=True, prefill_chunk=CHUNK),
        dict(duration=1.5, request_rate=6.0, system_prompt_len=SYS_LEN,
             input_range=(4, 24)))
    assert any(k[0] == "prefill_sfx" for k in teng._durations)
    ps = tsum.prefix_stats
    assert ps["hit_requests"] > 0 and ps["saved_prefill_tokens"] > 0, ps
    assert max(r.prompt_len for r in ttrace) > CHUNK


@pytest.mark.parametrize("case,change", [
    ("gemma2-9b", dict(kv_backend="paged", prefix_cache=True)),
    ("gemma2-9b", dict(prefill_chunk=CHUNK)),
    ("gemma2-9b", dict(kv_backend="paged", prefill_chunk=CHUNK)),
    ("starcoder2-7b", dict(prefill_chunk=CHUNK)),
    ("llama3-8b-int8", dict(kv_backend="paged", prefix_cache=True)),
    ("llama3-8b-int8", dict(prefill_chunk=CHUNK)),
])
def test_prefix_and_chunk_refusals_match_reference(case, change):
    jcfg, tcfg = configs(case, n_adapters=N_ADAPTERS)
    kw = _ecfg("edgelora", **change)
    with pytest.raises(ValueError) as jerr:
        jax_engine.EdgeLoRAEngine(jcfg, jax_engine.EngineConfig(**kw))
    with pytest.raises(ValueError) as terr:
        torch_engine.EdgeLoRAEngine(tcfg, torch_engine.EngineConfig(**kw),
                                    device="cpu")
    assert str(terr.value) == str(jerr.value)
    assert ("window-local ring" in str(terr.value)
            or "int8-quantized" in str(terr.value))


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_arch_on_cpu(arch):
    """``launch/serve.py --arch`` on the reduced config."""
    from test_torch_engine import _run_cli
    out = _run_cli("--device", "cpu", "--arch", arch, "--n-adapters", "6",
                   "--rate", "3", "--duration", "2", "--max-ctx", "64")
    assert out.returncode == 0, out.stderr
    row = out.stdout.strip().splitlines()[-1]
    done, total = row.split("completed=")[1].split()[0].split("/")
    assert done == total and int(total) > 0
