"""The port's SSM and hybrid families, and qwen1.5-110b, against the JAX
package's, on bridged weights: mamba2-130m (24 Mamba-2 layers; reduced:
2), zamba2-2.7b (54 Mamba-2 layers with an MLP each and one weight-tied
attention + MLP block after every 6; reduced: 4 layers, the block after
every 2) and qwen1.5-110b (dense, QKV bias; reduced: 2 layers).

* ``segsum`` and ``ssd_chunked`` in f32 against the reference's and
  against the naive token-by-token recurrence of ``tests/test_ssm.py``,
  at the reference's chunk sweep, with an initial state carried over.
* ``ssm_block_full`` (batched LoRA over mixed adapters, ``seq_mask`` and
  ``lengths`` over ragged rows, prompts of 1 and 2 tokens whose conv tail
  is clipped as in the reference) and ``ssm_block_decode``, within 1e-5
  of max|ref|; ``softplus`` equal to ``jax.nn.softplus`` past 20, where
  ``F.softplus`` switches to the identity.
* The model: prefill over right-padded rows with mixed adapters and
  three decode steps in f32 within 1e-5 of max|logit| of the reference,
  on both attention routes; ``Model.forward`` with zero aux losses; the
  state carry (a prefill of S tokens then one decode step equals the
  last position of a prefill of S + 1) within 1e-5; one LoRA train step
  on mamba2.
* Engines in f32 under the fake timer: streams, step counters and the
  whole summary equal the reference's for mamba2 and zamba2, dense and
  paged, under ``edgelora`` and ``dlora`` (the reference's own
  ``test_streams_identical_ssm_and_hybrid`` holds dense equal to paged);
  the prefix cache and chunked prefill refused with the reference's
  messages.

The file takes ~55 s on one CPU core.
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
from repro.models import ssm as jax_ssm  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.serving import engine as torch_engine  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.training import optimizer, train  # noqa: E402

from test_ssm import _inputs, naive_ssd  # noqa: E402
from test_torch_engine import _adapter, _FakeTime, _numpy_tree  # noqa: E402
from test_torch_model import (numpy_lora, numpy_params, rel_err,  # noqa: E402
                              to_jax, to_numpy)
from test_torch_policies import _weight, one_torch_thread  # noqa: E402,F401

MAMBA2, ZAMBA2, QWEN15 = "mamba2-130m", "zamba2-2.7b", "qwen1.5-110b"
ARCHS = (MAMBA2, ZAMBA2, QWEN15)
F32_TOL = 1e-5
N_POOL, B, S, MAX_CTX = 4, 3, 40, 64
# right-padded rows, one of them a 2-token prompt (its conv tail clipped);
# at the reduced chunk of 32 the 40-token bucket pads to two chunks
LENGTHS = np.array([40, 2, 23], np.int32)
SLOTS = np.array([2, 0, 3], np.int32)        # mixed adapters


def configs(arch, **over):
    """(reference config, port config): the reduced arch, in f32 unless
    ``over`` says otherwise."""
    over = {"dtype": "float32", **over}
    return tuple(dataclasses.replace(reduce(get(arch)), **over)
                 for get, reduce in ((jax_get_config, jax_reduced_config),
                                     (get_config, reduced_config)))


# ---------------------------------------------------------------------------
# configs and trees
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_resolves_arch(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    check_supported(tcfg)
    jr, tr = jax_reduced_config(jcfg), reduced_config(tcfg)
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    check_supported(tr)
    if tcfg.ssm is not None:
        s, d = tcfg.ssm, tcfg.d_model
        assert (s.d_inner(d), s.n_heads(d), s.a_init_range) == (
            jcfg.ssm.d_inner(d), jcfg.ssm.n_heads(d), jcfg.ssm.a_init_range)


@pytest.mark.parametrize("arch", (MAMBA2, ZAMBA2))
def test_param_and_lora_trees_match_reference(arch):
    """Paths and shapes of the params, of a LoRA pool and of one adapter;
    zamba2's per-slot MLPs and its one shared block, whose LoRA (q, k, v,
    o, pool axis only) has no MLP modules; ``dt_bias``, ``A_log`` and
    ``D`` in f32 under a bf16 model, bridged from the reference's tree."""
    jcfg, tcfg = configs(arch, dtype="bfloat16")
    jm, tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = tm.init(torch.Generator().manual_seed(0))
    shape = functools.partial(jax.tree.map, lambda a: tuple(a.shape))
    assert shape(want) == jax.tree.map(lambda t: tuple(t.shape), got)
    dtypes = jax.tree.map(lambda a: str(a.dtype), want)
    assert jax.tree.map(lambda t: str(t.dtype).replace("torch.", ""),
                        got) == dtypes
    for n_slots in (None, 2):
        lw = jax.eval_shape(lambda k: jm.init_lora(k, n_slots=n_slots),
                            jax.random.PRNGKey(0))
        lg = tm.init_lora(torch.Generator().manual_seed(0), n_slots=n_slots)
        assert shape(lw) == jax.tree.map(lambda t: tuple(t.shape), lg)
    slot0 = got["layers"]["slot0"]
    assert set(lg["layers"]["slot0"]) == {"in_proj", "out_proj"}
    if arch == ZAMBA2:
        assert "mlp" in slot0 and set(lg["shared_attn"]) == set("qkvo")
        assert lg["shared_attn"]["q"]["A"].shape[0] == 2     # pool axis
    else:
        assert "mlp" not in slot0 and "shared_attn" not in lg
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tp = bridge.params_from_numpy(build_model(tcfg, "cpu"), params)
    for name in ("dt_bias", "A_log", "D"):
        assert tp["layers"]["slot0"]["ssm"][name].dtype == torch.float32
    assert tp["layers"]["slot0"]["ssm"]["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["layers"]["slot0"]["ssm"]["A_log"].numpy(),
        params["layers"]["slot0"]["ssm"]["A_log"])


# ---------------------------------------------------------------------------
# the SSD and the block
# ---------------------------------------------------------------------------


def test_segsum_matches_reference():
    x = np.random.default_rng(0).normal(size=(2, 3, 7)).astype(np.float32)
    want = np.asarray(jax_ssm.segsum(jnp.asarray(x)))
    got = ssm.segsum(torch.from_numpy(x)).numpy()
    assert np.array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-6)


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_ssd_chunked_matches_reference_and_naive(chunk):
    """The reference's chunk sweep, both halves of a sequence, the second
    from the first's final state (the reference's continuation test)."""
    x, dt, a, b, c = _inputs(2, 16, 4, 8, 2, 6, seed=chunk)
    y_ref, f_ref = naive_ssd(x, dt, a, b, c)
    jy, jf = jax_ssm.ssd_chunked(x, dt, a, b, c, chunk=chunk)
    ty, tf = ssm.ssd_chunked(*_t(x, dt, a, b, c), chunk=chunk)
    for got, want in ((ty, jy), (tf, jf)):
        assert rel_err(got.numpy(), np.asarray(want)) <= F32_TOL
    np.testing.assert_allclose(ty.numpy(), y_ref, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tf.numpy(), f_ref, rtol=1e-4, atol=1e-4)
    h = 8
    ty1, tf1 = ssm.ssd_chunked(*_t(x[:, :h], dt[:, :h], a, b[:, :h],
                                   c[:, :h]), chunk=min(chunk, h))
    ty2, tf2 = ssm.ssd_chunked(*_t(x[:, h:], dt[:, h:], a, b[:, h:],
                                   c[:, h:]), chunk=min(chunk, h),
                               initial_state=tf1)
    jy2, jf2 = jax_ssm.ssd_chunked(x[:, h:], dt[:, h:], a, b[:, h:],
                                   c[:, h:], chunk=min(chunk, h),
                                   initial_state=jnp.asarray(tf1.numpy()))
    assert rel_err(ty2.numpy(), np.asarray(jy2)) <= F32_TOL
    assert rel_err(tf2.numpy(), np.asarray(jf2)) <= F32_TOL
    np.testing.assert_allclose(ty2.numpy(), y_ref[:, h:], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tf2.numpy(), f_ref, rtol=1e-4, atol=1e-4)


def test_softplus_matches_jax_past_the_threshold():
    x = np.array([-30.0, -3.0, 0.0, 0.5, 19.5, 20.0, 20.5, 25.0, 60.0],
                 np.float32)
    got = ssm.softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.nn.softplus(x)))


def _block_params(cfg, rng):
    shapes = jax.eval_shape(
        lambda k: jax_ssm.ssm_init(k, cfg, dtype=jnp.float32),
        jax.random.PRNGKey(0))
    # fan-in scale for the matrices; the per-head and per-channel vectors
    # (dt_bias, D, conv_b, the gate norm) drawn around their init values
    params = _numpy_tree(shapes, rng, lambda name, shape, rng: (
        rng.normal(size=shape) / np.sqrt(shape[-2]) if len(shape) == 2
        else 0.3 * rng.normal(size=shape)))
    params["A_log"] = np.log(np.linspace(1.0, 16.0, params["A_log"].size,
                                         dtype=np.float32))
    params["D"] = params["D"] + np.float32(1.0)
    return params


def _block_lora(cfg, rng):
    d, r = cfg.d_model, 4
    s = cfg.ssm
    din = 2 * s.d_inner(d) + 2 * s.n_groups * s.d_state + s.n_heads(d)
    return {m: {"A": (rng.normal(size=(N_POOL, r, di)) / 2).astype(
        np.float32), "B": (0.05 * rng.normal(size=(N_POOL, do, r))
                           ).astype(np.float32)}
            for m, (di, do) in (("in_proj", (d, din)),
                                ("out_proj", (s.d_inner(d), d)))}


# (rows' real lengths in a bucket of the width, chunk size): ragged rows
# over two chunks, prompts of 1 and 2 tokens (conv tail clipped)
BLOCK_CASES = {
    "ragged": ((40, 2, 23), 32),
    "short": ((1, 2, 3), 32),
    "one-chunk": ((16, 9, 16), 16),
}


@pytest.mark.parametrize("name", list(BLOCK_CASES))
def test_ssm_block_full_and_decode_match_reference(name):
    lengths, chunk = BLOCK_CASES[name]
    jcfg, tcfg = configs(MAMBA2)
    jcfg, tcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, chunk_size=chunk)) for c in (jcfg, tcfg))
    rng = np.random.default_rng(3)
    params, lora = _block_params(jcfg, rng), _block_lora(jcfg, rng)
    lengths = np.array(lengths, np.int32)
    b, s = len(lengths), int(lengths.max())
    x = rng.normal(size=(b, s, jcfg.d_model)).astype(np.float32)
    mask = np.arange(s)[None, :] < lengths[:, None]
    ids = SLOTS[:b]
    jmode = JaxLoRAMode("batched", jnp.asarray(ids), 2.0, "einsum", True)
    tmode = LoRAMode("batched", torch.from_numpy(ids), 2.0, "einsum")
    jp, jl = to_jax(params, jnp.float32), to_jax(lora, jnp.float32)
    tp, tl = bridge.tree_from_numpy(params), bridge.tree_from_numpy(lora)
    want = jax.jit(lambda p, x, lo, m, n: jax_ssm.ssm_block_full(
        p, x, jcfg, lo, jmode, return_state=True, seq_mask=m, lengths=n))(
        jp, jnp.asarray(x), jl, jnp.asarray(mask), jnp.asarray(lengths))
    got = ssm.ssm_block_full(tp, torch.from_numpy(x), tcfg, tl, tmode,
                             return_state=True,
                             seq_mask=torch.from_numpy(mask),
                             lengths=torch.from_numpy(lengths))
    for g, w in zip(got, want):                  # y, state, conv tail
        assert rel_err(g.numpy(), np.asarray(w)) <= F32_TOL
    # the unmasked block without state (the training forward's call)
    assert rel_err(ssm.ssm_block_full(tp, torch.from_numpy(x), tcfg, tl,
                                      tmode).numpy(),
                   np.asarray(jax.jit(lambda p, x, lo: jax_ssm.ssm_block_full(
                       p, x, jcfg, lo, jmode))(jp, jnp.asarray(x), jl))
                   ) <= F32_TOL
    # two decode steps from the prefill's state
    jc = {"conv": want[2], "state": want[1]}
    tc = {"conv": got[2], "state": got[1]}
    decode = jax.jit(lambda p, x, c, lo: jax_ssm.ssm_block_decode(
        p, x, c, jcfg, lo, jmode))
    for step in range(2):
        xt = rng.normal(size=(b, jcfg.d_model)).astype(np.float32)
        jy, jc = decode(jp, jnp.asarray(xt), jc, jl)
        ty, tc = ssm.ssm_block_decode(tp, torch.from_numpy(xt), tc, tcfg, tl,
                                      tmode)
        assert rel_err(ty.numpy(), np.asarray(jy)) <= F32_TOL, step
        for k in ("conv", "state"):
            assert rel_err(tc[k].numpy(), np.asarray(jc[k])) <= F32_TOL


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def reference(arch):
    """The reference's prefill + three decode steps on numpy params and
    pool: (params, pool, tokens, [(tokens, pos)] of each decode step,
    logits of each step)."""
    jcfg, _ = configs(arch)
    jm = jax_build_model(jcfg)
    params, pool = numpy_params(jm), numpy_lora(jm, n_slots=N_POOL)
    tokens = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, S)).astype(np.int32)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_f32(arch):
    """Right-padded rows (one of 2 tokens), mixed adapters, decode steps
    fed the reference's tokens; the plain and the kernel attention route
    (on the CPU the kernel wrappers run their plain versions)."""
    params, pool, tokens, steps, want = reference(arch)
    _, tcfg = configs(arch)
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


@pytest.mark.parametrize("arch", (MAMBA2, ZAMBA2))
def test_state_carry_prefill_then_decode(arch):
    """A prefill of S tokens then a decode step on token S gives the
    logits of the last position of a prefill of S + 1 tokens: the chunked
    dual form and the recurrence agree, across a chunk boundary (S 32 at
    the reduced chunk of 32) and inside one (S 5)."""
    params, pool, *_ = reference(arch)
    _, tcfg = configs(arch)
    tm = build_model(tcfg, "cpu")
    tp = bridge.params_from_numpy(tm, params)
    tpool = bridge.lora_pool_from_numpy(pool)
    tmode = LoRAMode("batched", torch.from_numpy(SLOTS[:2]), tcfg.lora.scale,
                     "einsum")
    for s in (5, 32):
        toks = torch.from_numpy(np.random.default_rng(s).integers(
            0, tcfg.vocab_size, (2, s + 1)).astype(np.int32))
        with torch.no_grad():
            _, cache = tm.prefill(tp, {"tokens": toks[:, :s]},
                                  tm.init_cache(2, MAX_CTX), tpool, tmode)
            got, _ = tm.decode_step(tp, toks[:, s], cache,
                                    torch.full((2,), s, dtype=torch.int32),
                                    tpool, tmode)
            want, _ = tm.prefill(tp, {"tokens": toks},
                                 tm.init_cache(2, MAX_CTX), tpool, tmode)
        assert rel_err(got.numpy(), want.numpy()) <= F32_TOL, s


@pytest.mark.parametrize("arch", (MAMBA2, ZAMBA2))
def test_forward_matches_reference(arch):
    """``Model.forward`` with one adapter: logits within 1e-5 of
    max|logit|, both aux losses exactly zero."""
    jcfg, tcfg = configs(arch)
    jm = jax_build_model(jcfg)
    params, lora = numpy_params(jm), numpy_lora(jm)
    tokens = np.random.default_rng(6).integers(
        0, tcfg.vocab_size, (2, 37)).astype(np.int32)
    want, _ = jax.jit(lambda p, t, lo: jm.forward(
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
    assert {k: float(v) for k, v in aux.items()} == {"load_balance": 0.0,
                                                      "router_z": 0.0}


def test_lora_train_step_matches_reference():
    """One LoRA train step on reduced mamba2 from bridged params: the
    loss within 1e-6 (relative), the updated adapter within 1e-5
    (absolute, ``tests/test_torch_training.py``'s LEAF_ATOL)."""
    jcfg, tcfg = configs(MAMBA2)
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
    assert abs(float(tmet["loss"]) - float(jmet["loss"])) <= 1e-6 * abs(
        float(jmet["loss"]))
    want = jax.tree_util.tree_leaves(to_numpy(js.lora))
    got = optimizer.tree_leaves(ts.lora)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert float(np.abs(g.detach().numpy() - w).max()) <= 1e-5


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

N_ADAPTERS = 5      # > max_resident (4) of the reduced configs


@functools.lru_cache(maxsize=None)
def engine_weights(arch):
    jcfg, _ = configs(arch, lora=dataclasses.replace(
        jax_reduced_config(jax_get_config(arch)).lora, n_adapters=N_ADAPTERS))
    jm = jax_build_model(jcfg)
    params = _numpy_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                         np.random.default_rng(0), _weight)
    shapes = jax.eval_shape(jm.init_lora, jax.random.PRNGKey(0))
    adapters = {aid: _numpy_tree(shapes, np.random.default_rng(100 + aid),
                                 _adapter(jcfg.lora.rank))
                for aid in range(N_ADAPTERS)}
    return params, adapters


def engine_configs(arch):
    return tuple(dataclasses.replace(c, lora=dataclasses.replace(
        c.lora, n_adapters=N_ADAPTERS)) for c in configs(arch))


def _ecfg(policy, **kw):
    return dict(dict(n_slots=2, max_ctx=48, prompt_buckets=(16, 32),
                     policy=policy), **kw)


def _wl(cfg):
    return dict(n_adapters=cfg.lora.n_adapters, request_rate=4.0,
                duration=2.0, input_range=(4, 20), output_range=(3, 6),
                vocab_size=cfg.vocab_size, seed=0)


@pytest.mark.parametrize("arch,policy,kv", [
    (a, p, kv) for a in (MAMBA2, ZAMBA2) for p in ("edgelora", "dlora")
    for kv in ("dense", "paged")])
def test_engine_matches_reference_f32(monkeypatch, arch, policy, kv):
    """One trace in both engines, each under a fresh fake timer: equal
    streams, per-request times, step counters and summaries. Paged
    mamba2 is the pool's bookkeeping only (no attention node); paged
    zamba2 gathers the shared block's ring."""
    params, adapters = engine_weights(arch)
    jcfg, tcfg = engine_configs(arch)
    ecfg = _ecfg(policy, kv_backend=kv)
    monkeypatch.setattr(
        jax_engine.EdgeLoRAEngine, "_adapter_host",
        lambda self, aid: jax.tree.map(jnp.asarray, adapters[aid]))
    jeng = jax_engine.EdgeLoRAEngine(
        jcfg, jax_engine.EngineConfig(**ecfg),
        params=jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr("repro.serving.engine.time", _FakeTime())
    jtrace = jax_workload.generate_trace(jax_workload.WorkloadConfig(
        **_wl(jcfg)))
    jsum = jeng.serve(jtrace)
    teng = torch_engine.EdgeLoRAEngine(
        tcfg, torch_engine.EngineConfig(**ecfg),
        params=bridge.tree_from_numpy(params), device="cpu",
        timer=_FakeTime(), adapter_source=lambda aid:
        bridge.lora_pool_from_numpy(adapters[aid]))
    ttrace = workload.generate_trace(workload.WorkloadConfig(**_wl(tcfg)))
    tsum = teng.serve(ttrace)
    assert jsum.n_completed == jsum.n_requests == len(jtrace) > 0
    for a, b in zip(jtrace, ttrace):
        assert a.tokens == b.tokens, a.request_id
        for f in ("selected_adapter", "first_token_time", "finish_time",
                  "generated", "rejected"):
            assert getattr(a, f) == getattr(b, f), (a.request_id, f)
    for f in ("prefill_steps", "decode_steps", "kv_stats", "swap_stats"):
        assert getattr(tsum, f) == getattr(jsum, f), f
    assert (json.dumps(dataclasses.asdict(tsum), sort_keys=True,
                       default=float)
            == json.dumps(dataclasses.asdict(jsum), sort_keys=True,
                          default=float))
    assert set(teng._durations) == set(jeng._durations)
    if kv == "paged":
        assert tsum.kv_stats["allocs"] > 0
        assert bool(teng._kv_meta.attn_paths) == (arch == ZAMBA2)


@pytest.mark.parametrize("arch,change", [
    (a, c) for a in (MAMBA2, ZAMBA2) for c in (
        dict(kv_backend="paged", prefix_cache=True),
        dict(kv_backend="dense", prefill_chunk=16),
        dict(kv_backend="paged", prefill_chunk=16))])
def test_prefix_and_chunks_refused_like_reference(arch, change):
    jcfg, tcfg = engine_configs(arch)
    kw = _ecfg("edgelora", **change)
    with pytest.raises(ValueError) as jerr:
        jax_engine.EdgeLoRAEngine(jcfg, jax_engine.EngineConfig(**kw))
    with pytest.raises(ValueError) as terr:
        torch_engine.EdgeLoRAEngine(tcfg, torch_engine.EngineConfig(**kw),
                                    device="cpu")
    assert str(terr.value) == str(jerr.value)
    feature = "prefix_cache" if "prefix_cache" in change else "prefill_chunk"
    assert str(terr.value).startswith(f"{feature} unsupported")
    # the first node of the reference's sorted walk: zamba2's 'shared'
    # ring comes before its SSM slots
    assert ("weight-tied shared-attention ring" if arch == ZAMBA2
            else "per-sequence recurrent state") in str(terr.value)
