"""The port's encoder-decoder family (whisper-medium) against the JAX
package's, on bridged weights. whisper-medium: 24 + 24 layers, d 1024,
16/16 heads of 64, a GELU MLP without a gate, no RoPE, 1500 frames;
reduced: 2 + 2 layers, d 256, 4/4 heads of 64, 64 frames.

* The config (a copy: its module differs from the reference's only in
  its import line), the param tree (LayerNorms, the decoder's cross
  block, each ``ln_post``) and the LoRA tree (encoder and decoder on q,
  v, o, up, down; cross on q and o), paths and shapes equal.
* ``sinusoidal_positions`` and ``layernorm`` in f32 and bf16; the
  encoder's ``'bidir'`` ``blockwise_attention`` against the reference's
  and against the reference's Pallas ``flash_prefill(causal=False)`` in
  interpret mode (hd 64, GQA 1, S 64, blocks that split the sequence);
  ``encode_cross_kv`` and ``cross_attention`` with per-row adapters.
* The model: ``forward``, and ``prefill`` over right-padded rows with
  mixed adapters (B nonzero) then three decode steps fed the
  reference's tokens, on both attention routes (on the CPU the kernel
  wrappers run their plain versions): f32 within 1e-5 of max|logit|,
  bf16 within ``BF16_TOL``; batched-adapter rows equal to solo runs; one
  LoRA train step (loss, grad norm and the updated adapter).
* The refusals: the serving engine and both CLIs refuse an
  encoder-decoder config, naming the missing ``frames``, where the
  reference's engine fails with ``KeyError: 'frames'`` in its first
  prefill; the paged, suffix and chunk steps refuse it.

The file takes ~35 s on one CPU core.
"""
import dataclasses
import functools
import inspect
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
from repro.configs import whisper_medium as jax_whisper  # noqa: E402
from repro.core.lora import LoRAMode as JaxLoRAMode  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill  # noqa: E402
from repro.models import attention as jax_attn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as jax_encdec  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.configs import whisper_medium  # noqa: E402
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, encdec  # noqa: E402
from repro_torch.models.layers import layernorm  # noqa: E402
from repro_torch.models.model import check_supported  # noqa: E402
from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig  # noqa: E402
from repro_torch.training import optimizer, train  # noqa: E402

from test_torch_model import (BF16_TOL, numpy_lora, rel_err,  # noqa: E402
                              to_jax, to_numpy)

ROOT = Path(__file__).resolve().parents[1]
WHISPER = "whisper-medium"
F32_TOL = 1e-5
N_POOL, B, S, MAX_CTX = 4, 3, 24, 40
LENGTHS = np.array([24, 2, 13], np.int32)    # right-padded rows
SLOTS = np.array([2, 0, 3], np.int32)        # mixed adapters
DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def configs(dtype="float32"):
    """(reference config, port config): reduced whisper-medium."""
    return tuple(dataclasses.replace(reduce(get(WHISPER)), dtype=dtype)
                 for get, reduce in ((jax_get_config, jax_reduced_config),
                                     (get_config, reduced_config)))


def numpy_params(jm, seed=0):
    """The reference's param tree at fan-in scale, drawn with numpy:
    LayerNorm scales around 1 and biases around 0, the RMSNorm head's
    scale (it enters as 1 + scale) around 0."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        noise = rng.normal(size=sd.shape)
        if name.endswith("['bias']") or "final_norm" in name:
            return (0.1 * noise).astype(np.float32)
        if name.endswith("['scale']"):
            return (1.0 + 0.1 * noise).astype(np.float32)
        if name == "['embed']":
            return noise.astype(np.float32)
        return (noise / np.sqrt(sd.shape[-2])).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def frames(cfg, b, seed=5):
    return np.random.default_rng(seed).normal(
        size=(b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)


def cast(a, dtype):
    """numpy ``a`` rounded to ``dtype`` (bf16 as ml_dtypes)."""
    return np.asarray(jnp.asarray(a, DTYPES[dtype]))


class Pair:
    """Reduced whisper in both packages on bridged weights and pool."""

    def __init__(self, dtype):
        self.jcfg, self.cfg = configs(dtype)
        self.jm = jax_build_model(self.jcfg)
        self.jp = to_jax(numpy_params(self.jm), DTYPES[dtype])
        self.params = to_numpy(self.jp)
        pool = numpy_lora(self.jm, n_slots=N_POOL)
        self.jpool, self.pool = to_jax(pool, jnp.float32), pool
        rng = np.random.default_rng(2)
        self.tokens = rng.integers(0, self.cfg.vocab_size,
                                   (B, S)).astype(np.int32)
        self.frames = cast(frames(self.cfg, B), dtype)

    def port(self, attn_kernel=False):
        tm = build_model(self.cfg, "cpu", attn_kernel=attn_kernel)
        return tm, bridge.params_from_numpy(tm, self.params)

    def jmode(self, slots=SLOTS):
        return JaxLoRAMode("batched", jnp.asarray(slots), self.cfg.lora.scale,
                           "einsum", True)

    def tmode(self, slots=SLOTS):
        return LoRAMode("batched", torch.from_numpy(slots),
                        self.cfg.lora.scale, "einsum")

    def batch(self, rows=slice(None)):
        return ({"tokens": jnp.asarray(self.tokens[rows]),
                 "frames": jnp.asarray(self.frames[rows])},
                {"tokens": torch.from_numpy(self.tokens[rows]),
                 "frames": bridge.tensor_from_numpy(self.frames[rows])})


@functools.lru_cache(maxsize=None)
def pair(dtype):
    return Pair(dtype)


@functools.lru_cache(maxsize=None)
def reference_steps(dtype):
    """The reference's prefill + three decode steps: ([(tokens, pos)] of
    each decode step, logits of each step as f32 numpy)."""
    p = pair(dtype)
    jm, mode = p.jm, p.jmode()
    jl, jc = jax.jit(lambda pr, bt, c, n: jm.prefill(
        pr, bt, c, p.jpool, mode, lengths=n))(
        p.jp, p.batch()[0], jm.init_cache(B, MAX_CTX), jnp.asarray(LENGTHS))
    logits = [np.asarray(jl, np.float32)]
    decode = jax.jit(lambda pr, t, c, q: jm.decode_step(pr, t, c, q, p.jpool,
                                                        mode))
    nxt = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos, steps = LENGTHS, []
    for _ in range(3):
        steps.append((nxt, pos))
        jl, jc = decode(p.jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        logits.append(np.asarray(jl, np.float32))
        nxt, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1
    return steps, logits


def assert_logits_close(got, want, tol, where):
    """Within ``tol`` of max|logit|; in bf16 (tol > F32_TOL) also top-1
    equal on every row whose top-2 margin exceeds that."""
    assert rel_err(got, want) <= tol, (where, rel_err(got, want))
    if tol > F32_TOL:
        top2 = np.sort(want, -1)[..., -2:]
        clear = (top2[..., 1] - top2[..., 0]) > tol * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


# ---------------------------------------------------------------------------
# config and trees
# ---------------------------------------------------------------------------


def test_config_is_a_copy_of_the_reference():
    jcfg, tcfg = jax_get_config(WHISPER), get_config(WHISPER)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    jr, tr = configs("bfloat16")
    assert dataclasses.asdict(tr) == dataclasses.asdict(jr)
    assert tr.encoder.n_frames == 64 and tr.encoder.n_layers == 2
    check_supported(tcfg)
    check_supported(tr)
    want = inspect.getsource(jax_whisper).splitlines()
    got = inspect.getsource(whisper_medium).splitlines()
    diff = [(a, b) for a, b in zip(want, got) if a != b]
    assert len(want) == len(got) and diff == [(
        "from repro.configs.base import AttentionConfig, EncoderConfig, "
        "LoRAConfig, ModelConfig",
        "from repro_torch.configs.base import AttentionConfig, "
        "EncoderConfig, LoRAConfig, ModelConfig")]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_param_tree_matches_reference(dtype):
    """Paths, shapes and dtypes of the params, drawn in the port and
    bridged from the reference's tree."""
    jcfg, tcfg = configs(dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
    want = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    got = tm.init(torch.Generator().manual_seed(0))

    def spec(t):
        return tuple(t.shape), str(t.dtype).replace("torch.", "")

    assert jax.tree.map(spec, got) == jax.tree.map(spec, want)
    assert set(got) == {"embed", "final_norm", "lm_head", "encoder",
                        "decoder"}
    assert set(got["decoder"]["layers"]) == {"ln1", "attn", "ln_x", "cross",
                                             "ln2", "mlp"}
    assert set(got["encoder"]["layers"]["ln1"]) == {"scale", "bias"}
    params = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    tp = bridge.params_from_numpy(build_model(tcfg, "cpu"), params)
    assert jax.tree.map(spec, tp) == jax.tree.map(spec, want)
    with pytest.raises(ValueError, match="param tree mismatch"):
        bridge.params_from_numpy(build_model(tcfg, "cpu"),
                                 dict(params, encoder=params["decoder"]))


@pytest.mark.parametrize("n_slots", [None, N_POOL])
def test_lora_tree_matches_reference(n_slots):
    """``init_encdec_lora``: encoder and decoder on q, v, o, up, down,
    cross on q and o, leaves [n_layers, (R,) r, d]."""
    jcfg, tcfg = configs()
    want = jax.eval_shape(lambda k: jax_build_model(jcfg).init_lora(
        k, n_slots=n_slots), jax.random.PRNGKey(0))
    got = build_model(tcfg, "cpu").init_lora(torch.Generator().manual_seed(0),
                                             n_slots=n_slots)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == jax.tree.map(
        lambda a: tuple(a.shape), want)
    assert {k: sorted(v) for k, v in got.items()} == {
        "encoder": ["down", "o", "q", "up", "v"],
        "decoder": ["down", "o", "q", "up", "v"], "cross": ["o", "q"]}
    assert got["cross"]["q"]["A"].shape[0] == tcfg.n_layers
    assert float(got["decoder"]["q"]["B"].abs().max()) == 0.0


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sinusoidal_positions_match_reference(dtype):
    """f32 embeddings of arange and of per-row positions (decode), and
    the model dtype's rounding of them; an odd and a tiny width. The
    frequencies' exponents are equal; XLA's f32 ``exp`` and torch's
    differ by up to one ulp on some of them, which the angle multiplies
    by the position: held within 2 f32 ulps of the angle (p · 2^-22)
    plus 1e-6 (bf16: plus one rounding step, 2^-8)."""
    pos = np.array([[0, 7, 1499], [3, 3, 40000]], np.int32)
    base = 1e-6 if dtype == "float32" else 2 ** -8
    for d in (256, 1024, 3, 2):
        for p in (np.arange(64, dtype=np.int32), pos):
            want = np.asarray(jax_encdec.sinusoidal_positions(
                jnp.asarray(p), d).astype(DTYPES[dtype]), np.float32)
            got = encdec.sinusoidal_positions(torch.from_numpy(p), d).to(
                getattr(torch, dtype)).float().numpy()
            assert got.shape == want.shape == (*p.shape, 2 * (d // 2))
            tol = base + p[..., None] * 2.0 ** -22
            assert (np.abs(got - want) <= tol).all(), (d, p)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    """The population variance (torch's default is the sample one), with
    an offset mean and a scale and bias."""
    rng = np.random.default_rng(4)
    x = cast(3.0 + 2.0 * rng.normal(size=(3, 5, 64)), dtype)
    p = {"scale": cast(1 + 0.1 * rng.normal(size=64), dtype),
         "bias": cast(0.1 * rng.normal(size=64), dtype)}
    want = np.asarray(jax_layers.layernorm(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), 1e-5), np.float32)
    got = layernorm(bridge.tree_from_numpy(p), bridge.tensor_from_numpy(x),
                    1e-5)
    assert str(got.dtype) == f"torch.{dtype}"
    tol = F32_TOL if dtype == "float32" else 2 ** -7
    assert rel_err(got.float().numpy(), want) <= tol


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("blocks", [(64, 64), (16, 32)])
def test_bidir_attention_matches_reference_and_pallas(blocks):
    """The encoder's 'bidir' attention at hd 64, GQA 1, S 64 in f32: the
    plain blockwise loops (whole sequence, or blocks that split it) and
    the kernel route against the reference's ``blockwise_attention``
    and its Pallas ``flash_prefill(causal=False)`` in interpret mode."""
    _, tcfg = configs()
    jcfg, _ = configs()
    rng = np.random.default_rng(9)
    q, k, v = (rng.normal(size=(2, 64, 4, 64)).astype(np.float32)
               for _ in range(3))
    pos = np.arange(64, dtype=np.int32)
    bq, bkv = blocks
    want = np.asarray(jax_attn.blockwise_attention(
        *map(jnp.asarray, (q, k, v, pos, pos)), kind="bidir", cfg=jcfg,
        block_q=bq, block_kv=bkv))
    pallas = np.asarray(jax_flash_prefill(*map(jnp.asarray, (q, k, v)),
                                          causal=False, blk_q=bq, blk_kv=bkv,
                                          interpret=True))
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos))
    for kernel in (False, True):
        got = attn.blockwise_attention(tq, tk, tv, tpos, tpos, kind="bidir",
                                       cfg=tcfg, block_q=bq, block_kv=bkv,
                                       use_kernel=kernel).numpy()
        assert rel_err(got, want) <= F32_TOL, kernel
        assert rel_err(got, pallas) <= F32_TOL, kernel
    # every key is visible: not the causal result
    causal = attn.blockwise_attention(tq, tk, tv, tpos, tpos, kind="global",
                                      cfg=tcfg).numpy()
    assert rel_err(causal, want) > 1e-2


def test_bidir_mask_matches_reference():
    """Every written key (kpos >= 0) whatever the query's position."""
    jcfg, tcfg = configs()
    qpos = np.array([[0], [5], [9]], np.int32)
    kpos = np.array([[-1, 0, 3, 7, 12]], np.int32)
    want = np.asarray(jax_attn.mask_fn("bidir", jcfg)(qpos, kpos))
    got = attn.mask_fn("bidir", tcfg)(torch.from_numpy(qpos),
                                      torch.from_numpy(kpos)).numpy()
    assert got.shape == want.shape == (3, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """``encode_cross_kv`` then ``cross_attention`` of the first decoder
    layer's cross block, with per-row adapters on q and o (bf16: the
    scores rounded before the scale, as the reference)."""
    p = pair(dtype)
    jcross = jax.tree.map(lambda a: a[0], p.jp["decoder"]["layers"]["cross"])
    tcross = bridge.tree_from_numpy(to_numpy(jcross))
    jl = jax.tree.map(lambda a: a[0], p.jpool["cross"])
    tl = bridge.tree_from_numpy(to_numpy(jl))
    enc = cast(np.random.default_rng(3).normal(
        size=(B, 64, p.cfg.d_model)), dtype)
    x = cast(np.random.default_rng(4).normal(size=(B, 5, p.cfg.d_model)),
             dtype)
    jkv = jax_attn.encode_cross_kv(jcross, jnp.asarray(enc), p.jcfg)
    want = np.asarray(jax_attn.cross_attention(
        jcross, jnp.asarray(x), jkv, p.jcfg, jl, p.jmode()), np.float32)
    tkv = attn.encode_cross_kv(tcross, bridge.tensor_from_numpy(enc), p.cfg)
    # bf16: the two products may round one step apart (2^-8 of a value)
    kv_tol = F32_TOL if dtype == "float32" else 2 ** -7
    for got_kv, want_kv in zip(tkv, jkv):
        assert rel_err(got_kv.float().numpy(),
                       np.asarray(want_kv, np.float32)) <= kv_tol
    got = attn.cross_attention(tcross, bridge.tensor_from_numpy(x), tkv,
                               p.cfg, tl, p.tmode()).float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert rel_err(got, want) <= tol


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [False, True])
def test_forward_matches_reference(dtype, kernel):
    """``Model.forward`` with per-row adapters (the batch's frames through
    the encoder); no aux losses, as in the reference."""
    p = pair(dtype)
    jb, tb = p.batch()
    want, jaux = jax.jit(lambda pr, bt: p.jm.forward(pr, bt, p.jpool,
                                                     p.jmode()))(p.jp, jb)
    tm, tp = p.port()
    with torch.no_grad():
        got, aux = tm.forward(tp, tb, bridge.lora_pool_from_numpy(p.pool),
                              p.tmode(), attn_kernel=kernel)
    assert aux == {} and jaux == {}
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert_logits_close(got.float().numpy(), np.asarray(want, np.float32),
                        tol, "forward")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kernel", [False, True])
def test_prefill_and_decode_match_reference(dtype, kernel):
    """Right-padded rows (one of 2 tokens), mixed adapters, three decode
    steps fed the reference's tokens; the self ring's positions past each
    row's prompt invalidated, the cross K/V equal to the reference's."""
    p = pair(dtype)
    steps, want = reference_steps(dtype)
    tm, tp = p.port(kernel)
    tpool, tmode = bridge.lora_pool_from_numpy(p.pool), p.tmode()
    with torch.no_grad():
        tl, tc = tm.prefill(tp, p.batch()[1], tm.init_cache(B, MAX_CTX),
                            tpool, tmode, lengths=torch.from_numpy(LENGTHS))
        pos = tc["self"]["pos"][0].numpy()
        np.testing.assert_array_equal(
            pos[:, :S], np.where(np.arange(S) < LENGTHS[:, None],
                                 np.arange(S), -1))
        got = [tl.float().numpy()]
        for nxt, step_pos in steps:
            tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                                    torch.from_numpy(step_pos), tpool, tmode)
            got.append(tl.float().numpy())
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    for i, (g, w) in enumerate(zip(got, want)):
        assert_logits_close(g, w, tol, f"step {i}")
    jkv = jax.jit(lambda pr, e, c: jax_encdec.fill_cross_cache(
        pr["decoder"], e, p.jcfg, c))(
        p.jp, jax_encdec.encode(p.jp["encoder"], jnp.asarray(p.frames),
                                p.jcfg, p.jpool, p.jmode()),
        p.jm.init_cache(B, MAX_CTX))
    for name in ("cross_k", "cross_v"):
        assert rel_err(tc[name].float().numpy(),
                       np.asarray(jkv[name], np.float32)) <= (
            F32_TOL if dtype == "float32" else 2 ** -6)


def test_cross_kv_projected_once_equals_twice():
    """The prefill reads the cross K/V that ``fill_cross_cache`` stored
    (the reference projects them again in ``decode_full``): in f32 the
    two give the same hidden states, bit for bit."""
    p = pair("float32")
    tm, tp = p.port()
    tpool, tmode = bridge.lora_pool_from_numpy(p.pool), p.tmode()
    tb = p.batch()[1]
    with torch.no_grad():
        enc = encdec.encode(tp["encoder"], tb["frames"], p.cfg, tpool, tmode)
        cache = encdec.fill_cross_cache(tp["decoder"], enc, p.cfg,
                                        tm.init_cache(B, MAX_CTX))
        x = tm.embed(tp, tb["tokens"])
        once, _ = encdec.decode_full(
            tp["decoder"], x, enc, p.cfg, tpool, tmode,
            self_cache=cache["self"],
            cross_kv=(cache["cross_k"], cache["cross_v"]))
        twice = encdec.decode_full(tp["decoder"], x, enc, p.cfg, tpool, tmode)
    assert torch.equal(once, twice)


def test_batched_adapter_rows_equal_solo_runs():
    """Batch LoRA Inference on the encoder-decoder: each row of a batched
    forward over mixed adapters equals that row run alone with its
    adapter (f32), and the adapters differ (B nonzero)."""
    p = pair("float32")
    tm, tp = p.port()
    tpool = bridge.lora_pool_from_numpy(p.pool)
    ids = np.array([0, 2, 1], np.int32)
    with torch.no_grad():
        out, _ = tm.forward(tp, p.batch()[1], tpool, p.tmode(ids),
                            attn_kernel=False)
        other, _ = tm.forward(tp, p.batch()[1], tpool, p.tmode(ids[::-1]
                                                               .copy()),
                              attn_kernel=False)
        for i in range(B):
            solo, _ = tm.forward(tp, p.batch(slice(i, i + 1))[1], tpool,
                                 p.tmode(ids[i:i + 1]), attn_kernel=False)
            assert rel_err(out[i:i + 1].numpy(), solo.numpy()) <= F32_TOL, i
    assert rel_err(other[0].numpy(), out[0].numpy()) > 1e-4


def test_lora_train_step_matches_reference():
    """One LoRA train step with frames in the batch (``training/train.py``
    passes every key but ``tokens`` through to ``forward``): loss, grad
    norm, lr and both AdamW moments of every leaf (the gradients) within
    1e-5 relative; the updated adapter within 1e-5 absolute, the rule of
    ``tests/test_torch_training.py`` (LEAF_ATOL): AdamW divides each
    element's moment by its own RMS, so a tiny gradient's share of the
    1e-5 error is magnified in its move."""
    p = pair("float32")
    lora = numpy_lora(p.jm)
    tokens = np.random.default_rng(7).integers(
        0, p.cfg.vocab_size, (2, 17)).astype(np.int32)
    fr = frames(p.cfg, 2, seed=8)
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=4, weight_decay=0.01)
    jl = to_jax(lora, jnp.float32)
    js, jmet = jax.jit(jax_train.make_train_step(p.jm, **kw))(
        jax_train.TrainState(p.jp, jl, jax_opt.adamw_init(jl)),
        {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(fr)})
    tm, tp = p.port()
    tl = bridge.lora_pool_from_numpy(lora)
    ts, tmet = train.make_train_step(tm, **kw)(
        train.TrainState(tp, tl, optimizer.adamw_init(tl)),
        {"tokens": torch.from_numpy(tokens), "frames": torch.from_numpy(fr)})
    for name in ("loss", "grad_norm", "lr"):
        assert rel_err(float(tmet[name]), float(jmet[name])) <= F32_TOL
    for got_tree, want_tree, tol, rel in (
            (ts.opt.mu, js.opt.mu, F32_TOL, True),
            (ts.opt.nu, js.opt.nu, F32_TOL, True),
            (ts.lora, js.lora, 1e-5, False)):
        want = jax.tree_util.tree_leaves(to_numpy(want_tree))
        got = [g.detach().numpy() for g in optimizer.tree_leaves(got_tree)]
        assert len(got) == len(want) == 24
        for g, w in zip(got, want):
            err = rel_err(g, w) if rel else float(np.abs(g - w).max())
            assert err <= tol
    assert float(np.abs(got[0] - lora["cross"]["o"]["A"]).max()) > 1e-4


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def test_engine_refuses_where_reference_fails_on_frames():
    """The port's engine refuses reduced whisper at init, naming the
    missing frames; the reference's initialises, then its first prefill
    fails with ``KeyError: 'frames'`` on the same trace."""
    jcfg, tcfg = configs()
    trace = jax_workload.generate_trace(jax_workload.WorkloadConfig(
        n_adapters=jcfg.lora.n_adapters, request_rate=20.0, duration=0.2,
        input_range=(8, 32), output_range=(2, 4),
        vocab_size=jcfg.vocab_size))
    assert trace
    eng = jax_engine.EdgeLoRAEngine(jcfg, jax_engine.EngineConfig(
        n_slots=2, max_ctx=64, prompt_buckets=(64,)))
    with pytest.raises(KeyError, match="frames"):
        eng.serve(trace)
    with pytest.raises(NotImplementedError,
                       match=r"encoder-decoder model also needs 'frames'"):
        EdgeLoRAEngine(tcfg, EngineConfig(), device="cpu")


@pytest.mark.parametrize("module,args", [
    ("serve", ["--duration", "1"]),
    ("train", ["--steps", "1"]),
])
def test_clis_refuse_whisper(module, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.launch.{module}", "--device",
         "cpu", "--arch", WHISPER, *args], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240)
    assert out.returncode != 0
    assert "NotImplementedError" in out.stderr
    assert "also needs 'frames'" in out.stderr, out.stderr[-2000:]


STEP_ARGS = {"prefill_suffix": (7, True), "prefill_suffix_dense": (7, False),
             "decode_step_paged": (8, True)}


@pytest.mark.parametrize("step", list(STEP_ARGS))
def test_paged_suffix_and_chunk_steps_refuse_encoder(step):
    """Nothing in the reference reaches these steps with an
    encoder-decoder config; the port refuses them before any work."""
    n_args, meta = STEP_ARGS[step]
    tm = build_model(configs()[1], "cpu")
    kw = {"meta": None} if meta else {}
    with pytest.raises(NotImplementedError, match="no encoder-decoder"):
        getattr(tm, step)(*[None] * n_args, **kw)


def test_audio_family_and_encoder_go_together():
    """An encoder outside the audio family, or the audio family without
    an encoder, is refused; without RoPE the decoder-only stack runs."""
    _, tcfg = configs()
    for cfg in (dataclasses.replace(tcfg, encoder=None),
                dataclasses.replace(reduced_config(get_config("llama3-8b")),
                                    encoder=tcfg.encoder)):
        with pytest.raises(NotImplementedError,
                           match="audio family without one"):
            check_supported(cfg)
    llama = reduced_config(get_config("llama3-8b"))
    check_supported(dataclasses.replace(llama, attn=dataclasses.replace(
        llama.attn, rope=False)))
