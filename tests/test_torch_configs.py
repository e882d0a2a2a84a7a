"""The port's qwen2-0.5b, llama3.2-3b and openelm-1.1b configs against the
JAX package's, on bridged weights.

Each reduced config runs the same numpy-made params and LoRA pool
(nonzero B) in both packages: a prefill over right-padded rows with mixed
adapters, then three decode steps with per-row positions. qwen2-0.5b
carries QKV bias, drawn nonzero here (the reference initialises it to
zero, so its own init would never exercise it), and LoRA on ``o`` and
``gate``; all three tie their embeddings, so the logits come through the
tied ``unembed``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.core.lora import LoRAMode as JaxLoRAMode  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

from test_torch_model import (BF16_TOL, numpy_lora, numpy_params,  # noqa: E402
                              rel_err, to_jax, to_numpy)
from test_torch_policies import one_torch_thread  # noqa: E402,F401 (fixture)

ARCHS = ("qwen2-0.5b", "llama3.2-3b", "openelm-1.1b")
N_POOL, B, BUCKET, MAX_CTX = 4, 3, 16, 32
LENGTHS = np.array([16, 9, 5], np.int32)     # right-padded rows
SLOTS = np.array([2, 0, 3], np.int32)        # mixed adapters
BIAS_STD = 0.1

# f32: both packages run the same f32 arithmetic, reassociated, over two
# layers; held to 1e-5 of max|logit|.
F32_TOL = 1e-5


def _params(jm):
    """Fan-in-scale params (``numpy_params``) with the QKV biases redrawn
    at BIAS_STD, so each shifts q, k and v by about a tenth of their
    size."""
    tree = numpy_params(jm)
    rng = np.random.default_rng(3)
    for slot in tree["layers"].values():
        for name in ("bq", "bk", "bv"):
            if name in slot["attn"]:
                b = slot["attn"][name]
                slot["attn"][name] = (BIAS_STD * rng.normal(size=b.shape)
                                      ).astype(np.float32)
    return tree


def _run(arch, dtype, *, drop_bias=False):
    """Prefill + three decode steps in both packages; returns the
    (reference, port) logits of each step."""
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                               dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(get_config(arch)), dtype=dtype)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    params = _params(jm)
    if drop_bias:
        for slot in params["layers"].values():
            for name in ("bq", "bk", "bv"):
                slot["attn"][name] = np.zeros_like(slot["attn"][name])
    jp = to_jax(params, jdt)
    tp = bridge.params_from_numpy(tm, to_numpy(jp))
    pool = numpy_lora(jm, n_slots=N_POOL)
    jpool, tpool = to_jax(pool, jnp.float32), bridge.lora_pool_from_numpy(pool)
    scale = tcfg.lora.scale
    jmode = JaxLoRAMode("batched", jnp.asarray(SLOTS), scale, "einsum", True)
    tmode = LoRAMode("batched", torch.from_numpy(SLOTS), scale, "einsum")
    tokens = np.random.default_rng(2).integers(
        0, tcfg.vocab_size, (B, BUCKET)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t, c, n: jm.prefill(
        p, {"tokens": t}, c, jpool, jmode, lengths=n))(
        jp, jnp.asarray(tokens), jm.init_cache(B, MAX_CTX),
        jnp.asarray(LENGTHS))
    tl, tc = tm.prefill(tp, {"tokens": torch.from_numpy(tokens)},
                        tm.init_cache(B, MAX_CTX), tpool, tmode,
                        lengths=torch.from_numpy(LENGTHS))
    steps = [(np.asarray(jl, np.float32), tl.float().numpy())]
    decode = jax.jit(lambda p, t, c, q: jm.decode_step(p, t, c, q, jpool,
                                                       jmode))
    nxt, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), LENGTHS
    for _ in range(3):
        jl, jc = decode(jp, jnp.asarray(nxt), jc, jnp.asarray(pos))
        tl, tc = tm.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(pos), tpool, tmode)
        steps.append((np.asarray(jl, np.float32), tl.float().numpy()))
        nxt, pos = np.asarray(jnp.argmax(jl, -1)).astype(np.int32), pos + 1
    return tcfg, tp, steps


@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_resolves_arch(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.tie_embeddings and tcfg.attn.qkv_bias == (arch == "qwen2-0.5b")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_f32(arch):
    tcfg, tp, steps = _run(arch, "float32")
    assert "lm_head" not in tp                   # tied: logits via embed
    for want, got in steps:
        assert rel_err(got, want) <= F32_TOL
    if tcfg.attn.qkv_bias:
        assert all(tp["layers"]["slot0"]["attn"][n].abs().max() > 0
                   for n in ("bq", "bk", "bv"))
        # the bias is real: zeroing it moves the logits well past tol
        _, _, unbiased = _run(arch, "float32", drop_bias=True)
        assert rel_err(unbiased[0][1], steps[0][0]) > 100 * F32_TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference_bf16(arch):
    """The tolerance of ``tests/test_torch_model.py`` (BF16_TOL of
    max|logit|); greedy tokens agree wherever the reference's top-2
    margin exceeds it."""
    _, _, steps = _run(arch, "bfloat16")
    for want, got in steps:
        assert rel_err(got, want) <= BF16_TOL
        top2 = np.sort(want, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > BF16_TOL * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])


def test_qkv_bias_initialises_to_zero():
    cfg = reduced_config(get_config("qwen2-0.5b"))
    params = build_model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    attn = params["layers"]["slot0"]["attn"]
    ng = cfg.n_layers
    assert tuple(attn["bq"].shape) == (ng, cfg.q_size)
    assert tuple(attn["bk"].shape) == tuple(attn["bv"].shape) == (
        ng, cfg.kv_size)
    assert all(not attn[n].any() for n in ("bq", "bk", "bv"))
