"""PyTorch port's model vs the JAX package's on bridged weights.

Reduced Llama-3.1-8B, the same numpy-made params and LoRA pool (nonzero
B, so every LoRA check is real) in both: prefill over right-padded rows
with different lengths and mixed adapters, every cache leaf, then four
decode steps with per-row positions — for both batched-LoRA backends
against the reference's same backend (its sgmv in Pallas interpret mode,
the port's through its kernels' plain versions on the CPU).

The params are drawn at fan-in scale rather than with the reference's
init (whose stddev comes from the stacked group axis, so activations grow
large and attention scores reach ~1e4): at that scale a 1-ulp f32
difference in a score moves the softmax, and no tight tolerance could
tell a port fault from float reassociation.
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

N_POOL = 4
TOKENS_B, BUCKET, MAX_CTX = 3, 16, 32
LENGTHS = np.array([16, 9, 5], np.int32)     # right-padded rows
SLOTS = np.array([2, 0, 3], np.int32)        # mixed adapters


def configs(dtype):
    jcfg = dataclasses.replace(jax_reduced_config(jax_get_config("llama3-8b")),
                               dtype=dtype)
    tcfg = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                               dtype=dtype)
    return jcfg, tcfg


def numpy_params(jmodel, seed=0):
    """The reference's param tree at fan-in scale, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0))

    def draw(path, sd):
        name = jax.tree_util.keystr(path)
        if "scale" in name:      # norm scales enter as (1 + scale)
            return (0.1 * rng.normal(size=sd.shape)).astype(np.float32)
        if name == "['embed']":
            return rng.normal(size=sd.shape).astype(np.float32)
        fan_in = sd.shape[-2]
        return (rng.normal(size=sd.shape) / np.sqrt(fan_in)).astype(
            np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def numpy_lora(jmodel, seed=1, n_slots=None):
    """A LoRA tree (pool when n_slots) with A ~ N(0, 1/r) and nonzero B."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(
        lambda k: jmodel.init_lora(k, n_slots=n_slots), jax.random.PRNGKey(0))
    r = jmodel.cfg.lora.rank

    def draw(path, sd):
        if jax.tree_util.keystr(path).endswith("['A']"):
            return (rng.normal(size=sd.shape) / np.sqrt(r)).astype(np.float32)
        return (0.005 * rng.normal(size=sd.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def to_jax(tree, dtype):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), tree)


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def rel_err(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


class Pair:
    """The same model in both packages on bridged weights and pool."""

    def __init__(self, dtype):
        jcfg, tcfg = configs(dtype)
        self.cfg = tcfg
        self.jm = jax_build_model(jcfg)
        self.tm = build_model(tcfg, "cpu")
        jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
        self.jp = to_jax(numpy_params(self.jm), jdt)
        self.tp = bridge.params_from_numpy(self.tm, to_numpy(self.jp))
        pool = numpy_lora(self.jm, n_slots=N_POOL)
        self.jpool = to_jax(pool, jnp.float32)
        self.tpool = bridge.lora_pool_from_numpy(pool)
        rng = np.random.default_rng(2)
        self.tokens = rng.integers(0, tcfg.vocab_size,
                                   (TOKENS_B, BUCKET)).astype(np.int32)
        self._jax_steps = {}

    def mode(self, backend, slots=SLOTS):
        return LoRAMode("batched", torch.from_numpy(slots),
                        self.cfg.lora.scale, backend)

    def jax_steps(self, backend):
        """The reference's prefill and decode step, jitted (as its engine
        runs them) with the LoRA mode built inside."""
        if backend in self._jax_steps:
            return self._jax_steps[backend]
        jm, scale = self.jm, self.cfg.lora.scale

        def mode(sids):
            return JaxLoRAMode("batched", sids, scale, backend, True)

        @jax.jit
        def prefill(params, pool, tokens, cache, sids, lengths):
            return jm.prefill(params, {"tokens": tokens}, cache, pool,
                              mode(sids), lengths=lengths)

        @jax.jit
        def decode(params, pool, tokens, cache, pos, sids):
            return jm.decode_step(params, tokens, cache, pos, pool,
                                  mode(sids))

        self._jax_steps[backend] = prefill, decode
        return prefill, decode

    def prefill(self, backend):
        tmode = self.mode(backend)
        jl, jc = self.jax_steps(backend)[0](
            self.jp, self.jpool, jnp.asarray(self.tokens),
            self.jm.init_cache(TOKENS_B, MAX_CTX), jnp.asarray(SLOTS),
            jnp.asarray(LENGTHS))
        tl, tc = self.tm.prefill(
            self.tp, {"tokens": torch.from_numpy(self.tokens)},
            self.tm.init_cache(TOKENS_B, MAX_CTX), self.tpool, tmode,
            lengths=torch.from_numpy(LENGTHS))
        return (jl, jc), (tl, tc)

    def decode(self, backend, jc, tc, tokens, pos):
        tmode = self.mode(backend)
        jl, jc = self.jax_steps(backend)[1](
            self.jp, self.jpool, jnp.asarray(tokens), jc, jnp.asarray(pos),
            jnp.asarray(SLOTS))
        tl, tc = self.tm.decode_step(self.tp, torch.from_numpy(tokens), tc,
                                     torch.from_numpy(pos), self.tpool,
                                     tmode)
        return (jl, jc), (tl, tc)


@pytest.fixture(scope="module")
def f32_pair():
    return Pair("float32")


def assert_caches_close(jc, tc, tol):
    assert set(jc) == set(tc)
    for slot, leaves in jc.items():
        assert set(leaves) == set(tc[slot])
        for name, want in leaves.items():
            got = tc[slot][name]
            assert tuple(got.shape) == want.shape, (slot, name)
            if name == "pos":
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            else:
                assert rel_err(got.float().numpy(),
                               np.asarray(want, np.float32)) <= tol, name


# f32 tolerance: max-abs error <= 1e-4 x max|ref| — both sides run the
# same f32 arithmetic, reassociated (the einsum/matmul/softmax orders
# differ), over two layers.
F32_TOL = 1e-4


@pytest.mark.parametrize("backend", ["einsum", "sgmv"])
def test_prefill_and_decode_match_reference_f32(f32_pair, backend):
    p = f32_pair
    (jl, jc), (tl, tc) = p.prefill(backend)
    assert rel_err(tl.numpy(), jl) <= F32_TOL
    assert_caches_close(jc, tc, F32_TOL)
    # the LoRA delta is real: dropping it moves the logits well past tol
    no_lora, _ = p.tm.prefill(p.tp, {"tokens": torch.from_numpy(p.tokens)},
                              p.tm.init_cache(TOKENS_B, MAX_CTX),
                              lengths=torch.from_numpy(LENGTHS))
    assert rel_err(no_lora.numpy(), jl) > 100 * F32_TOL
    tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = LENGTHS.copy()
    # a decode step from the reference's own cache, bridged
    tl, _ = p.tm.decode_step(p.tp, torch.from_numpy(tokens),
                             bridge.cache_from_numpy(to_numpy(jc)),
                             torch.from_numpy(pos), p.tpool, p.mode(backend))
    bridged = tl.numpy()
    for step in range(4):
        (jl, jc), (tl, tc) = p.decode(backend, jc, tc, tokens, pos)
        assert rel_err(tl.numpy(), jl) <= F32_TOL
        if step == 0:
            assert rel_err(bridged, jl) <= F32_TOL
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    assert_caches_close(jc, tc, F32_TOL)


def test_param_paths_mirror_reference(f32_pair):
    """``Model.weights`` carries the JAX tree's paths and shapes."""
    p = f32_pair
    want = {jax.tree_util.keystr(k).replace("']['", ".").strip("[']"):
            tuple(v.shape)
            for k, v in jax.tree_util.tree_leaves_with_path(p.jp)}
    got = {k: tuple(v.shape) for k, v in p.tm.weights.state_dict().items()}
    assert got == want
    with pytest.raises(ValueError, match="param tree mismatch"):
        bad = to_numpy(p.jp)
        bad["layers"]["slot0"]["attn"]["wq"] = bad["layers"]["slot0"][
            "attn"]["wq"][:, :-1]
        bridge.params_from_numpy(build_model(p.cfg, "cpu"), bad)


# bf16: the two frameworks round to bf16 at different places (matmul
# outputs, the LoRA delta, RoPE), each a 2^-8 relative step; over two
# layers and the head that stays within 3e-2 of max|logit|. Greedy
# tokens must agree wherever the reference's top-2 margin exceeds that.
BF16_TOL = 3e-2


def test_prefill_and_decode_match_reference_bf16():
    p = Pair("bfloat16")
    (jl, jc), (tl, tc) = p.prefill("einsum")
    steps = [(jl, tl)]
    tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = LENGTHS.copy()
    for _ in range(2):
        (jl, jc), (tl, tc) = p.decode("einsum", jc, tc, tokens, pos)
        steps.append((jl, tl))
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    for jl, tl in steps:
        want = np.asarray(jl, np.float32)
        got = tl.float().numpy()
        assert rel_err(got, want) <= BF16_TOL
        top2 = np.sort(want, -1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > BF16_TOL * np.abs(want).max()
        np.testing.assert_array_equal(got.argmax(-1)[clear],
                                      want.argmax(-1)[clear])
    assert_caches_close(jc, tc, BF16_TOL)
