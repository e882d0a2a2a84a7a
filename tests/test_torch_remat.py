"""The train step's ``remat`` (``make_train_step(remat=True)``: each layer
group under ``torch.utils.checkpoint``) against the step without it and
against the reference's ``make_train_step(remat=True)``.

On reduced f32 configs, dense (llama3-8b), SSM (mamba2), MoE (dbrx: its
aux losses flow through the checkpoint) and hybrid (zamba2: the shared
block inside the checkpointed group): remat on and off give the same
loss, grad norm, lr, AdamW moments and updated adapter, each equal or
within 1e-7 (the recomputed forward runs the same ops in the same
order, so equal is expected); the remat step matches the reference's
remat step within ``tests/test_torch_training.py``'s tolerances (loss,
grad norm and lr within 1e-5 relative, the moments within 1e-5 of their
max, the updated adapter within 1e-5 absolute).
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import data, optimizer, train  # noqa: E402

from test_torch_model import numpy_lora, numpy_params, to_jax  # noqa: E402
from test_torch_policies import one_torch_thread  # noqa: E402,F401 (fixture)
from test_torch_training import (F32_TOL, LEAF_ATOL,  # noqa: E402
                                 _leaves_close, configs)

# remat on vs off: the same ops in the same order (equal expected)
REMAT_TOL = 1e-7
KW = dict(peak_lr=1e-3, warmup=1, total_steps=4, weight_decay=0.01)


def _setup(arch):
    """Both models on bridged params, one nonzero adapter, and a batch of
    the synthetic task pipeline (as ``test_torch_training.py``'s steps)."""
    jcfg, tcfg = configs(arch)
    jm, tm = jax_build_model(jcfg), build_model(tcfg, "cpu")
    params, lora = numpy_params(jm), numpy_lora(jm)
    dc = data.DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                         batch_size=3, seed=5)
    tokens = next(data.lm_batches(dc, 0))["tokens"]
    return jm, tm, params, lora, tokens


def _port_steps(tm, params, lora, tokens, remat, n=2):
    step = train.make_train_step(tm, remat=remat, **KW)
    tl = bridge.lora_pool_from_numpy(lora)
    state = train.TrainState(bridge.params_from_numpy(tm, params), tl,
                             optimizer.adamw_init(tl))
    out = []
    for _ in range(n):
        state, met = step(state, {"tokens": torch.from_numpy(tokens)})
        out.append((state, met))
    return out


def _close(a, b, tol):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max()) <= tol * max(float(b.abs().max()),
                                                   1e-30)


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m", "dbrx-132b",
                                  "zamba2-2.7b"])
def test_remat_equals_no_remat(arch):
    _, tm, params, lora, tokens = _setup(arch)
    plain = _port_steps(tm, params, lora, tokens, remat=False)
    remat = _port_steps(tm, params, lora, tokens, remat=True)
    for i, ((sp, mp), (sr, mr)) in enumerate(zip(plain, remat)):
        assert set(mp) == set(mr)
        for k in mp:
            assert _close(mr[k], mp[k], REMAT_TOL), (arch, i, k)
        for tree_p, tree_r in ((sp.lora, sr.lora), (sp.opt.mu, sr.opt.mu),
                               (sp.opt.nu, sr.opt.nu)):
            lp, lr = optimizer.tree_leaves(tree_p), optimizer.tree_leaves(
                tree_r)
            assert len(lp) == len(lr) > 0
            for a, b in zip(lr, lp):
                assert _close(a, b, REMAT_TOL), (arch, i)
        assert int(sr.opt.step) == i + 1


def test_remat_recomputes_in_backward():
    """With remat the backward pass runs each group's forward again: the
    step dispatches more matmul flops than without."""
    from torch.utils.flop_counter import FlopCounterMode

    _, tm, params, lora, tokens = _setup("llama3-8b")
    flops = {}
    for remat in (False, True):
        with FlopCounterMode(display=False) as fc:
            _port_steps(tm, params, lora, tokens, remat=remat, n=1)
        flops[remat] = fc.get_total_flops()
    assert flops[True] > flops[False]


@pytest.mark.parametrize("arch", ["llama3-8b", "mamba2-130m", "dbrx-132b"])
def test_remat_step_matches_reference(arch):
    jm, tm, params, lora, tokens = _setup(arch)
    jl = to_jax(lora, jnp.float32)
    jstep = jax.jit(jax_train.make_train_step(jm, remat=True, **KW))
    js, jmet = jstep(jax_train.TrainState(to_jax(params, jnp.float32), jl,
                                          jax_opt.adamw_init(jl)),
                     {"tokens": jnp.asarray(tokens)})
    (ts, tmet), = _port_steps(tm, params, lora, tokens, remat=True, n=1)
    assert set(tmet) == set(jmet)
    for k in tmet:
        want = float(jmet[k])
        assert abs(float(tmet[k]) - want) <= F32_TOL * max(abs(want), 1e-6), (
            arch, k, float(tmet[k]), want)
    _leaves_close(ts.opt.mu, js.opt.mu, F32_TOL, f"{arch} mu")
    _leaves_close(ts.opt.nu, js.opt.nu, F32_TOL, f"{arch} nu")
    _leaves_close(ts.lora, js.lora, LEAF_ATOL, f"{arch} lora", absolute=True)
