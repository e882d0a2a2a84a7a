"""The port's training substrate against the JAX package's.

The data pipeline (numpy, copied) gives equal arrays; AdamW (clip and
weight decay on), the warmup-cosine schedule and cross-entropy agree
within 1e-6; ``Model.forward`` in f32 within 1e-5 of max|logit| on
reduced Llama-3.1-8B and qwen2-0.5b with a single nonzero adapter; three
LoRA train steps and one full fine-tune step from bridged params give the
reference's loss, grad norm and AdamW moments within 1e-5 (relative) and
updated leaves within 1e-5 (absolute, see LEAF_ATOL), the base frozen; ``train_loop`` lowers the
loss as the reference's own test asks;
checkpoints cross-load both ways, bf16 included; the CLI trains on the
CPU and its adapter loads in the reference.
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
from repro.training import checkpoint as jax_ckpt  # noqa: E402
from repro.training import data as jax_data  # noqa: E402
from repro.training import optimizer as jax_opt  # noqa: E402
from repro.training import train as jax_train  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (EncoderConfig, get_config,  # noqa: E402
                                 reduced_config)
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import checkpoint, data, optimizer, train  # noqa: E402

from test_torch_model import (numpy_lora, numpy_params, rel_err,  # noqa: E402
                              to_jax, to_numpy)
from test_torch_policies import one_torch_thread  # noqa: E402,F401 (fixture)

# f32 arithmetic of both packages, reassociated: scalars and elementwise
# updates within 1e-6, a two-layer forward and its gradients within 1e-5
# of max|value|
SCALAR_TOL = 1e-6
F32_TOL = 1e-5
# the leaves a train step updates: within 1e-5 absolute, 1 % of the
# largest move of one AdamW step at lr 1e-3. Not relative to max|leaf|:
# AdamW divides each element's moment by its own RMS, so an element whose
# gradient is tiny carries its share of the gradient's 1e-5-of-max error
# into its update magnified (a gradient of 7.1e-6 against a largest of
# 3.2 differs by 1e-1 of itself): its move, at most lr per step, may
# differ by ~1e-3 of lr. The moments (linear and quadratic in the
# gradient) are held to F32_TOL of their max. A full fine-tune step
# moves elements whose gradient is near AdamW's eps (1e-8), whose moves
# are ill-conditioned outright: ``_first_step_close`` bounds each
# element by what the gradient's tolerance allows its move.
LEAF_ATOL = 1e-5
ADAM_B1, ADAM_EPS = 0.9, 1e-8


def configs(arch, dtype="float32"):
    return (dataclasses.replace(jax_reduced_config(jax_get_config(arch)),
                                dtype=dtype),
            dataclasses.replace(reduced_config(get_config(arch)),
                                dtype=dtype))


def _leaves_close(port_tree, ref_tree, tol, what, absolute=False):
    """Every leaf within ``tol`` of max|leaf| (or absolutely)."""
    want = jax.tree_util.tree_leaves_with_path(to_numpy(ref_tree))
    got = optimizer.tree_leaves(port_tree)
    assert len(got) == len(want) > 0
    for g, (path, w) in zip(got, want):
        g = g.detach().float().numpy()
        err = (float(np.abs(g - w).max()) if absolute else rel_err(g, w))
        assert err <= tol, (what, jax.tree_util.keystr(path), err)


def _first_step_close(port_tree, ref_tree, ref_mu, lr, what):
    """The leaves after a first AdamW step, each element within
    LEAF_ATOL plus the first-order change of its move ``lr · g / (|g| +
    eps)`` under a gradient error of F32_TOL · max|g| (at most the move's
    whole range, 2 · lr); g is the reference's clipped gradient,
    ``mu / (1 - b1)``."""
    want = jax.tree_util.tree_leaves_with_path(to_numpy(ref_tree))
    mus = jax.tree_util.tree_leaves(to_numpy(ref_mu))
    got = optimizer.tree_leaves(port_tree)
    assert len(got) == len(want) == len(mus) > 0
    for g, (path, w), mu in zip(got, want, mus):
        grad = np.abs(mu.astype(np.float64)) / (1 - ADAM_B1)
        delta = F32_TOL * grad.max()
        near = np.maximum(grad - delta, 0.0) + ADAM_EPS
        bound = LEAF_ATOL + lr * np.minimum(2.0, delta * ADAM_EPS / near**2)
        err = np.abs(g.detach().double().numpy() - w)
        assert (err <= bound).all(), (what, jax.tree_util.keystr(path),
                                      float((err - bound).max()))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


def test_router_dataset_and_lm_batches_equal_reference():
    for mod_cfg in ({"vocab_size": 96, "seq_len": 12, "batch_size": 3,
                     "n_tasks": 4, "seed": 2},
                    {"vocab_size": 64, "seq_len": 20, "batch_size": 2}):
        jdc, tdc = jax_data.DataConfig(**mod_cfg), data.DataConfig(**mod_cfg)
        for a, b in zip(jax_data.router_dataset(jdc, 8, 30),
                        data.router_dataset(tdc, 8, 30)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        for task in (0, 3):
            ja, ta = jax_data.lm_batches(jdc, task), data.lm_batches(tdc,
                                                                     task)
            for _ in range(3):
                a, b = next(ja)["tokens"], next(ta)["tokens"]
                assert a.dtype == b.dtype and np.array_equal(a, b)


# ---------------------------------------------------------------------------
# optimizer, schedule, loss
# ---------------------------------------------------------------------------


def _numpy_nested(rng):
    return {"b": {"y": rng.normal(size=(5, 3)), "x": rng.normal(size=(7,))},
            "a": rng.normal(size=(4, 2, 3))}


def test_adamw_update_matches_reference():
    """Three steps with the global-norm clip active (norm > 1) and
    decoupled weight decay; the norm, new params and both moments."""
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: a.astype(np.float32), _numpy_nested(rng))
    jp = to_jax(params, jnp.float32)
    tp = bridge.tree_from_numpy(params)
    js, ts = jax_opt.adamw_init(jp), optimizer.adamw_init(tp)
    for i in range(3):
        grads = jax.tree.map(lambda a: (3.0 * a).astype(np.float32),
                             _numpy_nested(np.random.default_rng(10 + i)))
        lr = 1e-2 * (i + 1)
        jp, js, jn = jax_opt.adamw_update(
            to_jax(grads, jnp.float32), js, jp, lr=lr, weight_decay=0.1,
            max_grad_norm=1.0)
        tp, ts, tn = optimizer.adamw_update(
            bridge.tree_from_numpy(grads), ts, tp, lr=lr, weight_decay=0.1,
            max_grad_norm=1.0)
        assert float(jn) > 1.0
        assert abs(float(tn) - float(jn)) <= SCALAR_TOL * float(jn)
        assert int(ts.step) == int(js.step) == i + 1
        for got, want in ((tp, jp), (ts.mu, js.mu), (ts.nu, js.nu)):
            _leaves_close(got, want, SCALAR_TOL, f"step {i}")


def test_warmup_cosine_matches_reference():
    kw = dict(peak_lr=3e-3, warmup=10, total=100, floor=0.1)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 140):
        want = float(jax_opt.warmup_cosine(jnp.int32(step), **kw))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = float(optimizer.warmup_cosine(s, **kw))
            assert abs(got - want) <= SCALAR_TOL * max(abs(want), 1e-3)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(1)
    logits = (4 * rng.normal(size=(3, 7, 50))).astype(np.float32)
    targets = rng.integers(0, 50, size=(3, 7)).astype(np.int32)
    mask = (rng.uniform(size=(3, 7)) < 0.6).astype(np.float32)
    for m in (None, mask):
        want = float(jax_train.cross_entropy(
            jnp.asarray(logits), jnp.asarray(targets),
            None if m is None else jnp.asarray(m)))
        got = float(train.cross_entropy(
            torch.from_numpy(logits), torch.from_numpy(targets),
            None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= SCALAR_TOL * abs(want)


# ---------------------------------------------------------------------------
# Model.forward and the train step
# ---------------------------------------------------------------------------


class Pair:
    """One reduced f32 model in both packages on bridged params and a
    single nonzero adapter."""

    def __init__(self, arch):
        jcfg, tcfg = configs(arch)
        self.jm = jax_build_model(jcfg)
        self.tm = build_model(tcfg, "cpu")
        params = numpy_params(self.jm)
        lora = numpy_lora(self.jm)
        self.jp, self.jl = to_jax(params, jnp.float32), to_jax(lora,
                                                                jnp.float32)
        self.tp = bridge.params_from_numpy(self.tm, params)
        self.tl = bridge.lora_pool_from_numpy(lora)
        self.scale = tcfg.lora.scale
        dc = data.DataConfig(vocab_size=tcfg.vocab_size, seq_len=16,
                             batch_size=3, seed=5)
        self.batches = [next(data.lm_batches(dc, task)) for task in (0, 1, 2)]


@pytest.fixture(scope="module", params=["llama3-8b", "qwen2-0.5b"])
def pair(request):
    return Pair(request.param)


def test_forward_matches_reference(pair):
    tokens = pair.batches[0]["tokens"]
    for lora in (False, True):
        want, jaux = pair.jm.forward(
            pair.jp, {"tokens": jnp.asarray(tokens)},
            pair.jl if lora else None,
            JaxLoRAMode("single", None, pair.scale) if lora
            else JaxLoRAMode())
        for kernel in (False, True):
            with torch.no_grad():
                got, aux = pair.tm.forward(
                    pair.tp, {"tokens": torch.from_numpy(tokens)},
                    pair.tl if lora else None,
                    LoRAMode("single", None, pair.scale) if lora
                    else LoRAMode(), attn_kernel=kernel)
            assert got.shape == want.shape
            assert rel_err(got.numpy(), want) <= F32_TOL, (lora, kernel)
            assert set(aux) == set(jaux)


def test_encoder_config_raises():
    """An encoder on a decoder-only family is refused where the model is
    built: ``check_supported`` holds an encoder to the audio family
    (whisper's encoder-decoder stack)."""
    cfg = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                              encoder=EncoderConfig(n_layers=2))
    with pytest.raises(NotImplementedError, match="encoder"):
        build_model(cfg, "cpu")


def test_lora_train_steps_match_reference(pair):
    """Three LoRA steps, each started in both packages from the same
    numbers (the reference's adapter and AdamW state, bridged), then one
    full fine-tune step: loss, grad norm, lr, the moments and every
    updated leaf; the base params stay frozen."""
    kw = dict(peak_lr=1e-3, warmup=1, total_steps=4, weight_decay=0.01)
    jstep = jax.jit(jax_train.make_train_step(pair.jm, **kw))
    tstep = train.make_train_step(pair.tm, **kw)
    js = jax_train.TrainState(pair.jp, pair.jl, jax_opt.adamw_init(pair.jl))
    base = [t.clone() for t in optimizer.tree_leaves(pair.tp)]
    for i, batch in enumerate(pair.batches):
        ts = train.TrainState(
            pair.tp, bridge.lora_pool_from_numpy(to_numpy(js.lora)),
            bridge.adamw_state_from_numpy(to_numpy(tuple(js.opt))))
        assert int(ts.opt.step) == i
        js, jm = jstep(js, {"tokens": jnp.asarray(batch["tokens"])})
        ts, tm = tstep(ts, {"tokens": torch.from_numpy(batch["tokens"])})
        for k in ("loss", "grad_norm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= F32_TOL * abs(
                float(jm[k])), (i, k, float(tm[k]), float(jm[k]))
        _leaves_close(ts.opt.mu, js.opt.mu, F32_TOL, f"mu step {i}")
        _leaves_close(ts.opt.nu, js.opt.nu, F32_TOL, f"nu step {i}")
        _leaves_close(ts.lora, js.lora, LEAF_ATOL, f"lora step {i}",
                      absolute=True)
    assert ts.params is pair.tp
    for before, after in zip(base, optimizer.tree_leaves(ts.params)):
        assert not after.requires_grad and torch.equal(before, after)
    assert not any(t.requires_grad for t in optimizer.tree_leaves(ts.lora))

    jfull = jax.jit(jax_train.make_train_step(pair.jm, train_base=True, **kw))
    tfull = train.make_train_step(pair.tm, train_base=True, **kw)
    batch = pair.batches[0]["tokens"]
    js, jm = jfull(jax_train.TrainState(pair.jp, pair.jl,
                                        jax_opt.adamw_init(pair.jp)),
                   {"tokens": jnp.asarray(batch)})
    ts, tm = tfull(train.TrainState(pair.tp, pair.tl,
                                    optimizer.adamw_init(pair.tp)),
                   {"tokens": torch.from_numpy(batch)})
    for k in ("loss", "grad_norm"):
        assert abs(float(tm[k]) - float(jm[k])) <= F32_TOL * abs(
            float(jm[k])), (k, float(tm[k]), float(jm[k]))
    _leaves_close(ts.opt.mu, js.opt.mu, F32_TOL, "full fine-tune mu")
    _first_step_close(ts.params, js.params, js.opt.mu, kw["peak_lr"],
                      "full fine-tune")
    assert ts.lora is pair.tl


def test_plain_kernel_routes_stay_differentiable(pair):
    """On the CPU the kernel wrappers run their plain versions, which stay
    differentiable: the LoRA gradients through ``attn_kernel=True`` equal
    those through the model's blockwise attention (on CUDA the wrappers
    refuse inputs that require grad: ``tests/test_torch_cuda.py``)."""
    tokens = torch.from_numpy(pair.batches[1]["tokens"])
    mode = LoRAMode("single", None, pair.scale)
    grads = {}
    for kernel in (False, True):
        lora = train._trainable(pair.tl)
        logits, _ = pair.tm.forward(pair.tp, {"tokens": tokens[:, :-1]},
                                    lora, mode, attn_kernel=kernel)
        loss = train.cross_entropy(logits, tokens[:, 1:])
        grads[kernel] = torch.autograd.grad(
            loss, optimizer.tree_leaves(lora))
    for a, b in zip(grads[True], grads[False]):
        assert b.abs().max() > 0
        assert rel_err(a.numpy(), b.numpy()) <= F32_TOL


def test_train_loop_loss_decreases():
    """tests/test_training.py's loop on the port."""
    cfg = reduced_config(get_config("qwen2-0.5b"))
    model = build_model(cfg, "cpu")
    dc = data.DataConfig(vocab_size=cfg.vocab_size, seq_len=32, batch_size=4)
    state, hist = train.train_loop(model, data.lm_batches(dc, task=0), 40,
                                   peak_lr=5e-3, log_every=39,
                                   log_fn=lambda s: None)
    assert hist[-1][1] < hist[0][1]
    assert [i for i, _ in hist] == [0, 39]
    assert all(not t.requires_grad
               for t in optimizer.tree_leaves(state.params))


# ---------------------------------------------------------------------------
# checkpoints and the CLI
# ---------------------------------------------------------------------------


def test_checkpoints_cross_load(tmp_path):
    """bf16 params and an f32 adapter, saved by each package and loaded
    by the other, bit for bit."""
    jcfg, tcfg = configs("qwen2-0.5b", "bfloat16")
    jm = jax_build_model(jcfg)
    tree = {"params": to_jax(numpy_params(jm), jnp.bfloat16),
            "lora": to_jax(numpy_lora(jm), jnp.float32)}
    port = bridge.tree_from_numpy(to_numpy(tree))
    assert port["params"]["embed"].dtype == torch.bfloat16

    jax_ckpt.save_checkpoint(str(tmp_path / "ref.npz"), tree)
    got = checkpoint.load_checkpoint(str(tmp_path / "ref.npz"), port)
    checkpoint.save_checkpoint(str(tmp_path / "port.npz"), port)
    back = jax_ckpt.load_checkpoint(str(tmp_path / "port.npz"), tree)
    assert (sorted(np.load(tmp_path / "ref.npz").files)
            == sorted(np.load(tmp_path / "port.npz").files))
    ref_leaves = jax.tree_util.tree_leaves(tree)
    for a, b, c in zip(ref_leaves, optimizer.tree_leaves(got),
                       jax.tree_util.tree_leaves(back)):
        assert b.dtype == {"bfloat16": torch.bfloat16,
                           "float32": torch.float32}[str(a.dtype)]
        assert c.dtype == a.dtype
        want = np.asarray(a, np.float32)
        assert np.array_equal(b.float().numpy(), want)
        assert np.array_equal(np.asarray(c, np.float32), want)
    with pytest.raises(KeyError):
        checkpoint.load_checkpoint(str(tmp_path / "port.npz"),
                                   {"other": port["lora"]})


def test_cli_trains_on_cpu(tmp_path, capsys):
    out = tmp_path / "adapter.npz"
    assert train_cli.main(["--device", "cpu", "--arch", "qwen2-0.5b",
                           "--steps", "3", "--seq-len", "16",
                           "--batch-size", "2", "--out", str(out)]) == 0
    assert "final loss" in capsys.readouterr().out
    jm = jax_build_model(jax_reduced_config(jax_get_config("qwen2-0.5b")))
    like = jm.init_lora(jax.random.PRNGKey(0))
    lora = jax_ckpt.load_checkpoint(str(out), like)
    assert any(float(jnp.abs(b).max()) > 0
               for b in jax.tree_util.tree_leaves(lora))
