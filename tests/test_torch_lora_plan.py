"""The batched-LoRA step's plan memo (``LoRAMode.plans``), on the CPU.

The sgmv backend's grouping plan depends only on the per-token slots,
the pool size and the block size, so a step whose mode carries a memo
plans once per token layout and every other projection reuses the plan.

* A dense (qwen2-0.5b), an SSM (mamba2-130m) and an encoder-decoder
  (whisper-medium: the encoder's frames and the decoder's tokens are two
  layouts of one prefill; its decode step runs projections on [B, 1, d]
  and on [B, d], one token count) config's prefill and decode steps on
  the sgmv backend's plain versions call ``plan_grouping`` once per
  distinct token count, and give logits bit-equal to the same step with
  a memo-less mode.
* No plan leaks: a second step with other adapter ids on the same shapes
  equals the einsum backend within the port's f32 tolerance and a fresh
  mode bit for bit, also when the first step's memo is handed on.
"""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.core import lora  # noqa: E402
from repro_torch.core.lora import LoRAMode  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

N_POOL, B, S, MAX_CTX = 4, 3, 16, 32
LENGTHS = torch.tensor([16, 9, 5], dtype=torch.int32)  # right-padded rows
SLOTS = torch.tensor([2, 0, 3], dtype=torch.int32)     # mixed adapters
OTHER_SLOTS = torch.tensor([1, 3, 1], dtype=torch.int32)
# the port's f32 tolerance for sgmv against einsum-backed logits
# (tests/test_torch_model.py): 1e-4 of max|logit|
F32_TOL = 1e-4
# arch: (distinct token layouts in a prefill step, in a decode step);
# distinct layouts have distinct token counts, but for [B, 1] and [B],
# which share a plan
LAYOUTS = {"qwen2-0.5b": (1, 1), "mamba2-130m": (1, 1),
           "whisper-medium": (2, 2)}


class Setup:
    """A reduced f32 model on the CPU with a pool whose B is not zero
    (``init_lora`` starts B at zero, which would hide every delta)."""

    def __init__(self, arch):
        self.cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                       dtype="float32")
        self.tm = build_model(self.cfg, "cpu")
        gen = torch.Generator().manual_seed(0)
        self.params = self.tm.init(gen)
        self.pool = self.tm.init_lora(gen, n_slots=N_POOL)
        for leaf in _leaves(self.pool):
            leaf.copy_(0.05 * torch.randn(leaf.shape, generator=gen))
        self.tokens = torch.randint(0, self.cfg.vocab_size, (B, S),
                                    generator=gen)
        self.batch = {"tokens": self.tokens}
        if self.cfg.encoder is not None:
            self.batch["frames"] = torch.randn(
                (B, self.cfg.encoder.n_frames, self.cfg.d_model),
                generator=gen)

    def mode(self, slots=SLOTS, backend="sgmv", plans=None):
        return LoRAMode("batched", slots, self.cfg.lora.scale, backend,
                        plans)

    def prefill(self, mode):
        return self.tm.prefill(self.params, self.batch,
                               self.tm.init_cache(B, MAX_CTX), self.pool,
                               mode, lengths=LENGTHS)

    def decode(self, mode, cache, tokens, pos):
        return self.tm.decode_step(self.params, tokens, _clone(cache), pos,
                                   self.pool, mode)


def _leaves(tree):
    if isinstance(tree, dict):
        for sub in tree.values():
            yield from _leaves(sub)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _clone(tree):
    """A copy of a cache: steps update it in place (the SSM state too)."""
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def rel_err(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def setup(request):
    return Setup(request.param)


@pytest.fixture
def counted(monkeypatch):
    """Counts ``plan_grouping`` calls and records each sgmv LoRA call's
    token layout."""
    plans, layouts = [], []
    plan_grouping, delta = ops.plan_grouping, lora._lora_delta_sgmv

    def counting_plan(token_slots, n_slots, blk_t):
        plans.append(tuple(token_slots.shape))
        return plan_grouping(token_slots, n_slots, blk_t)

    def recording_delta(x, *args, **kwargs):
        layouts.append(tuple(x.shape[:-1]))
        return delta(x, *args, **kwargs)

    monkeypatch.setattr(ops, "plan_grouping", counting_plan)
    monkeypatch.setattr(lora, "_lora_delta_sgmv", recording_delta)
    return plans, layouts


def _token_counts(layouts):
    return {math.prod(lead) for lead in layouts}


def test_one_plan_per_layout_and_step(setup, counted):
    plans, layouts = counted
    n_prefill, n_decode = LAYOUTS[setup.cfg.name]
    logits, cache = setup.prefill(setup.mode(plans={}))
    assert len(set(layouts)) == n_prefill
    assert len(plans) == len(_token_counts(layouts)) == n_prefill
    assert len(plans) < len(layouts)
    tokens = logits.argmax(-1).to(torch.int32)
    pos = LENGTHS.clone()
    for _ in range(2):
        del plans[:], layouts[:]
        dl, next_cache = setup.decode(setup.mode(plans={}), cache, tokens,
                                      pos)
        assert len(set(layouts)) == n_decode
        assert plans == [(B,)] and len(_token_counts(layouts)) == 1
        # the same step without a memo: a plan per call, the same bits
        del plans[:], layouts[:]
        ref, _ = setup.decode(setup.mode(), cache, tokens, pos)
        assert len(plans) == len(layouts)
        assert torch.equal(dl, ref)
        cache, tokens, pos = (next_cache, dl.argmax(-1).to(torch.int32),
                              pos + 1)
    del plans[:], layouts[:]
    ref, _ = setup.prefill(setup.mode())
    assert len(plans) == len(layouts)
    assert torch.equal(logits, ref)


def test_no_plan_leaks_across_steps(setup, counted):
    plans, _ = counted
    first = setup.mode(plans={})
    setup.prefill(first)
    n_first = len(plans)
    for memo in ({}, first.plans):   # a fresh memo, and the first one's
        del plans[:]
        got, _ = setup.prefill(setup.mode(OTHER_SLOTS, plans=memo))
        assert len(plans) == n_first   # planned anew, not reused
        fresh, _ = setup.prefill(setup.mode(OTHER_SLOTS))
        assert torch.equal(got, fresh)
        einsum, _ = setup.prefill(setup.mode(OTHER_SLOTS, "einsum"))
        assert rel_err(got, einsum) <= F32_TOL
        # the ids matter: the first step's slots give other logits
        mine, _ = setup.prefill(setup.mode())
        assert rel_err(mine, got) > 100 * F32_TOL


def test_sgmv_takes_a_ready_plan(monkeypatch):
    """``ops.sgmv`` given ``sgmv_plan``'s plan equals a call that plans
    itself, bit for bit, and does not plan again."""
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((21, 64), generator=gen)
    a = torch.randn((4, 8, 64), generator=gen)
    b = torch.randn((4, 48, 8), generator=gen)
    slots = torch.randint(0, 4, (21,), generator=gen, dtype=torch.int32)
    want = ops.sgmv(x, a, b, slots, 0.5, n_slots=4, blk_t=None)
    plan = ops.sgmv_plan(slots, 4, ops.auto_blk_t(21, 4))
    assert plan.blk_t == ops.auto_blk_t(21, 4)
    assert plan.pos.dtype == torch.int64
    assert torch.equal(plan.pos, plan.grouping.padded_pos.long())
    with monkeypatch.context() as m:
        m.setattr(ops, "plan_grouping", None)   # a call would raise
        got = ops.sgmv(x, a, b, slots, 0.5, n_slots=4, blk_t=None,
                       plan=plan)
    assert torch.equal(got, want)
