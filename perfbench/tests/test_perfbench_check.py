"""The check itself: the reference agrees with the program in f32, its
precision control and the planted faults of the timed path fail it."""
import pytest
import torch

from cpu_cell import small_cell
from perfbench import control
from perfbench.harness import bench
from repro_torch.serving.engine import EdgeLoRAEngine

CELLS = ["sc2-7b.longctx", "qwen2-0.5b.tenants1k"]
# at the CPU size a sound bf16 run reads under 0.1 (0-0.06 seen); the
# planted faults read 1 or more
LIMIT = 0.15


def run_small(name, seed=2 ** 31 + 21, seconds=1.5, **cfg):
    torch.set_num_threads(2)
    cell = small_cell(name, widest_logit_gap=LIMIT)
    cell.config.update(cfg)
    return bench.run(cell, seed=seed, seconds=seconds, trace=False,
                     device="cpu", t_process=0.0, log=lambda m: None)


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_program_in_f32(name):
    out = run_small(name, dtype="float32")
    assert out["checks"]["tokens_compared"]["value"] >= 50
    assert out["checks"]["widest_logit_gap"]["value"] < 1e-4


@pytest.mark.parametrize("name", CELLS)
def test_precision_control_fails_where_the_program_passes(name):
    torch.set_num_threads(2)
    cell = small_cell(name, widest_logit_gap=LIMIT)
    served = bench.set_up(cell, 3, torch.device("cpu"), lambda m: None)
    for seed in (5, 2 ** 31 + 9, 77):
        r = control.readings(served, seed, 1.0, True, lambda m: None)
        assert r["tokens"] >= 50
        assert r["program_gap"] <= LIMIT < r["control_gap"]
        assert r["control_gap"] >= 3 * r["program_gap"]


def _alter_tokens(monkeypatch):
    """Served tokens altered where the prefill and decode steps produce
    them."""
    orig = EdgeLoRAEngine._build_steps

    def build(self):
        orig(self)
        for name in ("_prefill", "_decode"):
            step = getattr(self, name)

            def bad(*args, step=step):
                toks, cache = step(*args)
                return (toks + 1) % self.cfg.vocab_size, cache
            setattr(self, name, bad)
    monkeypatch.setattr(EdgeLoRAEngine, "_build_steps", build)


def _drop_prefill_state(monkeypatch):
    """The prefill step's KV left unwritten: the cache keeps its state."""
    monkeypatch.setattr(EdgeLoRAEngine, "_write_slots",
                        lambda self, gcache, bcache, slot_idx: gcache)


def _stale_adapter(monkeypatch):
    """A swap-in that never lands: the pool slot keeps the adapter it
    held (LoRA applied from a stale slot)."""
    orig = EdgeLoRAEngine._load_adapter
    seen = set()

    def load(self, adapter_id, slot):
        if slot not in seen:      # the first fill of each slot lands
            seen.add(slot)
            orig(self, adapter_id, slot)
    monkeypatch.setattr(EdgeLoRAEngine, "_load_adapter", load)


def _half_batch_lora(monkeypatch):
    """Half of each batch's rows take another row's adapter (the rest
    keep their own)."""
    from repro_torch.core import lora
    orig = lora.lora_delta_batched

    def half(x, a, b, ids, scale, backend="einsum"):
        ids = ids.clone()
        n = ids.shape[0] // 2
        if n:
            ids[:n] = (ids[:n] + 1) % a.shape[0]
        return orig(x, a, b, ids, scale, backend)
    monkeypatch.setattr(lora, "lora_delta_batched", half)


@pytest.mark.parametrize("fault", [_alter_tokens, _drop_prefill_state,
                                   _stale_adapter, _half_batch_lora])
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_reads_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    out = run_small(name)
    assert out["correct"] is False
    assert out["checks"]["widest_logit_gap"]["value"] > LIMIT
