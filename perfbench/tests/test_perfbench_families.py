"""The harness takes any decoder-only configuration the program's
``ModelConfig`` expresses, with a dense or an expert feed-forward: the
configuration file builds the program's config, the weights and the
adapter bank follow the program's own trees, and the work counts follow
each layer as the program builds it. The two dense configurations keep
the exact layouts and counts they had before the harness took other
families (pinned below)."""
import copy
import dataclasses
import hashlib
import json
import math

import pytest
import torch

from cpu_cell import small
from perfbench.harness import bench, spec, weights, work
from repro_torch.configs.base import (PORTED_ARCHS, MoEConfig, get_config,
                                      reduced_config)
from repro_torch.models import transformer
from repro_torch.models.model import Model

PK = {"bf16_flops_per_s": 989e12, "hbm_bytes_per_s": 3.35e12}
ROWS = [work.Row(0, 1500, 0), work.Row(1, 1, 1700)]   # a prefill, a decode

# per dense configuration: param_layout's leaves, elements and digest;
# one adapter's elements and digest; linear_params; model_flops and the
# SGMV bound's seconds of ROWS
DENSE = {
    "starcoder2-7b": (14, 7_399_232_000, "8cc777baca2498d1", 38_273_024,
                      "cfa01f13e828dfa8", 217_055_232, 21_631_993_053_184,
                      0.0022349732298507464),
    "qwen2-0.5b": (14, 494_032_768, "9dd9a6c43be35493", 8_798_208,
                   "4165fd84fe705c94", 14_909_440, 1_198_130_917_376,
                   0.0005137759522388057),
}

# Mellum2-12B-A2.5B-Instruct in the program's fields, as its config.json
# publishes it (https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct):
# every layer sparse, 64 experts of width 896, top-8, no shared expert;
# three sliding-window layers of four. Its YaRN RoPE on the full layers
# is not a field of the program yet.
MELLUM2 = {
    "name": "mellum2-12b-a2.5b",
    "source": "https://huggingface.co/JetBrains/Mellum2-12B-A2.5B-Instruct",
    "family": "moe", "n_layers": 28, "d_model": 2304, "n_heads": 32,
    "n_kv_heads": 4, "head_dim": 128, "d_ff": 896, "vocab_size": 98304,
    "act": "silu", "glu": True, "norm_eps": 1e-06, "tie_embeddings": False,
    "dtype": "bfloat16",
    "attn": {"layer_pattern": ["local", "local", "local", "global"],
             "sliding_window": 1024, "rope_theta": 500000.0},
    "moe": {"n_experts": 64, "top_k": 8},
    "lora": {"rank": 16, "alpha": 32.0,
             "target_modules": ["q", "k", "v", "o", "up", "gate", "down"]},
    "reduced": [],
}
ATTN, ROUTER, EXPERT = 21_233_664, 147_456, 6_193_152


def _digest(layout):
    return hashlib.sha256(repr([(tuple(p), tuple(s), float(x))
                                for p, s, x in layout]).encode()
                          ).hexdigest()[:16]


def _elements(layout):
    return sum(math.prod(s) for _, s, _ in layout)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


def _as_file(cfg):
    """A program config as a configuration file would hold it."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _port_configs():
    out = {a: reduced_config(get_config(a)) for a in PORTED_ARCHS
           if get_config(a).family in ("dense", "vlm", "moe")}
    # MLP LoRA asked of MoE slots: dbrx's have no shared expert to carry
    # it; llama4's dense slots carry it, and its MoE slots on the shared
    # expert
    for arch in ("dbrx_132b", "llama4_maverick_400b_a17b"):
        cfg = out[arch]
        out[f"{arch}-mlp-lora"] = dataclasses.replace(
            cfg, lora=dataclasses.replace(
                cfg.lora, target_modules=("q", "v", "up", "gate", "down")))
    return out


PORT = _port_configs()


@pytest.mark.parametrize("name", sorted(DENSE))
def test_dense_layouts_and_counts_are_pinned(name):
    cfg = json.loads((spec.BENCH_DIR / "configs" / f"{name}.json").read_text())
    leaves, params, p_digest, lora, l_digest, linear, flops, sgmv_s = \
        DENSE[name]
    layout = weights.param_layout(cfg)
    assert (len(layout), _elements(layout), _digest(layout)) == (
        leaves, params, p_digest)
    bank = weights.lora_layout(cfg, 0.2)
    assert (_elements(bank), _digest(bank)) == (lora, l_digest)
    assert work.linear_params(cfg) == linear
    assert work.model_flops(cfg, ROWS) == flops
    bound = work.Bound()
    work.sgmv_bound(cfg, ROWS, PK, bound)
    assert bound.seconds == sgmv_s


@pytest.mark.parametrize("name", sorted(PORT))
def test_a_port_config_round_trips_through_a_file(name):
    cfg = PORT[name]
    assert spec.program_config(_as_file(cfg)) == cfg


@pytest.mark.parametrize("name", sorted(PORT))
def test_the_harness_weights_load_into_the_program(name):
    cfg = PORT[name]
    model = Model(cfg, "cpu")
    w = weights.Weights(_as_file(cfg), 2 ** 31 + 7, "cpu")
    model.load_params(w.tree)
    want = dict(weights._leaves(model._param_tree(None)))
    got = dict(weights._leaves(w.tree))
    assert {k: v.dtype for k, v in got.items()} == {
        k: v.dtype for k, v in want.items()}
    assert all(torch.isfinite(v.float()).all() for v in got.values())


@pytest.mark.parametrize("name", sorted(PORT))
def test_a_bank_entry_has_the_programs_adapter_shapes(name):
    cfg = PORT[name]
    bank = weights.AdapterBank(_as_file(cfg), 1, 0.2, 5, "cpu", pin=False)
    lora = Model(cfg, "cpu").init_lora(torch.Generator())
    assert _shapes(bank.entries[0]) == _shapes(lora)
    # the yardstick counts, layer by layer, the pairs the program gives
    period = transformer.stack_period(cfg)
    for i in range(cfg.n_layers):
        carried = set(lora["layers"][f"slot{i % period}"])
        assert sorted(work.lora_names(_as_file(cfg), i)) == sorted(carried)


@pytest.mark.parametrize("name", sorted(PORT))
def test_linear_params_agree_with_the_programs_active_count(name):
    cfg, f = PORT[name], _as_file(PORT[name])
    embed = cfg.vocab_size * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    assert sum(work.linear_params(f, i) for i in range(cfg.n_layers)) \
        + embed == cfg.active_param_count()


def test_an_expert_block_builds_the_programs_moe_config():
    mc = spec.program_config(MELLUM2)
    assert mc.moe == MoEConfig(n_experts=64, top_k=8)
    assert mc.attn.layer_pattern == ("local", "local", "local", "global")
    assert mc.citation == MELLUM2["source"]
    traffic = {"pool": 16, "requests": {"tenants": 1024}}
    lora = spec.model_config(MELLUM2, traffic).lora
    assert (lora.max_resident, lora.n_adapters) == (16, 1024)
    assert lora.target_modules == tuple(MELLUM2["lora"]["target_modules"])


@pytest.mark.parametrize("where,key", [((), "rope_scaling"),
                                       (("attn",), "yarn_factor"),
                                       (("moe",), "norm_topk_prob")])
def test_a_key_the_program_lacks_raises_naming_it(where, key):
    cfg = copy.deepcopy(MELLUM2)
    block = cfg
    for k in where:
        block = block[k]
    block[key] = 1
    with pytest.raises(KeyError, match=key):
        spec.program_config(cfg)


def test_mellum2_counts_its_experts_not_a_dense_mlp():
    assert EXPERT == 3 * 2304 * 896 and ROUTER == 2304 * 64
    dense = {**MELLUM2, "moe": None}
    assert work.linear_params(dense) == ATTN + EXPERT
    for i in range(28):
        assert work.linear_params(MELLUM2, i) == ATTN + ROUTER + 8 * EXPERT \
            == 70_926_336
        assert work.lora_names(MELLUM2, i) == ["q", "k", "v", "o"]
    mc = spec.program_config(MELLUM2)
    assert 28 * 70_926_336 + 2 * 98304 * 2304 == mc.active_param_count()
    layout = weights.param_layout(MELLUM2)
    norms = (2 * 28 + 1) * 2304
    assert _elements(layout) == mc.param_count() + norms == 12_149_915_904
    # an MoE slot without a shared expert carries no MLP pair
    assert {p[2:] for p, _, _ in weights.lora_layout(MELLUM2, 0.2)} == {
        (m, ab) for m in "qkvo" for ab in "AB"}


@pytest.mark.parametrize("tokens,asked,read", [(1, None, 8), (1, 64, 8),
                                               (100, None, 8), (100, 40, 40),
                                               (100, 2, 8), (100, 1000, 64),
                                               (0, None, 0)])
def test_moe_bound_reads_at_most_the_experts_routing_can_reach(tokens, asked,
                                                               read):
    rows = [work.Row(0, tokens, 0)] if tokens else []
    out = work.Bound()
    work.moe_bound(MELLUM2, rows, PK, out, experts_read=asked)
    per_layer_flops = 2 * tokens * 8 * EXPERT
    per_layer_bytes = 2 * tokens * 2304 * 2 + read * EXPERT * 2
    assert out.flops == 28 * per_layer_flops
    assert out.bytes == 28 * per_layer_bytes
    assert out.seconds == pytest.approx(28 * max(per_layer_flops / 989e12,
                                                 per_layer_bytes / 3.35e12))


def test_moe_bound_counts_only_the_expert_layers():
    l4 = _as_file(get_config("llama4_maverick_400b_a17b"))
    out = work.Bound()
    work.moe_bound(l4, [work.Row(0, 10, 0)], PK, out)
    one = 2 * 10 * 1 * work._mlp_params(l4)
    assert out.flops == l4["n_layers"] // 2 * one


def test_a_tiny_expert_cell_serves_and_every_reader_reads():
    """A Mellum2-shaped cell (8 experts, top-2, three local layers and a
    global one) built in memory runs the harness's set-up and window;
    every metric's reader gives a number or None. Its ``correct`` waits
    for an expert reference under ``reference/``."""
    base = spec.load_cell("sc2-7b.longctx")
    cell = small(dataclasses.replace(base, name="mellum2-tiny.longctx",
                                     config=copy.deepcopy(MELLUM2)))
    assert cell.config["moe"] == {"n_experts": 8, "top_k": 2}
    assert cell.config["n_layers"] == 4
    torch.set_num_threads(2)
    seed, dev = 2 ** 31 + 23, torch.device("cpu")
    served = bench.set_up(cell, seed, dev, lambda m: None)
    assert "moe" in served.weights.tree["layers"]["slot0"]
    assert served.weights.tree["layers"]["slot0"]["moe"]["router"].dtype \
        == torch.float32
    run = bench.window(served, bench.requests_for(cell, seed, 1.5), 1.5,
                       True, 0.0, lambda m: None)
    bench_json = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
    metrics = [m["name"] for m in bench_json["end_to_end"]
               + bench_json["per_layer"]]
    for r in (run, dataclasses.replace(run, peaks=PK)):
        values = {m: spec.reader(m).read(r) for m in metrics}
        for m, v in values.items():
            assert v is None or isinstance(v, float), (m, v)
        assert values["prompt_tokens_per_s"] > 0 and values["setup_s"] >= 0
    assert spec.reader("mfu_pct").read(
        dataclasses.replace(run, peaks=PK)) > 0
