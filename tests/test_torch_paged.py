"""PyTorch port's paged KV arena, shared-prefix cache and chunked prefill
vs the JAX package's.

* Model (reduced Llama-3.1-8B, f32, bridged weights, nonzero-B
  adapters): ``decode_step_paged`` (logits and the updated arena; the
  einsum backend with the page gather off, sgmv with it on),
  ``prefill_suffix`` at a prefix of one and two blocks, and
  ``prefill_suffix_dense`` match within 1e-4 · max|ref|.
* Engine (``_FakeTime`` in both engines, the same adapters, ``edgelora``
  and ``edgelora_no_aas``): token streams and the whole
  ``ServingSummary`` (``kv_stats`` and ``prefix_stats`` included) are
  equal for the paged arena at dense-equivalent capacity (gather on and
  off, whose streams also equal the port's dense ones), a tight arena
  that defers and preempts, the prefix cache with hits and a
  copy-on-write page (matched at selection and at admission), and
  chunked prefill on both KV backends.
* The engine refuses only what is still unported, and the CLI serves
  the paged, prefix and chunk flags on the CPU.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import kvpool as jkv  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving import kvpool as tkv  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig  # noqa: E402
from test_torch_engine import (  # noqa: E402
    _FakeTime, _configs, _engine_kwargs, _run_cli, _summary_json, weights)
from test_torch_model import (  # noqa: E402
    BUCKET, F32_TOL, MAX_CTX, SLOTS, TOKENS_B, Pair, rel_err, to_numpy)

assert weights  # the engine tests' module fixture, reused here

# ---------------------------------------------------------------------------
# model: paged decode and suffix prefills
# ---------------------------------------------------------------------------

BS, N_BLOCKS = 4, 24


@pytest.fixture(scope="module")
def pair():
    return Pair("float32")


def _metas():
    template = {"slot0": {"k": np.zeros((2, 1, MAX_CTX, 1, 1)),
                          "pos": np.zeros((2, 1, MAX_CTX))}}
    jm = jkv.paged_meta(template, N_BLOCKS, BS, MAX_CTX)
    tm = tkv.paged_meta(template, N_BLOCKS, BS, MAX_CTX)
    return jm, tm


def _jmode(p, backend, sids=SLOTS):
    from repro.core.lora import LoRAMode as JaxLoRAMode
    return JaxLoRAMode("batched", jnp.asarray(sids), p.cfg.lora.scale,
                       backend, True)


def _tables(lengths, extra):
    """Shuffled distinct pages for each row's lengths + extra tokens."""
    rng = np.random.default_rng(9)
    perm = rng.permutation(N_BLOCKS)
    mb = -(-(MAX_CTX + 1) // BS)
    t = np.full((len(lengths), mb), -1, np.int32)
    used = 0
    for r, n in enumerate(lengths):
        k = -(-(int(n) + extra) // BS)
        t[r, :k] = perm[used:used + k]
        used += k
    return t


def _donor_arena(p, backend, lengths, tables, jm):
    """The reference prefills the rows and scatters them into a fresh
    arena; returns (jax arena, the same arena bridged to the port)."""
    prefill = p.jax_steps(backend)[0]
    _, jc = prefill(p.jp, p.jpool, jnp.asarray(p.tokens),
                    p.jm.init_cache(TOKENS_B, MAX_CTX), jnp.asarray(SLOTS),
                    jnp.asarray(lengths))
    ja = jkv.build_arena(p.jm.init_cache(TOKENS_B, MAX_CTX), jm)
    ja = jkv.scatter_prefill(ja, jc, jnp.asarray(tables), lengths,
                             np.full(len(lengths), BUCKET, np.int32),
                             jnp.arange(len(lengths)), jm)
    return ja, bridge.cache_from_numpy(to_numpy(ja)), jc


def _assert_arenas_close(ja, ta):
    for name in ("k", "v"):
        want = np.asarray(ja["slot0"][name])[:, :N_BLOCKS]   # real pages
        got = ta["slot0"][name].numpy()[:, :N_BLOCKS]
        assert rel_err(got, want) <= F32_TOL, name


@pytest.mark.parametrize("backend,gather", [("einsum", False),
                                            ("sgmv", True)])
def test_decode_step_paged_matches_reference(pair, backend, gather):
    p = pair
    jm, tm = _metas()
    lengths = np.array([16, 9, 5], np.int32)
    tables = _tables(lengths, extra=3)
    ja, ta, _ = _donor_arena(p, backend, lengths, tables, jm)
    jgather = (functools.partial(jops.paged_gather, interpret=True,
                                 use_kernel=True) if gather else None)
    tgather = (functools.partial(tops.paged_gather, use_kernel=True)
               if gather else None)
    jstep = jax.jit(functools.partial(
        p.jm.decode_step_paged, lora_mode=_jmode(p, backend), meta=jm,
        page_gather=jgather))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, p.cfg.vocab_size, TOKENS_B).astype(np.int32)
    pos = lengths.copy()
    pad = np.full(TOKENS_B, BUCKET, np.int32)
    for _ in range(3):
        jl, ja = jstep(p.jp, jnp.asarray(tokens), ja, jnp.asarray(tables),
                       jnp.asarray(pos), jnp.asarray(lengths),
                       jnp.asarray(pad), jnp.asarray(pos), lora=p.jpool)
        tl, ta = p.tm.decode_step_paged(
            p.tp, torch.from_numpy(tokens), ta, torch.from_numpy(tables),
            torch.from_numpy(pos), torch.from_numpy(lengths),
            torch.from_numpy(pad), torch.from_numpy(pos), p.tpool,
            p.mode(backend), meta=tm, page_gather=tgather)
        assert rel_err(tl.numpy(), jl) <= F32_TOL
        _assert_arenas_close(ja, ta)
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


@pytest.mark.parametrize("prefix_len", [BS, 2 * BS])
def test_prefill_suffix_matches_reference(pair, prefix_len):
    p = pair
    jm, tm = _metas()
    lengths = np.array([16, 13, 9], np.int32)
    tables = _tables(lengths, extra=1)
    ja, ta, _ = _donor_arena(p, "einsum", lengths, tables, jm)
    sfx = np.ascontiguousarray(p.tokens[:, prefix_len:])
    jl, jc = jax.jit(functools.partial(
        p.jm.prefill_suffix, prefix_len=prefix_len,
        lora_mode=_jmode(p, "einsum"), meta=jm))(
        p.jp, jnp.asarray(sfx), p.jm.init_cache(TOKENS_B, MAX_CTX), ja,
        jnp.asarray(tables), jnp.asarray(lengths), lora=p.jpool)
    tl, tc = p.tm.prefill_suffix(
        p.tp, torch.from_numpy(sfx), p.tm.init_cache(TOKENS_B, MAX_CTX), ta,
        torch.from_numpy(tables), torch.from_numpy(lengths), prefix_len,
        p.tpool, p.mode("einsum"), meta=tm)
    assert rel_err(tl.numpy(), jl) <= F32_TOL
    for name in ("k", "v"):
        assert rel_err(tc["slot0"][name].numpy(),
                       np.asarray(jc["slot0"][name])) <= F32_TOL
    np.testing.assert_array_equal(tc["slot0"]["pos"].numpy(),
                                  np.asarray(jc["slot0"]["pos"]))


def test_prefill_suffix_dense_matches_reference(pair):
    """A chunk at positions [8, 16) over the rings an earlier chunk wrote
    (the rows' slots in a 4-slot dense cache)."""
    p = pair
    start, end = 8, BUCKET
    lengths = np.array([16, 13, 9], np.int32)
    prefill = p.jax_steps("einsum")[0]
    _, jc = prefill(p.jp, p.jpool, jnp.asarray(p.tokens[:, :start]),
                    p.jm.init_cache(TOKENS_B, MAX_CTX), jnp.asarray(SLOTS),
                    jnp.asarray(np.minimum(lengths, start)))
    slot_idx = np.array([2, 0, 3], np.int32)
    gcache = jax.tree.map(
        lambda g, c: g.at[:, slot_idx].set(c),
        p.jm.init_cache(4, MAX_CTX), jc)
    chunk = np.ascontiguousarray(p.tokens[:, start:end])
    clamped = np.minimum(lengths, end)
    jl, jc2 = jax.jit(functools.partial(
        p.jm.prefill_suffix_dense, prefix_len=start,
        lora_mode=_jmode(p, "einsum")))(
        p.jp, jnp.asarray(chunk), p.jm.init_cache(TOKENS_B, MAX_CTX), gcache,
        jnp.asarray(slot_idx), jnp.asarray(clamped), lora=p.jpool)
    tl, tc = p.tm.prefill_suffix_dense(
        p.tp, torch.from_numpy(chunk), p.tm.init_cache(TOKENS_B, MAX_CTX),
        bridge.cache_from_numpy(to_numpy(gcache)),
        torch.from_numpy(slot_idx), torch.from_numpy(clamped), start,
        p.tpool, p.mode("einsum"))
    assert rel_err(tl.numpy(), jl) <= F32_TOL
    for name in ("k", "v"):
        assert rel_err(tc["slot0"][name].numpy(),
                       np.asarray(jc2["slot0"][name])) <= F32_TOL


# ---------------------------------------------------------------------------
# engine parity
# ---------------------------------------------------------------------------

SYS_LEN = 16
CHUNK = 16


def _trace_fn(duration=0.25, system_prompt_len=0, full_sys_every=0,
              output_range=(2, 7), rate=40.0):
    """A short multi-tenant trace; with ``full_sys_every`` every k-th
    request that opens with its tenant's system prompt sends only that
    prompt (a block-aligned whole-prompt match: copy-on-write)."""
    def make(mod, cfg):
        trace = mod.generate_trace(mod.WorkloadConfig(
            n_adapters=6, alpha=0.8, request_rate=rate, duration=duration,
            input_range=(4, 40), output_range=output_range,
            system_prompt_len=system_prompt_len, vocab_size=cfg.vocab_size,
            seed=5))
        if full_sys_every:
            opened = [r for r in trace if r.prompt_len > SYS_LEN]
            for r in opened[1::full_sys_every]:
                r.prompt_tokens = np.asarray(r.prompt_tokens)[:SYS_LEN]
                r.prompt_len = SYS_LEN
        return trace
    return make


def _serve_pair(monkeypatch, weights, policy, trace_fn, **ekw):
    params, adapters = weights
    jcfg, tcfg = _configs()
    monkeypatch.setattr(jax_engine.EdgeLoRAEngine, "_adapter_host",
                        lambda self, aid: jax.tree.map(jnp.asarray,
                                                       adapters[aid]))
    jeng = jax_engine.EdgeLoRAEngine(
        jcfg, jax_engine.EngineConfig(**_engine_kwargs(jcfg, policy), **ekw),
        params=jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr("repro.serving.engine.time", _FakeTime())
    jtrace = trace_fn(jax_workload, jcfg)
    jsum = jeng.serve(jtrace)

    teng = _port_engine(weights, policy, **ekw)
    ttrace = trace_fn(workload, tcfg)
    tsum = teng.serve(ttrace)
    assert jsum.n_completed == jsum.n_requests == len(jtrace) >= 6
    for a, b in zip(jtrace, ttrace):
        assert a.tokens == b.tokens, a.request_id
        for f in ("selected_adapter", "first_token_time", "finish_time",
                  "generated"):
            assert getattr(a, f) == getattr(b, f), (a.request_id, f)
    assert _summary_json(jsum) == _summary_json(tsum)
    return jsum, teng, ttrace


def _port_engine(weights, policy, **ekw):
    params, adapters = weights
    _, tcfg = _configs()
    return EdgeLoRAEngine(
        tcfg, EngineConfig(**_engine_kwargs(tcfg, policy), **ekw),
        params=bridge.tree_from_numpy(params), device="cpu",
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(
            adapters[aid]),
        timer=_FakeTime())


def _streams(trace):
    return {r.request_id: tuple(r.tokens) for r in trace}


@pytest.mark.parametrize("policy,gather", [("edgelora", False),
                                           ("edgelora_no_aas", True)])
def test_paged_engine_matches_reference(monkeypatch, weights, policy,
                                        gather):
    trace_fn = _trace_fn()
    jsum, teng, ttrace = _serve_pair(monkeypatch, weights, policy, trace_fn,
                                     kv_backend="paged",
                                     kv_gather_kernel=gather)
    assert teng.kv_gather_kernel is gather
    kv = jsum.kv_stats
    assert kv["deferrals"] == kv["preemptions"] == 0 and kv["allocs"] > 0
    dense = _port_engine(weights, policy, kv_backend="dense")
    dtrace = trace_fn(workload, _configs()[1])
    dense.serve(dtrace)
    assert _streams(dtrace) == _streams(ttrace)


def test_tight_arena_defers_and_preempts_like_reference(monkeypatch,
                                                        weights):
    # one max_ctx sequence is ceil(65 / 8) = 9 pages; a burst of
    # arrivals (the fake clock advances 0.5 ms a step) with longer
    # outputs makes decoding sequences outgrow the arena
    jsum, teng, _ = _serve_pair(monkeypatch, weights, "edgelora",
                                _trace_fn(duration=0.008, rate=1000.0,
                                          output_range=(4, 16)),
                                kv_backend="paged", kv_block_size=8,
                                kv_arena_blocks=10)
    kv = jsum.kv_stats
    assert kv["deferrals"] > 0 and kv["preemptions"] > 0, kv
    assert teng.kvpool.used_blocks == 0


def _check_prefix_stats(jsum, teng):
    ps = jsum.prefix_stats
    assert ps["hit_requests"] > 0 and ps["saved_prefill_tokens"] > 0, ps
    assert ps["cow_copies"] >= 1, ps
    assert teng.prefix_cache.stats.as_dict() == {
        k: v for k, v in ps.items() if k != "enabled"}


def test_prefix_cache_matches_reference(monkeypatch, weights):
    """AAS-routed requests: the prefix is matched and spliced at
    selection (``_attach_prefix``)."""
    jsum, teng, _ = _serve_pair(
        monkeypatch, weights, "edgelora",
        _trace_fn(duration=0.3, system_prompt_len=SYS_LEN, full_sys_every=3),
        kv_backend="paged", kv_block_size=8, prefix_cache=True)
    _check_prefix_stats(jsum, teng)


@pytest.mark.parametrize("kv_backend", ["dense", "paged"])
def test_chunked_prefill_matches_reference(monkeypatch, weights,
                                           kv_backend):
    """Prompts longer than the chunk, on both backends; the paged case
    also runs the prefix cache with adapters known at admission
    (``_admit_prefix``), so chunk progress starts at a prefix hit."""
    ekw = dict(kv_backend=kv_backend, prefill_chunk=CHUNK)
    policy, trace_fn = "edgelora", _trace_fn()
    if kv_backend == "paged":
        policy = "edgelora_no_aas"
        trace_fn = _trace_fn(duration=0.3, system_prompt_len=SYS_LEN,
                             full_sys_every=3)
        ekw.update(kv_block_size=8, prefix_cache=True)
    jsum, teng, ttrace = _serve_pair(monkeypatch, weights, policy, trace_fn,
                                     **ekw)
    sfx = "prefill_sfx_dense" if kv_backend == "dense" else "prefill_sfx"
    assert any(k[0] == sfx for k in teng._durations), teng._durations
    assert max(r.prompt_len for r in ttrace) > 2 * CHUNK
    if kv_backend == "paged":
        _check_prefix_stats(jsum, teng)


# ---------------------------------------------------------------------------
# what is still refused; the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("change", [
    dict(kv_backend="paged"), dict(prefix_cache=True, kv_backend="paged"),
    dict(prefill_chunk=16),
    dict(prefix_cache=True, kv_backend="paged", prefill_chunk=8)])
def test_slice_two_features_no_longer_raise(change):
    _, tcfg = _configs()
    eng = EdgeLoRAEngine(tcfg, EngineConfig(max_ctx=64, **change),
                         device="cpu")
    assert eng.paged == (change.get("kv_backend") == "paged")
    assert eng.prefix_enabled == change.get("prefix_cache", False)
    assert eng.chunked == ("prefill_chunk" in change)
    assert eng.kv_gather_kernel is False      # CPU: the indexing route


def test_prefix_cache_requires_paged_backend():
    """As in the reference: the shared pages live in the arena."""
    _, tcfg = _configs()
    with pytest.raises(ValueError, match="requires kv_backend='paged'"):
        EdgeLoRAEngine(tcfg, EngineConfig(prefix_cache=True,
                                          kv_backend="dense"), device="cpu")
    with pytest.raises(ValueError, match="prefill_chunk must be >= 1"):
        EdgeLoRAEngine(tcfg, EngineConfig(prefill_chunk=0), device="cpu")


def test_cli_serves_paged_prefix_and_chunks_on_cpu():
    out = _run_cli("--device", "cpu", "--prefix-cache",
                   "--system-prompt-len", "16", "--prefill-chunk", "16",
                   "--n-adapters", "4", "--rate", "3", "--duration", "2",
                   "--max-ctx", "96")
    assert out.returncode == 0, out.stderr
    row = out.stdout.strip().splitlines()[-1]
    done, total = row.split("completed=")[1].split()[0].split("/")
    assert done == total and int(total) > 0
    assert " kv=paged;blocks=" in row and " prefix=on;hits=" in row, row
    hits = row.split("prefix=on;hits=")[1].split("/")[0]
    assert int(hits) > 0, row
    assert "kv_backend=paged device=cpu" in out.stderr
