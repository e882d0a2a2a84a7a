"""The kernels' whole domain on the CPU: what the port's kernels take that
the reference's Pallas kernels compute, held against those kernels.

* ``sgmv_shrink`` / ``sgmv_expand`` (on the CPU, their plain versions) at
  LoRA ranks past one 64-rank chunk and token blocks past 128 rows,
  against ``repro.kernels.sgmv`` in interpret mode on the same padded
  buffer.
* ``units``, ``unit_tile`` and ``shrink_work``, the Python mirror of how
  the CUDA kernels cut a block into units of at most 128 rows and 64 ranks
  and a unit's ``d_in`` into splits: every (row, rank, column) of the used
  blocks exactly once, and the kernel's sum (each unit's splits in split
  order) equal to the plain version.
* ``flash_decode`` / ``flash_prefill`` (plain) at head dims off the
  kernels' built widths, 8 to 320, with window, chunk, softcap and int8
  K/V, against the reference's Pallas kernels in interpret mode.
* ``padded_head_dim`` and ``split_plan`` at head dims 96 to 512.
* Engine parity: reduced Llama-3.1-8B with LoRA rank 96 and head dim 96,
  port against reference on the same numpy weights, equal f32 token
  streams, step counters and summaries under a fake timer.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import sgmv as jsgmv  # noqa: E402
from repro.kernels.decode_attention import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_prefill as tpre  # noqa: E402
from repro_torch.kernels import sgmv  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig  # noqa: E402
from test_torch_engine import (  # noqa: E402
    N_ADAPTERS, _FakeTime, _adapter, _engine_kwargs, _numpy_tree, _param,
    _summary_json, _trace)
from test_torch_model import BF16_TOL  # noqa: E402

# f32 kernel against the reference: the same products summed in another
# order, within 1e-5 of max|ref|; bf16 inputs within BF16_TOL
TOL = {"float32": 1e-5, "bfloat16": BF16_TOL}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _close(got, want, dtype):
    got = np.asarray(got.float() if torch.is_tensor(got) else got,
                     np.float32)
    want = np.asarray(want, np.float32)
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= TOL[dtype] * scale, (err, scale)


# ---------------------------------------------------------------------------
# SGMV: any rank, any token block
# ---------------------------------------------------------------------------


def _sgmv_problem(dtype, blk_t, r, nb=3, n_slots=4, d_in=256, d_out=128,
                  seed=0):
    """A padded buffer of ``nb`` blocks with nonzero rows, an f32 pool and
    per-block slots; as (torch, jax) pairs holding the same values."""
    rng = np.random.default_rng(seed)
    td = getattr(torch, dtype)
    x = torch.from_numpy(rng.normal(size=(nb * blk_t, d_in)).astype(
        np.float32)).to(td)
    a = rng.normal(size=(n_slots, r, d_in)).astype(np.float32) / np.sqrt(r)
    b = rng.normal(size=(n_slots, d_out, r)).astype(np.float32)
    s = rng.normal(size=(nb * blk_t, r)).astype(np.float32)
    bs = rng.integers(0, n_slots, nb).astype(np.int32)
    jx = jnp.asarray(x.float().numpy(), JNP[dtype])
    return (x, torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(s),
            torch.from_numpy(bs)), (jx, a, b, s, jnp.asarray(bs))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("blk_t", [8, 128, 256])
@pytest.mark.parametrize("r", [65, 100, 128, 256])
def test_sgmv_any_rank_and_block_match_pallas(r, blk_t, dtype):
    """The port's shrink and expand at ranks past 64 and blocks of up to 256
    rows against the Pallas kernels, which take any rank (a BlockSpec
    width) and any block, on the same buffer: every block used."""
    (x, a, b, s, bs), (jx, ja, jb, js, jbs) = _sgmv_problem(dtype, blk_t, r,
                                                            seed=r + blk_t)
    jd = JNP[dtype]
    want_s = jsgmv.sgmv_shrink(jx, jnp.asarray(ja).astype(jd), jbs,
                               blk_t=blk_t, blk_d=128, interpret=True)
    want_y = jsgmv.sgmv_expand(jnp.asarray(js), jnp.asarray(jb).astype(jd),
                               jbs, blk_t=blk_t, blk_d=128, interpret=True)
    sgmv.reset_launches()
    got_s = sgmv.sgmv_shrink(x, a, bs, blk_t=blk_t)
    got_y = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t,
                             compute_dtype=getattr(torch, dtype))
    assert sgmv.launches == {"sgmv_shrink": 0, "sgmv_expand": 0}  # CPU
    assert got_s.shape == (x.shape[0], r) and got_y.shape == (x.shape[0], 128)
    _close(got_s, want_s, dtype)
    _close(got_y, want_y, dtype)


@pytest.mark.parametrize("blk_t,r", [(8, 32), (128, 64), (8, 65), (8, 128),
                                     (200, 100), (256, 128), (300, 1),
                                     (129, 257)])
def test_units_tile_each_block(blk_t, r):
    """A block's units: row slices of at most ``SUB_BLK_T`` rows and rank
    chunks of at most ``RANK_CHUNK`` ranks that tile [blk_t, r] exactly
    once; one unit at blk_t <= 128 and r <= 64; the slices of a block of
    k·128 rows are 128 rows each."""
    n_sub, sub_t, n_rc, rcw = sgmv.units(blk_t, r)
    assert 1 <= sub_t <= sgmv.SUB_BLK_T and 1 <= rcw <= sgmv.RANK_CHUNK
    if blk_t <= 128 and r <= 64:
        assert (n_sub, sub_t, n_rc, rcw) == (1, blk_t, 1, r)
    if blk_t % 128 == 0:
        assert sub_t == 128
    cover = np.zeros((2, blk_t, r), np.int32)
    for unit in range(2 * n_sub * n_rc):
        blk, t0, nt, r0, nr = sgmv.unit_tile(unit, blk_t, r)
        assert 0 < nt <= sub_t and 0 < nr <= rcw
        cover[blk, t0:t0 + nt, r0:r0 + nr] += 1
    assert (cover == 1).all()


def _kernel_sum(x, a, bs, blk_t, n_used, d_in, grid):
    """``sgmv_shrink`` as the CUDA kernel sums it, from ``shrink_work``:
    each item's partial over its unit's rows, ranks and columns (f64), a
    unit's splits added in split order, zeros past ``n_used``."""
    r = a.shape[1]
    out = torch.zeros(x.shape[0], r, dtype=torch.float64)
    parts = {}
    for cta in sgmv.shrink_work(n_used, d_in, grid, blk_t=blk_t, r=r):
        for unit, split, c0, c1 in cta:
            blk, t0, nt, r0, nr = sgmv.unit_tile(unit, blk_t, r)
            rows = slice(blk * blk_t + t0, blk * blk_t + t0 + nt)
            w = a[int(bs[blk]), r0:r0 + nr, c0:c1].to(x.dtype).double()
            parts.setdefault(unit, {})[split] = (
                rows, slice(r0, r0 + nr), x[rows, c0:c1].double() @ w.T)
    for unit, splits in parts.items():
        for split in sorted(splits):
            rows, ranks, p = splits[split]
            out[rows, ranks] += p
    return out


@pytest.mark.parametrize("n_used,nb,blk_t,r,d_in,grid", [
    (8, 21, 8, 128, 4096, 264),     # rank 128 at the decode step
    (3, 5, 256, 128, 1000, 264),    # blk_t 256: two slices a block
    (2, 4, 200, 100, 333, 132),     # ragged slices and rank chunks
    (5, 5, 8, 32, 640, 264),        # one unit a block (the old split)
    (0, 4, 256, 128, 256, 264),     # no tokens: all zeros
])
def test_shrink_work_remap_matches_plain(n_used, nb, blk_t, r, d_in, grid):
    """The kernel's remap of a block into units and of a unit's d_in into
    splits: the items cover each used (row, rank, column) exactly once, no
    CTA holding two items when a unit is split (a partial's scratch row is
    its item, below the grid), and their sum in the kernel's order equals
    ``shrink_plain`` with ``n_used`` within 1e-5 of max|plain|."""
    rng = np.random.default_rng(n_used + nb)
    x = torch.from_numpy(rng.normal(size=(nb * blk_t, d_in)).astype(
        np.float32))
    a = torch.from_numpy(rng.normal(size=(6, r, d_in)).astype(np.float32))
    bs = torch.from_numpy(rng.integers(0, 6, nb).astype(np.int32))
    work = sgmv.shrink_work(n_used, d_in, grid, blk_t=blk_t, r=r)
    s = sgmv.shrink_splits(n_used, d_in, grid, blk_t=blk_t, r=r)
    if s > 1:
        assert all(len(cta) <= 1 for cta in work)
    cover = np.zeros((nb * blk_t, r, d_in), np.int8)
    for cta in work:
        for unit, _, c0, c1 in cta:
            blk, t0, nt, r0, nr = sgmv.unit_tile(unit, blk_t, r)
            assert blk < n_used
            cover[blk * blk_t + t0:blk * blk_t + t0 + nt, r0:r0 + nr,
                  c0:c1] += 1
    assert (cover[:n_used * blk_t] == 1).all()
    assert not cover[n_used * blk_t:].any()
    got = _kernel_sum(x, a, bs, blk_t, n_used, d_in, grid)
    want = sgmv.shrink_plain(x, a, bs, blk_t=blk_t,
                             n_used=torch.tensor(n_used, dtype=torch.int32))
    if n_used == 0:
        assert not got.any() and not want.any()
        return
    _close(got, want.numpy(), "float32")


# ---------------------------------------------------------------------------
# attention at any head dim
# ---------------------------------------------------------------------------

HEAD_DIMS = [8, 40, 96, 100, 192, 320]
# (window, chunked, softcap): none, a sliding window with a softcap, a
# chunked window
MASKS = [(None, False, None), (16, False, 30.0), (16, True, None)]


def _pair(rng, shape, dtype):
    t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
        getattr(torch, dtype))
    return t, jnp.asarray(t.float().numpy(), JNP[dtype])


@pytest.mark.parametrize("mask", range(len(MASKS)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_decode_any_head_dim_matches_pallas(hd, dtype, mask):
    """``flash_decode`` at head dims off the built widths against the
    Pallas kernel (a scalar query position, GQA 4, a part-filled ring)."""
    window, chunked, softcap = MASKS[mask]
    rng = np.random.default_rng(hd)
    b, h, kh, c = 2, 8, 2, 64
    (tq, jq), (tk, jk), (tv, jv) = (_pair(rng, s, dtype) for s in (
        (b, h, hd), (b, c, kh, hd), (b, c, kh, hd)))
    kv_pos = np.broadcast_to(np.arange(c), (b, c)).astype(np.int32)
    kv_pos = np.where(kv_pos < c - 5, kv_pos, -1).astype(np.int32)
    kw = dict(window=window, chunked=chunked, softcap=softcap)
    got = tdec.flash_decode(tq, tk, tv, torch.from_numpy(kv_pos), c - 6,
                            **kw)
    want = jax_flash_decode(jq, jk, jv, jnp.asarray(kv_pos),
                            jnp.int32(c - 6), blk_c=32, interpret=True, **kw)
    assert got.shape == (b, h, hd) and got.dtype == tq.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_decode_int8_any_head_dim_matches_pallas(hd):
    """int8 K/V with per-(token, head) scales from the reference's
    ``_quantize_kv``, dequantised as the Pallas kernel does in its tiles."""
    rng = np.random.default_rng(hd + 1)
    b, h, kh, c = 2, 4, 2, 64
    q = jnp.asarray(rng.normal(size=(b, h, hd)), jnp.float32)
    kq, ks = jattn._quantize_kv(jnp.asarray(rng.normal(size=(b, c, kh, hd)),
                                            jnp.float32))
    vq, vs = jattn._quantize_kv(jnp.asarray(rng.normal(size=(b, c, kh, hd)),
                                            jnp.float32))
    pos = np.broadcast_to(np.arange(c), (b, c)).astype(np.int32)
    want = jax_flash_decode(q, kq, vq, jnp.asarray(pos), jnp.int32(c - 9),
                            k_scale=ks, v_scale=vs, window=16, blk_c=32,
                            interpret=True)
    t = {n: torch.from_numpy(np.array(v)) for n, v in
         dict(q=q, kq=kq, vq=vq, ks=ks, vs=vs).items()}
    got = tdec.flash_decode(t["q"], t["kq"], t["vq"], torch.from_numpy(pos),
                            c - 9, k_scale=t["ks"], v_scale=t["vs"],
                            window=16)
    _close(got, want, "float32")


@pytest.mark.parametrize("mask", range(len(MASKS)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_flash_prefill_any_head_dim_matches_pallas(hd, dtype, mask):
    """``flash_prefill`` at head dims off the built widths against the
    Pallas kernel (causal, GQA 2)."""
    window, chunked, softcap = MASKS[mask]
    rng = np.random.default_rng(hd + 2)
    b, s, h, kh = 1, 32, 4, 2
    (tq, jq), (tk, jk), (tv, jv) = (_pair(rng, sh, dtype) for sh in (
        (b, s, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    kw = dict(window=window, chunked=chunked, softcap=softcap)
    got = tpre.flash_prefill(tq, tk, tv, causal=True, **kw)
    want = jax_flash_prefill(jq, jk, jv, causal=True, blk_q=16, blk_kv=16,
                             interpret=True, **kw)
    assert got.shape == (b, s, h, hd) and got.dtype == tq.dtype
    _close(got, want, dtype)


def test_padded_head_dim():
    """The next built width up to 256, hd rounded up to 16 above; a
    width the kernels are built for is its own."""
    assert [tdec.padded_head_dim(d) for d in (1, 8, 32, 33, 40, 80, 81, 96,
                                              100, 129, 192, 200, 256)] == [
        32, 32, 32, 64, 64, 80, 96, 96, 128, 160, 192, 256, 256]
    assert [tdec.padded_head_dim(d) for d in (257, 320, 321, 512)] == [
        272, 320, 336, 512]
    for w in tdec.KERNEL_WIDTHS:
        assert tdec.padded_head_dim(w) == w
    with pytest.raises(ValueError):
        tdec.padded_head_dim(0)


@pytest.mark.parametrize("hd", [96, 100, 160, 192, 200, 256, 320, 512])
@pytest.mark.parametrize("itemsize", [1, 2, 4])
@pytest.mark.parametrize("g", [1, 4, 8])
def test_split_plan_any_head_dim(hd, itemsize, g):
    """The decode split plan at the padded head dim: contiguous splits that
    cover C exactly with none empty, each CTA's shared memory within
    ``SPLIT_SMEM``, and at least two CTAs per SM of an H100 wherever C
    has enough keys."""
    hdp = tdec.padded_head_dim(hd)
    for b, kh, c in ((8, 8, 256), (1, 2, 37), (2, 4, 4096), (8, 1, 1)):
        keys, n = tdec.split_plan(b, kh, c, g, hd, itemsize)
        assert keys >= 1 and (n - 1) * keys < c <= n * keys
        assert tdec.split_smem(g, hdp, itemsize, keys) <= tdec.SPLIT_SMEM
        need = tdec.MIN_SPLIT_KEYS * -(-tdec.SPLIT_CTAS // (b * kh))
        max_keys = ((tdec.SPLIT_SMEM - tdec.split_smem(g, hdp, itemsize, 0))
                    // (tdec.split_smem(g, hdp, itemsize, 1)
                        - tdec.split_smem(g, hdp, itemsize, 0)))
        if c >= need and max_keys >= tdec.MIN_SPLIT_KEYS:
            assert b * kh * n >= tdec.SPLIT_CTAS


# ---------------------------------------------------------------------------
# engine parity at LoRA rank 96 and head dim 96
# ---------------------------------------------------------------------------


def _wide_configs():
    def f32(cfg):
        return dataclasses.replace(
            cfg, dtype="float32", head_dim=96,
            lora=dataclasses.replace(cfg.lora, n_adapters=N_ADAPTERS,
                                     rank=96))
    return (f32(jax_reduced_config(jax_get_config("llama3-8b"))),
            f32(reduced_config(get_config("llama3-8b"))))


def test_engine_rank96_head_dim96_matches_reference_f32(monkeypatch):
    """Reduced Llama-3.1-8B at LoRA rank 96 and head dim 96 (neither a
    width of today's configs): the port's engine against the reference's
    on the same numpy weights and adapters, each under its own fake
    timer. Equal token streams, step counters and whole summaries."""
    jcfg, tcfg = _wide_configs()
    assert tcfg.resolved_head_dim == 96 and tcfg.lora.rank == 96
    jm = jax_build_model(jcfg)
    params = _numpy_tree(jax.eval_shape(jm.init, jax.random.PRNGKey(0)),
                         np.random.default_rng(0), _param)
    lora_shapes = jax.eval_shape(jm.init_lora, jax.random.PRNGKey(0))
    adapters = {aid: _numpy_tree(lora_shapes,
                                 np.random.default_rng(100 + aid),
                                 _adapter(jcfg.lora.rank))
                for aid in range(N_ADAPTERS)}

    def jax_adapter(self, aid):
        return jax.tree.map(jnp.asarray, adapters[aid])

    monkeypatch.setattr(jax_engine.EdgeLoRAEngine, "_adapter_host",
                        jax_adapter)
    jeng = jax_engine.EdgeLoRAEngine(
        jcfg, jax_engine.EngineConfig(**_engine_kwargs(jcfg, "edgelora")),
        params=jax.tree.map(jnp.asarray, params))
    monkeypatch.setattr("repro.serving.engine.time", _FakeTime())
    jtrace = _trace(jax_workload, jcfg)
    jsum = jeng.serve(jtrace)

    teng = EdgeLoRAEngine(
        tcfg, EngineConfig(**_engine_kwargs(tcfg, "edgelora")),
        params=bridge.tree_from_numpy(params), device="cpu",
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(
            adapters[aid]),
        timer=_FakeTime())
    ttrace = _trace(workload, tcfg)
    tsum = teng.serve(ttrace)

    assert jsum.n_completed == jsum.n_requests == len(jtrace) >= 8
    assert jsum.adapter_loads > 0 and jsum.decode_steps > 0
    assert (jsum.prefill_steps, jsum.decode_steps) == (tsum.prefill_steps,
                                                       tsum.decode_steps)
    for a, b in zip(jtrace, ttrace):
        assert a.tokens == b.tokens, a.request_id
    assert _summary_json(jsum) == _summary_json(tsum)
