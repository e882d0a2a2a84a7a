"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the ``repro`` package, so it also runs on a
machine with PyTorch and the CUDA toolkit alone; ``tests/conftest.py``
imports JAX, so run it there without the conftest::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, paged_gather, sgmv  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_plain(dev, dtype):
    """SGMV shrink and expand on a ragged problem (d_in and d_out not
    multiples of the tiles), f32 outputs within 1e-5 of max|ref|."""
    gen = torch.Generator(device=dev).manual_seed(0)
    t, d_in, d_out, r, n_slots = 40, 1000, 333, 32, 5
    x = torch.randn(t, d_in, generator=gen, device=dev).to(dtype)
    a = torch.randn(n_slots, r, d_in, generator=gen, device=dev)
    b = torch.randn(n_slots, d_out, r, generator=gen, device=dev)
    slots = torch.randint(0, n_slots, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
    blk_t = ops.auto_blk_t(t, n_slots)
    plan = ops.plan_grouping(slots, n_slots, blk_t)
    xbuf = x.new_zeros((plan.n_padded, d_in))
    xbuf[plan.padded_pos.long()] = x[plan.perm]
    s = sgmv.sgmv_shrink(xbuf, a, plan.block_slots, blk_t=blk_t)
    y = sgmv.sgmv_expand(s, b, plan.block_slots, blk_t=blk_t,
                         compute_dtype=dtype)
    s_ref = sgmv.shrink_plain(xbuf, a, plan.block_slots, blk_t=blk_t)
    y_ref = sgmv.expand_plain(s, b, plan.block_slots, blk_t=blk_t,
                              compute_dtype=dtype)
    torch.cuda.synchronize()
    for got, want in ((s, s_ref), (y, y_ref)):
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err < 1e-5, err


def _sgmv_problem(dev, dtype, blk_t, r, d_in, d_out, nb=6, n_slots=5,
                  seed=0):
    """A padded buffer of ``nb`` blocks whose every row is nonzero (so
    zeros past ``n_used`` show that the kernels did not read them), f32
    pool, random block slots."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(nb * blk_t, d_in, generator=gen, device=dev).to(dtype)
    s = torch.randn(nb * blk_t, r, generator=gen, device=dev)
    a = torch.randn(n_slots, r, d_in, generator=gen, device=dev)
    b = torch.randn(n_slots, d_out, r, generator=gen, device=dev)
    bs = torch.randint(0, n_slots, (nb,), generator=gen, device=dev,
                       dtype=torch.int32)
    return x, s, a, b, bs


def _sgmv_close(got, want):
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("used", ["below", "at", "absent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [4, 16, 32, 64])
@pytest.mark.parametrize("blk_t", [8, 16, 32, 128])
def test_cuda_sgmv_kernels_match_plain_sweep(dev, blk_t, r, dtype, used):
    """Both kernels against their plain versions, ragged d_in / d_out
    (1000 and 333 against the 64-column shrink tile and the 128-column
    expand tile), with ``n_used`` below the block count (the rows past it
    must come out zero), at it, and absent. Within 1e-5 of max|plain|."""
    nb = 6
    x, s, a, b, bs = _sgmv_problem(dev, dtype, blk_t, r, 1000, 333, nb=nb)
    n_used = {"below": torch.tensor(nb - 2, dtype=torch.int32, device=dev),
              "at": torch.tensor(nb, dtype=torch.int32, device=dev),
              "absent": None}[used]
    got_s = sgmv.sgmv_shrink(x, a, bs, blk_t=blk_t, n_used=n_used)
    got_y = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                             n_used=n_used)
    want_s = sgmv.shrink_plain(x, a, bs, blk_t=blk_t, n_used=n_used)
    want_y = sgmv.expand_plain(s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                               n_used=n_used)
    torch.cuda.synchronize()
    _sgmv_close(got_s, want_s)
    _sgmv_close(got_y, want_y)
    if used == "below":
        assert not got_s[(nb - 2) * blk_t:].any()
        assert not got_y[(nb - 2) * blk_t:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d_in,d_out,blk_t", [
    (7, 333, 1000, 8),      # r % 4 != 0, odd d_in: element-wise loads
    (20, 4096, 4096, 8),    # two rank tiles, the second part-filled
    (48, 333, 77, 12),      # blk_t not a multiple of 8, d_out < 128
])
def test_cuda_sgmv_unaligned_shapes(dev, dtype, r, d_in, d_out, blk_t):
    x, s, a, b, bs = _sgmv_problem(dev, dtype, blk_t, r, d_in, d_out,
                                   seed=1)
    n_used = torch.tensor(4, dtype=torch.int32, device=dev)
    for n in (n_used, None):
        _sgmv_close(sgmv.sgmv_shrink(x, a, bs, blk_t=blk_t, n_used=n),
                    sgmv.shrink_plain(x, a, bs, blk_t=blk_t, n_used=n))
        _sgmv_close(sgmv.sgmv_expand(s, b, bs, blk_t=blk_t,
                                     compute_dtype=dtype, n_used=n),
                    sgmv.expand_plain(s, b, bs, blk_t=blk_t,
                                      compute_dtype=dtype, n_used=n))


@pytest.mark.cuda
@pytest.mark.parametrize("n_used,nb,d_in", [
    (8, 21, 4096),      # decode: 33 splits per used block, merged
    (600, 620, 128),    # more used blocks than CTAs: each CTA loops
    (1, 21, 14336),     # one block split over the whole grid
    (0, 21, 4096),      # no tokens: all zeros
])
def test_cuda_sgmv_shrink_split_and_merge(dev, n_used, nb, d_in):
    """The device-side work split at its extremes; the arrival counters
    are back at zero after the call; two calls are bit-equal."""
    x, _, a, _, bs = _sgmv_problem(dev, torch.bfloat16, 8, 32, d_in, 16,
                                   nb=nb, n_slots=20, seed=2)
    nu = torch.tensor(n_used, dtype=torch.int32, device=dev)
    got = sgmv.sgmv_shrink(x, a, bs, blk_t=8, n_used=nu)
    again = sgmv.sgmv_shrink(x, a, bs, blk_t=8, n_used=nu)
    want = sgmv.shrink_plain(x, a, bs, blk_t=8, n_used=nu)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    if n_used:
        _sgmv_close(got, want)
    assert not got.any() if n_used == 0 else not got[n_used * 8:].any()
    for arrived, _ in sgmv._SCRATCH.values():
        assert not arrived.any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sgmv_repeats_are_bit_equal(dev, dtype):
    """Decode and prefill shapes of the main path: the split partials are
    merged in split order, so two calls give the same bits."""
    for t, d_in, d_out in ((8, 4096, 4096), (512, 14336, 4096)):
        gen = torch.Generator(device=dev).manual_seed(t)
        x = torch.randn(t, d_in, generator=gen, device=dev).to(dtype)
        a = torch.randn(20, 32, d_in, generator=gen, device=dev)
        b = torch.randn(20, d_out, 32, generator=gen, device=dev)
        slots = torch.randint(0, 20, (t,), generator=gen, device=dev,
                              dtype=torch.int32)
        blk_t = ops.auto_blk_t(t, 20)
        plan = ops.plan_grouping(slots, 20, blk_t)
        xbuf = x.new_zeros((plan.n_padded, d_in))
        xbuf[plan.padded_pos.long()] = x[plan.perm]
        outs = [sgmv.sgmv_shrink(xbuf, a, plan.block_slots, blk_t=blk_t,
                                 n_used=plan.n_used) for _ in range(2)]
        ys = [sgmv.sgmv_expand(outs[0], b, plan.block_slots, blk_t=blk_t,
                               compute_dtype=dtype, n_used=plan.n_used)
              for _ in range(2)]
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]) and torch.equal(ys[0], ys[1])


@pytest.mark.cuda
@pytest.mark.parametrize("t", [8, 256])
def test_cuda_ops_sgmv_makes_no_host_sync(dev, t):
    """``ops.sgmv`` at the decode shape (8 rows) and a prefill group's (256
    rows), and the LoRA layer's flatten of [B, S, d] around it, under
    ``torch.cuda.set_sync_debug_mode("error")``: any device-to-host sync
    raises. One launch of each kernel per call."""
    from repro_torch.core.lora import lora_delta_batched
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(t, 4096, generator=gen, device=dev).to(torch.bfloat16)
    a = torch.randn(20, 32, 4096, generator=gen, device=dev)
    b = torch.randn(20, 1024, 32, generator=gen, device=dev)
    slots = torch.randint(0, 20, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
    rows = slots[:8]
    x3 = x.reshape(8, t // 8, 4096)

    def run():
        y = ops.sgmv(x, a, b, slots, 0.5, n_slots=20, blk_t=None)
        d = lora_delta_batched(x3, a, b, rows, 0.5, backend="sgmv")
        return y, d

    want = run()                    # warm: build, bind, size the grid
    torch.cuda.synchronize()
    sgmv.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # the mode sees the sync that plan_grouping used to make
        with pytest.raises(RuntimeError):
            torch.bincount(slots.long(), minlength=20)
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert sgmv.launches == {"sgmv_shrink": 2, "sgmv_expand": 2}
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_cuda_decode_step_makes_no_host_sync(dev):
    """One bf16 decode step of the reduced Llama with per-row adapters
    through the SGMV kernels and attention through ``flash_decode``, under
    ``torch.cuda.set_sync_debug_mode("error")``: neither the LoRA path nor
    the rest of the step (RoPE's frequencies included) waits on the card.
    Same logits as the step run without the mode."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                              dtype="bfloat16")
    model = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = model.init(gen)
    pool = model.init_lora(gen, n_slots=4)
    for mods in pool["layers"].values():
        for pair in mods.values():
            pair["B"].normal_(0.0, 0.01, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (3,), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.tensor([5, 0, 11], dtype=torch.int32, device=dev)
    mode = LoRAMode("batched", torch.tensor([2, 0, 2], dtype=torch.int32,
                                            device=dev), 0.5, "sgmv")

    def step():
        cache = model.init_cache(3, 16)
        return model.decode_step(params, tokens, cache, pos, pool, mode)[0]

    want = step()
    torch.cuda.synchronize()
    sgmv.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    n_lora = cfg.n_layers * len(cfg.lora.target_modules)
    assert sgmv.launches == {"sgmv_shrink": n_lora, "sgmv_expand": n_lora}
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_sgmv_counts_one_launch_per_call(dev):
    x, s, a, b, bs = _sgmv_problem(dev, torch.bfloat16, 8, 32, 256, 128)
    sgmv.reset_launches()
    sgmv.sgmv_shrink(x, a, bs, blk_t=8)
    assert sgmv.launches == {"sgmv_shrink": 1, "sgmv_expand": 0}
    sgmv.sgmv_expand(s, b, bs, blk_t=8, compute_dtype=torch.bfloat16)
    assert sgmv.launches == {"sgmv_shrink": 1, "sgmv_expand": 1}
    sgmv.shrink_plain(x, a, bs, blk_t=8)
    sgmv.expand_plain(s, b, bs, blk_t=8, compute_dtype=torch.bfloat16)
    assert sgmv.launches == {"sgmv_shrink": 1, "sgmv_expand": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("bs,f", [(16, 1024), (5, 3)])
def test_cuda_paged_gather_matches_plain(dev, dtype, bs, f):
    """The page gather against its plain version: a copy, so bit-equal,
    for any element type; tables mix shuffled pages, repeats and -1 (the
    trash page), and 5·3-element pages (15 to 60 bytes) take the
    narrow-vector paths. The launch counter counts the launch."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ng, n_pages, b, mb = 3, 13, 8, 17
    arena = torch.randn(ng, n_pages, bs, f, generator=gen,
                        device=dev).mul_(40).to(dtype)
    tables = torch.full((b, mb), -1, dtype=torch.int32, device=dev)
    tables[0, :9] = torch.randperm(n_pages, generator=gen,
                                   device=dev)[:9].int()
    tables[1, :4] = torch.tensor([5, 5, 0, 12], dtype=torch.int32)
    tables[3, :mb] = torch.arange(mb, dtype=torch.int32) % n_pages
    paged_gather.reset_launches()
    got = paged_gather.paged_gather_pages(arena, tables)
    want = paged_gather.paged_gather_pages_plain(arena.cpu(), tables.cpu())
    torch.cuda.synchronize()
    assert paged_gather.launches == {"paged_gather_pages": 1}
    assert got.shape == (ng, b, mb * bs, f) and got.dtype == dtype
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got[:, 2].cpu(), arena[:, -1:].expand(
        ng, mb, bs, f).reshape(ng, mb * bs, f).cpu())


@pytest.mark.cuda
def test_cuda_paged_gather_ops_route_restores_trailing_dims(dev):
    """``ops.paged_gather`` flattens [KH, hd] into F for the kernel and
    restores it; both routes agree bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(2)
    arena = torch.randn(2, 9, 4, 8, 128, generator=gen,
                        device=dev).to(torch.bfloat16)
    tables = torch.tensor([[3, 1, -1], [8, 8, 0]], dtype=torch.int32,
                          device=dev)
    got = ops.paged_gather(arena, tables, use_kernel=True)
    want = ops.paged_gather(arena, tables, use_kernel=False)
    torch.cuda.synchronize()
    assert got.shape == (2, 2, 12, 8, 128) and torch.equal(got, want)


# ---------------------------------------------------------------------------
# attention kernels
# ---------------------------------------------------------------------------

# kernel vs plain: both in f32 in different orders (1e-5 of max|plain|); a
# bf16 output may differ by one rounding step, 2^-8 of its value (1e-2)
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}


def _attn_close(got, want, dtype):
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    assert torch.isfinite(got.float()).all()
    assert err <= ATTN_TOL[dtype] * scale, (err, scale)


# (b, h, kh, hd, c, window, chunked, softcap): the reference's sweep, then
# a ragged ring (c not a multiple of the tile), head dims 128 and 256
DECODE_SHAPES = [
    (2, 8, 2, 64, 128, None, False, None),
    (1, 4, 4, 32, 64, None, False, 50.0),
    (3, 8, 2, 64, 256, 64, False, None),
    (2, 4, 1, 64, 128, 32, True, None),
    (3, 8, 2, 64, 100, None, False, None),
    (2, 32, 8, 128, 257, None, False, None),
    (2, 16, 2, 256, 37, 16, False, 30.0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,hd,c,window,chunked,softcap", DECODE_SHAPES)
def test_cuda_flash_decode_matches_plain(dev, dtype, b, h, kh, hd, c, window,
                                         chunked, softcap):
    """Per-row positions: a wrapped ring, part-filled rings, and (b > 1) a
    fully empty last row (all -1: the mean of V over the ring)."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, c, kh, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, c, kh, hd, generator=gen, device=dev).to(dtype)
    idx = torch.arange(c, device=dev, dtype=torch.int32)
    kv_pos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    kv_pos[0] = idx + c                       # position p at ring index p % c
    kv_pos[1:b - 1] = torch.where(idx < c // 2, idx, -1)
    q_pos = torch.tensor([2 * c - 1] + [c // 2 - 1] * max(b - 2, 0)
                         + [3] * (b > 1), dtype=torch.int32, device=dev)
    kw = dict(window=window, chunked=chunked, softcap=softcap)
    da.reset_launches()
    got = da.flash_decode(q, k, v, kv_pos, q_pos, **kw)
    want = da.flash_decode_plain(q, k, v, kv_pos, q_pos, **kw)
    torch.cuda.synchronize()
    assert da.launches == {"flash_decode": 1}
    assert got.shape == q.shape and got.dtype == dtype
    _attn_close(got, want, dtype)
    if b > 1:
        empty = v[-1].float().mean(0).repeat_interleave(h // kh, 0)
        _attn_close(got[-1], empty, dtype)                      # [h, hd]
    # a scalar q_pos is every row's position
    _attn_close(da.flash_decode(q, k, v, kv_pos, c - 3, **kw),
                da.flash_decode_plain(q, k, v, kv_pos, c - 3, **kw), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_decode_int8_matches_plain(dev, qdtype):
    """int8 K/V with per-(token, head) scales, dequantised in the tile."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(4)
    b, h, kh, hd, c = 3, 8, 2, 128, 200
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(qdtype)
    kq = torch.randint(-127, 128, (b, c, kh, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    vq = torch.randint(-127, 128, (b, c, kh, hd), generator=gen, device=dev,
                       dtype=torch.int8)
    ks = torch.rand(b, c, kh, generator=gen, device=dev) / 127
    vs = torch.rand(b, c, kh, generator=gen, device=dev) / 127
    kv_pos = torch.arange(c, dtype=torch.int32, device=dev).expand(
        b, c).contiguous()
    kv_pos[2] = -1
    q_pos = torch.tensor([c - 1, c // 3, 0], dtype=torch.int32, device=dev)
    got = da.flash_decode(q, kq, vq, kv_pos, q_pos, k_scale=ks, v_scale=vs)
    want = da.flash_decode_plain(q, kq, vq, kv_pos, q_pos, k_scale=ks,
                                 v_scale=vs)
    torch.cuda.synchronize()
    _attn_close(got, want, qdtype)


_KV_TYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.int8), (torch.bfloat16, torch.int8)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype,kvdtype", _KV_TYPES)
@pytest.mark.parametrize("c", [20, 300])
def test_cuda_flash_decode_splits_match_plain(dev, qdtype, kvdtype, c):
    """The ring split across CTAs (c 20: smaller than one split; c 300: ten
    splits of 32, the last ragged): a row whose only keys lie in the last
    split, a row with no key in any split (the mean of V over all of
    them), a row whose first split is empty, a full row."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(8)
    b, h, kh, hd = 4, 8, 2, 64
    itemsize = torch.empty(0, dtype=kvdtype).element_size()
    keys, n_splits = da.split_plan(b, kh, c, h // kh, hd, itemsize)
    assert (n_splits == 1) if c == 20 else (n_splits > 1 and c % keys)
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(qdtype)
    scales = {}
    if kvdtype == torch.int8:
        k, v = (torch.randint(-127, 128, (b, c, kh, hd), generator=gen,
                              device=dev, dtype=torch.int8) for _ in "kv")
        scales = {n: torch.rand(b, c, kh, generator=gen, device=dev) / 127
                  for n in ("k_scale", "v_scale")}
    else:
        k, v = (torch.randn(b, c, kh, hd, generator=gen, device=dev).to(
            kvdtype) for _ in "kv")
    q_pos = c + 10
    kv_pos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    kv_pos[0, -3:] = torch.tensor([c + 8, c + 9, c + 10], dtype=torch.int32)
    kv_pos[1] = c + 11 + torch.arange(c, dtype=torch.int32)     # all future
    kv_pos[2, keys:] = torch.arange(keys, c, dtype=torch.int32)
    kv_pos[3] = torch.arange(c, dtype=torch.int32)
    got = da.flash_decode(q, k, v, kv_pos, q_pos, **scales)
    want = da.flash_decode_plain(q, k, v, kv_pos, q_pos, **scales)
    torch.cuda.synchronize()
    _attn_close(got, want, qdtype)
    vf = v.float() * (scales["v_scale"][..., None] if scales else 1.0)
    _attn_close(got[1], vf[1].mean(0).repeat_interleave(h // kh, 0), qdtype)


@pytest.mark.cuda
def test_cuda_flash_decode_is_deterministic(dev):
    """The splits merge in a fixed order, without atomics: two calls at the
    main path's shape give bit-equal outputs."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(9)
    b, h, kh, hd, c = 8, 32, 8, 128, 256
    assert da.split_plan(b, kh, c, h // kh, hd, 2)[1] > 1
    q = torch.randn(b, h, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, c, kh, hd, generator=gen, device=dev).bfloat16()
            for _ in "kv")
    kv_pos = torch.arange(c, dtype=torch.int32, device=dev).expand(
        b, c).contiguous()
    q_pos = torch.arange(b, dtype=torch.int32, device=dev) * 37
    first = da.flash_decode(q, k, v, kv_pos, q_pos)
    second = da.flash_decode(q, k, v, kv_pos, q_pos)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _attn_close(first, da.flash_decode_plain(q, k, v, kv_pos, q_pos),
                torch.bfloat16)


@pytest.mark.cuda
def test_cuda_flash_decode_reads_in_place_cache_write(dev):
    """``cache_update`` writes the ring in place on the current stream and
    the kernel, launched on the same stream, reads the new entry."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import attention as attn
    gen = torch.Generator(device=dev).manual_seed(5)
    b, h, kh, hd, c = 4, 8, 2, 64, 64
    cache = attn.init_kv_cache(b, c, kh, hd, torch.bfloat16, device=dev)
    pos = torch.tensor([0, 5, 63, 64], dtype=torch.int32, device=dev)
    for step in range(3):
        k_new = torch.randn(b, 1, kh, hd, generator=gen, device=dev)
        v_new = 100 * torch.randn(b, 1, kh, hd, generator=gen, device=dev)
        attn.cache_update(cache, k_new, v_new, pos + step)
        q = torch.randn(b, h, hd, generator=gen, device=dev).bfloat16()
        got = da.flash_decode(q, cache["k"], cache["v"], cache["pos"],
                              pos + step)
        want = da.flash_decode_plain(q.cpu(), cache["k"].cpu(),
                                     cache["v"].cpu(), cache["pos"].cpu(),
                                     (pos + step).cpu())
        torch.cuda.synchronize()
        _attn_close(got.cpu(), want, torch.bfloat16)


# (b, sq, skv, h, kh, hd, offset, window, chunked, softcap): the reference's
# four masks, GQA g = 4, ragged Sq and Skv, head dim 256, and suffix shapes
# (queries at offset.. over offset + sq keys)
PREFILL_SHAPES = [
    (2, 64, 64, 4, 2, 32, 0, None, False, None),
    (2, 64, 64, 4, 2, 32, 0, 16, False, None),
    (2, 64, 64, 4, 2, 32, 0, 16, True, None),
    (2, 64, 64, 4, 2, 32, 0, None, False, 30.0),
    (1, 37, 37, 8, 2, 64, 0, None, False, None),
    (2, 45, 45, 32, 8, 128, 0, None, False, None),
    (1, 19, 19, 4, 1, 256, 0, 8, False, None),
    (2, 32, 96, 32, 8, 128, 64, None, False, None),
    (1, 7, 57, 4, 4, 64, 50, 16, True, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kh,hd,offset,window,chunked,softcap",
                         PREFILL_SHAPES)
def test_cuda_flash_prefill_matches_plain(dev, dtype, b, sq, skv, h, kh, hd,
                                          offset, window, chunked, softcap):
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(6)
    q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, kh, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, kh, hd, generator=gen, device=dev).to(dtype)
    kw = dict(window=window, chunked=chunked, softcap=softcap)
    if offset:
        kw.update(qpos=torch.arange(offset, offset + sq, dtype=torch.int32,
                                    device=dev),
                  kpos=torch.arange(skv, dtype=torch.int32, device=dev))
    fp.reset_launches()
    got = fp.flash_prefill(q, k, v, **kw)
    want = fp.flash_prefill_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fp.launches == {"flash_prefill": 1}
    assert got.shape == q.shape and got.dtype == dtype
    _attn_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_prefill_rows_without_keys(dev, dtype):
    """Rows that see no key (positions before every key, an empty entry)
    are the mean of V over all Skv entries, in a q tile where other rows
    do see keys, so masked KV tiles are not skipped for them; a non-causal
    call sees every non-empty key."""
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(7)
    b, sq, skv, h, kh, hd = 2, 40, 70, 4, 2, 128
    q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, kh, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, kh, hd, generator=gen, device=dev).to(dtype)
    qpos = torch.arange(sq, dtype=torch.int32, device=dev) * 3 - 20
    kpos = torch.arange(skv, dtype=torch.int32, device=dev) + 10
    kpos[5] = -1
    for causal in (True, False):
        got = fp.flash_prefill(q, k, v, qpos=qpos, kpos=kpos, causal=causal)
        want = fp.flash_prefill_plain(q, k, v, qpos=qpos, kpos=kpos,
                                      causal=causal)
        torch.cuda.synchronize()
        _attn_close(got, want, dtype)
    got = fp.flash_prefill(q, k, v, qpos=qpos, kpos=kpos)
    mean = v.float().mean(1).repeat_interleave(h // kh, 1)     # [b, h, hd]
    _attn_close(got[:, 0], mean, dtype)                        # qpos -20


@pytest.mark.cuda
def test_cuda_model_kernel_route_matches_plain_route(dev):
    """The reduced Llama in f32 on the card: prefill and two decode steps
    with the attention kernels against the plain attention code, within
    1e-4 of max|logit|; every layer launches each kernel once per step."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                              dtype="float32")
    plain = build_model(cfg, dev)
    params = plain.init(torch.Generator(device=dev).manual_seed(0))
    kern = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (3, 16), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([16, 9, 5], dtype=torch.int32, device=dev)
    logits = {}
    da.reset_launches()
    fp.reset_launches()
    for name, m in (("plain", plain), ("kernel", kern)):
        lp, cache = m.prefill(params, {"tokens": tokens},
                              m.init_cache(3, 32), lengths=lengths)
        out = [lp]
        nxt, pos = torch.argmax(lp, -1).int(), lengths.clone()
        for _ in range(2):
            ld, cache = m.decode_step(params, nxt, cache, pos)
            out.append(ld)
            nxt, pos = torch.argmax(ld, -1).int(), pos + 1
        logits[name] = out
    torch.cuda.synchronize()
    assert fp.launches == {"flash_prefill": cfg.n_layers}
    assert da.launches == {"flash_decode": 2 * cfg.n_layers}
    for got, want in zip(logits["kernel"], logits["plain"]):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3, 4, 8])
def test_cuda_flash_prefill_packs_gqa_rows(dev, g):
    """bf16 on the tensor cores: a CTA's 64 rows are (position, head)
    pairs of one kv group, so its tile spans 64 / g positions (with g 3 a
    position's heads straddle two CTAs); Sq 37 is no multiple of any tile,
    and causal masking differs row by row within a tile."""
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(10)
    b, sq, kh, hd = 2, 37, 2, 64
    q = torch.randn(b, sq, g * kh, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, sq, kh, hd, generator=gen, device=dev).bfloat16()
            for _ in "kv")
    got = fp.flash_prefill(q, k, v)
    want = fp.flash_prefill_plain(q, k, v)
    torch.cuda.synchronize()
    _attn_close(got, want, torch.bfloat16)


# (hd, sq, skv, offset, window, chunked): every head dim with Sq not a
# multiple of the 16-position tile and with the suffix shape (32 over 96);
# then several K/V tiles, double-buffered, with masked tiles skipped
TC_SHAPES = [(hd, sq, skv, off, None, False) for hd in (32, 64, 128, 256)
             for sq, skv, off in ((45, 45, 0), (32, 96, 64))] + [
    (128, 300, 300, 0, 40, False), (64, 200, 260, 60, 50, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("hd,sq,skv,offset,window,chunked", TC_SHAPES)
def test_cuda_flash_prefill_tensor_core_shapes(dev, hd, sq, skv, offset,
                                               window, chunked):
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(11)
    b, h, kh = 2, 8, 2
    q = torch.randn(b, sq, h, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, skv, kh, hd, generator=gen, device=dev).bfloat16()
            for _ in "kv")
    kw = dict(window=window, chunked=chunked)
    if offset:
        kw.update(qpos=torch.arange(offset, offset + sq, dtype=torch.int32,
                                    device=dev),
                  kpos=torch.arange(skv, dtype=torch.int32, device=dev))
    got = fp.flash_prefill(q, k, v, **kw)
    want = fp.flash_prefill_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _attn_close(got, want, torch.bfloat16)
