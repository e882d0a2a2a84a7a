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


def _gather_twice(arena, tables):
    """Two kernel calls (bit-equal to each other, one launch counted
    each); returns the first call's output and the plan it followed."""
    paged_gather.reset_launches()
    got = paged_gather.paged_gather_pages(arena, tables)
    again = paged_gather.paged_gather_pages(arena, tables)
    torch.cuda.synchronize()
    assert paged_gather.launches == {"paged_gather_pages": 2}
    assert torch.equal(got, again)
    plan = paged_gather.gather_plan(
        arena[0, 0].numel() * arena.element_size(),
        arena.shape[0] * tables.numel(), arena.data_ptr(), got.data_ptr())
    return got, plan


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8])
@pytest.mark.parametrize("bs,f", [(16, 1024), (5, 3), (1, 16388), (1, 8)])
def test_cuda_paged_gather_matches_plain(dev, dtype, bs, f):
    """The page gather against its plain version: a copy, so bit-equal,
    for any element type; tables mix shuffled pages, repeats, -1 (the
    trash page) and entries past either end. Pages of 16 KiB-64 KiB
    (16·1024 elements: 16-byte vectors, several CTAs a page), 15 to 60
    bytes (5·3: 1- and 4-byte vectors, several pages a CTA), 64 KiB + 16
    bytes (1·16388 f32; 32 KiB + 8 bf16, 16 KiB + 4 int8: 16-, 8- and
    4-byte vectors, blocks straddling pages) and 8 to 32 bytes (1·8).
    Two calls are bit-equal, each counts one launch."""
    gen = torch.Generator(device=dev).manual_seed(1)
    ng, n_pages, b, mb = 3, 13, 8, 17
    arena = torch.randn(ng, n_pages, bs, f, generator=gen,
                        device=dev).mul_(40).to(dtype)
    tables = torch.full((b, mb), -1, dtype=torch.int32, device=dev)
    tables[0, :9] = torch.randperm(n_pages, generator=gen,
                                   device=dev)[:9].int()
    tables[1, :4] = torch.tensor([5, 5, 0, 12], dtype=torch.int32)
    tables[3, :mb] = torch.arange(mb, dtype=torch.int32) % n_pages
    tables[4, :3] = torch.tensor([n_pages, 2 * n_pages + 3, -n_pages - 2],
                                 dtype=torch.int32)
    got, plan = _gather_twice(arena, tables)
    pb = bs * f * arena.element_size()
    assert plan.vec_bytes == min(16, pb & -pb)
    want = paged_gather.paged_gather_pages_plain(arena.cpu(), tables.cpu())
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


# ---------------------------------------------------------------------------
# the shapes of qwen2-0.5b, llama3.2-3b and openelm-1.1b
# ---------------------------------------------------------------------------

# (g, kh, hd): qwen2-0.5b (14 heads over 2, hd 64: a 64-row tile of
# (position, head) pairs splits a position's 7 heads across CTAs),
# llama3.2-3b (24 over 8, hd 128), openelm-1.1b (16 over 4, hd 128),
# dbrx-132b (48 over 8), llama4-maverick (40 over 8)
NEW_GQA = [(7, 2, 64), (3, 8, 128), (4, 4, 128), (6, 8, 128), (5, 8, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,kh,hd", NEW_GQA)
def test_cuda_flash_prefill_new_gqa_groups(dev, dtype, g, kh, hd):
    """A full prefill group (8 x 64 causal), a ragged one (Sq 37) and a
    suffix step (32 queries over 64 cached + 32 fresh keys)."""
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(12)
    for b, sq, offset in ((8, 64, 0), (2, 37, 0), (4, 32, 64)):
        skv = offset + sq
        q = torch.randn(b, sq, g * kh, hd, generator=gen,
                        device=dev).to(dtype)
        k, v = (torch.randn(b, skv, kh, hd, generator=gen,
                            device=dev).to(dtype) for _ in "kv")
        kw = {}
        if offset:
            kw = dict(qpos=torch.arange(offset, skv, dtype=torch.int32,
                                        device=dev),
                      kpos=torch.arange(skv, dtype=torch.int32, device=dev))
        got = fp.flash_prefill(q, k, v, **kw)
        want = fp.flash_prefill_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        _attn_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("g,kh,hd", NEW_GQA)
def test_cuda_flash_decode_new_gqa_groups(dev, dtype, g, kh, hd):
    """One decode step's layer: 8 rows over a 256-entry ring at depths
    17..300 (one wrapped) and an idle row (all -1: the mean of V)."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(13)
    b, c, h = 8, 256, g * kh
    depth = torch.tensor([256, 200, 128, 64, 33, 17, 300, 0],
                         dtype=torch.int32, device=dev)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    newest = (depth[:, None] - 1 - idx) // c * c + idx
    kv_pos = torch.where(newest >= 0, newest, -1).to(torch.int32)
    q_pos = (depth - 1).clamp_min(0)
    q = torch.randn(b, h, hd, generator=gen, device=dev).to(dtype)
    k, v = (torch.randn(b, c, kh, hd, generator=gen, device=dev).to(dtype)
            for _ in "kv")
    got = da.flash_decode(q, k, v, kv_pos, q_pos)
    want = da.flash_decode_plain(q, k, v, kv_pos, q_pos)
    torch.cuda.synchronize()
    _attn_close(got, want, dtype)
    _attn_close(got[-1], v[-1].float().mean(0).repeat_interleave(g, 0),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8, 64, 512])
@pytest.mark.parametrize("d_in,d_out", [(896, 128), (896, 896),
                                        (896, 4864), (4864, 896)])
def test_cuda_sgmv_rank16_qwen2_shapes(dev, dtype, t, d_in, d_out):
    """qwen2-0.5b's LoRA: rank 16 over a 32-slot pool, d_in 896 / 4864,
    d_out 128 (k, v), 896 and 4864, at the decode rows (8) and prefill
    groups (64, 512); the plan's ``n_used`` as the main path passes it.
    Each kernel within 1e-5 of max|plain|, ``ops.sgmv`` within the
    activation type's rounding of the reference oracle."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(14)
    r, n_pool = 16, 32
    x = torch.randn(t, d_in, generator=gen, device=dev).to(dtype)
    a = torch.randn(n_pool, r, d_in, generator=gen, device=dev) / r ** 0.5
    b = torch.randn(n_pool, d_out, r, generator=gen, device=dev) * 0.01
    slots = torch.randint(0, n_pool, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
    blk_t = ops.auto_blk_t(t, n_pool)
    plan = ops.plan_grouping(slots, n_pool, blk_t)
    xbuf = x.new_zeros((plan.n_padded, d_in))
    xbuf[plan.padded_pos.long()] = x[plan.perm]
    bs, nu = plan.block_slots, plan.n_used
    s = sgmv.sgmv_shrink(xbuf, a, bs, blk_t=blk_t, n_used=nu)
    _sgmv_close(s, sgmv.shrink_plain(xbuf, a, bs, blk_t=blk_t, n_used=nu))
    y = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                         n_used=nu)
    _sgmv_close(y, sgmv.expand_plain(s, b, bs, blk_t=blk_t,
                                     compute_dtype=dtype, n_used=nu))
    got = ops.sgmv(x, a, b, slots, 2.0, n_slots=n_pool, blk_t=None)
    want = (2.0 * ref.sgmv_ref(x, a.to(dtype), b.to(dtype), slots,
                               1.0)).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


def _captured_step(dev, policy, kv, step, arch="qwen2-0.5b", cfg_over=None,
                   **attn):
    """Serve a short trace on the reduced ``arch`` (bf16, the SGMV and
    attention kernels; ``cfg_over`` overrides ModelConfig fields, ``attn``
    its AttentionConfig) and capture the engine's first call of ``step``:
    (step function, its inputs and output tokens)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate_trace
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              **(cfg_over or {}))
    cfg = dataclasses.replace(cfg, dtype="bfloat16", attn=dataclasses.replace(
        cfg.attn, **attn))
    eng = EdgeLoRAEngine(cfg, EngineConfig(
        n_slots=4, max_ctx=64, prompt_buckets=(16, 32), policy=policy,
        kv_backend=kv, memory_budget=1e12, lora_backend="sgmv"), device=dev)
    fn, seen = getattr(eng, step), {}

    def keep(a):
        """A copy of the step's inputs (the caches are written in place)."""
        if isinstance(a, dict):
            return {k: keep(v) for k, v in a.items()}
        if isinstance(a, tuple):
            return tuple(keep(v) for v in a)
        return a.clone() if torch.is_tensor(a) else a

    def capture(*args, **kw):
        inputs = None if seen else keep(args)
        out = fn(*args, **kw)
        if inputs is not None:
            seen.update(args=inputs, kw=kw, tokens=out[0].clone())
        return out

    setattr(eng, step, capture)
    trace = generate_trace(WorkloadConfig(
        n_adapters=cfg.lora.n_adapters, request_rate=20.0, duration=0.5,
        input_range=(4, 30), output_range=(3, 6),
        vocab_size=cfg.vocab_size, seed=0))
    eng.serve(trace)
    assert seen, f"{step} never ran"
    return fn, seen


@pytest.mark.cuda
@pytest.mark.parametrize("policy,kv,step", [
    ("edgelora", "dense", "_prefill"),
    ("edgelora", "paged", "_prefill"),
    ("edgelora", "paged", "_decode_paged"),
    ("llamacpp", "dense", "_decode_merged"),
    ("llamacpp", "paged", "_decode_merged_paged"),
    ("llamacpp", "paged", "_prefill_merged"),
])
def test_cuda_engine_steps_make_no_host_sync(dev, policy, kv, step):
    """Whole engine steps on the card under
    ``torch.cuda.set_sync_debug_mode("error")``: a prefill step (the SGMV
    kernels and ``flash_prefill``), the paged decode step (with
    ``paged_gather_pages``) and the merged decode and prefill steps (no
    LoRA). The first call's inputs rerun under the mode give the same
    tokens; the merged steps launch no SGMV kernel."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_gather as pg
    fn, seen = _captured_step(dev, policy, kv, step)
    for mod in (sgmv, da, fp, pg):
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tokens, _ = fn(*seen["args"], **seen["kw"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(tokens, seen["tokens"])
    n = 2  # reduced config: two layers
    merged = "merged" in step
    assert sgmv.launches["sgmv_shrink"] == (0 if merged else 7 * n)
    attn = fp.launches["flash_prefill"] + da.launches["flash_decode"]
    assert attn == n
    assert pg.launches["paged_gather_pages"] == (
        2 if "decode" in step and kv == "paged" else 0)


# ---------------------------------------------------------------------------
# no silent gradients; the learned router's trunk on the kernel
# ---------------------------------------------------------------------------


def _grad_cases(dev):
    """(name, call) for every kernel wrapper, its first float input
    requiring grad."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    q4, k4 = randn(2, 16, 4, 64), randn(2, 16, 2, 64)
    q3, ring = randn(2, 4, 64), randn(2, 32, 2, 64)
    kv_pos = torch.arange(32, dtype=torch.int32, device=dev).repeat(2, 1)
    q_pos = torch.full((2,), 31, dtype=torch.int32, device=dev)
    x, s, a, b, bs = _sgmv_problem(dev, torch.bfloat16, 8, 16, 256, 128)
    arena = randn(2, 6, 16, 128)
    tables = torch.tensor([[0, 2], [5, -1]], dtype=torch.int32, device=dev)
    return [
        ("flash_prefill", lambda g: fp.flash_prefill(
            q4.requires_grad_(g), k4, k4)),
        ("flash_decode", lambda g: da.flash_decode(
            q3.requires_grad_(g), ring, ring, kv_pos, q_pos)),
        ("sgmv_shrink", lambda g: sgmv.sgmv_shrink(
            x.requires_grad_(g), a, bs, blk_t=8)),
        ("sgmv_expand", lambda g: sgmv.sgmv_expand(
            s, b.requires_grad_(g), bs, blk_t=8,
            compute_dtype=torch.bfloat16)),
        ("paged_gather_pages", lambda g: paged_gather.paged_gather_pages(
            arena.requires_grad_(g), tables)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("i", range(5))
def test_cuda_wrappers_refuse_grad(dev, i):
    """An input that requires grad, with autograd on: the wrapper raises
    (its output would carry no grad_fn) and launches nothing. Under
    ``no_grad`` or with no input requiring grad it launches once."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    name, call = _grad_cases(dev)[i]
    counts = {**sgmv.launches, **paged_gather.launches, **da.launches,
              **fp.launches}
    mods = (sgmv, paged_gather, da, fp)
    for m in mods:
        m.reset_launches()
    try:
        with pytest.raises(RuntimeError, match="requires grad"):
            call(True)
        assert all(n == 0 for m in mods for n in m.launches.values())
        with torch.no_grad():
            out = call(True)
        assert out.grad_fn is None
        call(False)
        torch.cuda.synchronize()
        launched = {k: n for m in mods for k, n in m.launches.items() if n}
        assert launched == {name: 2}
    finally:
        for m in mods:
            m.launches.update({k: counts[k] for k in m.launches})


@pytest.mark.cuda
def test_cuda_router_scores_kernel_matches_plain(dev):
    """``LearnedRouter.scores_batch`` at Llama-3.1-8B's width cut to two
    layers, bf16, fan-in-scaled random weights: the ``flash_prefill``
    route within 1e-2 of max|plain| of the plain attention route; one
    ``flash_prefill`` launch per layer per call and no SGMV launch."""
    from repro_torch.configs import get_config
    from repro_torch.core.router import LearnedRouter
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import build_model
    from repro_torch.training.router_train import init_router_head
    cfg = dataclasses.replace(get_config("llama3-8b"), n_layers=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    plain = build_model(cfg, dev)
    params = plain.init(gen)
    with torch.no_grad():
        for slot in params["layers"].values():
            for module in slot.values():
                for w in module.values():
                    if w.dim() == 3:
                        w.mul_((w.shape[0] / w.shape[-2]) ** 0.5)
    kern = build_model(cfg, dev, attn_kernel=True)
    kern.load_params(params)
    head = init_router_head(gen, cfg.d_model, 40)
    # w ~ N(0, 1/d) over unit-RMS features: logits of order one, so the
    # sigmoid does not saturate and hide a difference
    head["w"].mul_(1 / (0.02 * cfg.d_model ** 0.5))
    tokens = torch.randint(0, 4096, (8, 32), generator=gen, device=dev,
                           dtype=torch.int32)
    want = LearnedRouter(plain, params, head).scores_batch(tokens)
    fp.reset_launches()
    sgmv.reset_launches()
    got = LearnedRouter(kern, kern.params, head).scores_batch(tokens)
    assert fp.launches == {"flash_prefill": cfg.n_layers}
    assert set(sgmv.launches.values()) == {0}
    assert got.shape == want.shape == (8, 40)
    err = float(abs(got - want).max())
    assert err <= 1e-2 * float(abs(want).max()), err


# ---------------------------------------------------------------------------
# the dense attention variants at their models' shapes: gemma2-9b (hd 256,
# GQA 2, window 4096, softcap 50), starcoder2-7b (hd 128, GQA 9), the int8
# ring as the cache stores it (bf16 scales)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,kh,hd,softcap", [
    (2, 16, 8, 256, 50.0),       # gemma2-9b: the shared-memory q path
    (1, 36, 4, 128, None),       # starcoder2-7b: GQA 9
])
def test_cuda_flash_prefill_window_at_model_shapes(dev, b, h, kh, hd,
                                                   softcap):
    """A prompt of 4352 tokens past the 4096 window, bf16: the window
    cuts the first 256 queries' oldest keys."""
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(8)
    s = 4352
    q = torch.randn(b, s, h, hd, generator=gen, device=dev).bfloat16()
    k = torch.randn(b, s, kh, hd, generator=gen, device=dev).bfloat16()
    v = torch.randn(b, s, kh, hd, generator=gen, device=dev).bfloat16()
    kw = dict(window=4096, softcap=softcap)
    fp.reset_launches()
    got = fp.flash_prefill(q, k, v, **kw)
    want = fp.flash_prefill_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fp.launches == {"flash_prefill": 1}
    _attn_close(got, want, torch.bfloat16)
    # the window is real at this length: without it the late rows move
    full = fp.flash_prefill_plain(q[:, -8:], k, v, softcap=softcap,
                                  qpos=torch.arange(s - 8, s, device=dev),
                                  kpos=torch.arange(s, device=dev))
    assert (full.float() - want[:, -8:].float()).abs().max() > 1e-3


@pytest.mark.cuda
def test_cuda_flash_decode_int8_ring_with_bf16_scales(dev):
    """gemma2-9b's decode layer on an int8 ring as the cache holds it:
    int8 values, bf16 scales [B, C, KH] (cast to f32 by
    ``ops.decode_attention``), a wrapped 4096-entry local ring with a
    4096 window and softcap 50, hd 256, GQA 2; against the plain route."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models.attention import _quantize_kv
    gen = torch.Generator(device=dev).manual_seed(9)
    b, h, kh, hd, c = 4, 16, 8, 256, 4096
    q = torch.randn(b, h, hd, generator=gen, device=dev).bfloat16()
    kq, ks = _quantize_kv(torch.randn(b, c, kh, hd, generator=gen,
                                      device=dev))
    vq, vs = _quantize_kv(torch.randn(b, c, kh, hd, generator=gen,
                                      device=dev))
    ks, vs = ks.bfloat16(), vs.bfloat16()
    depth = torch.tensor([4300, 4096, 1000, 0], dtype=torch.int32,
                         device=dev)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    newest = (depth[:, None] - 1 - idx) // c * c + idx
    kv_pos = torch.where(newest >= 0, newest, -1).to(torch.int32)
    q_pos = (depth - 1).clamp_min(0)
    kw = dict(k_scale=ks, v_scale=vs, window=4096, softcap=50.0)
    da.reset_launches()
    got = ops.decode_attention(q, kq, vq, kv_pos, q_pos, **kw)
    want = ops.decode_attention(q, kq, vq, kv_pos, q_pos, use_kernel=False,
                                **kw)
    torch.cuda.synchronize()
    assert da.launches == {"flash_decode": 1}
    _attn_close(got, want, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["gemma2_reduced", "scale_48552",
                                  "offset_2", "offset_8", "over_2gib",
                                  "out_over_2p32"])
def test_cuda_paged_gather_int8_and_scale_pages(dev, case):
    """The page gather on an int8 K arena [ng, pages, bs, KH, hd] and its
    bf16 scale arena [ng, pages, bs, KH] (16-byte rows at KH 8, 256-byte
    pages), through ``ops.paged_gather``: bit-equal to the indexing
    route, two calls bit-equal and one launch counted each. Cases: a
    reduced gemma2 (``gemma2_reduced``); the scale leaf at gemma2-9b's
    paged step, 21 groups x 8 rows x 289 entries = 48,552 output pages
    of 256 bytes (``scale_48552``); an int8 K arena that starts 2 or 8
    bytes into a larger buffer (``offset_*``: 2- and 8-byte vectors); a
    64 KiB-page arena over 2^31 bytes whose tables name its last pages
    (``over_2gib``); an output of 65,537 odd-sized int8 pages of 65,537
    bytes, past 2^32 one-byte vectors, where the kernel's index split
    leaves 32 bits (``out_over_2p32``)."""
    gen = torch.Generator(device=dev).manual_seed(10)
    tables = torch.tensor([[3, 7, 1, -1], [19, 0, -1, -1], [-1] * 4],
                          dtype=torch.int32, device=dev)
    if case == "gemma2_reduced":
        ng, n_pages, bs, kh, hd = 3, 20, 16, 8, 256
        arenas = [torch.randint(-127, 128, (ng, n_pages, bs, kh, hd),
                                generator=gen, device=dev, dtype=torch.int8),
                  torch.rand(ng, n_pages, bs, kh, generator=gen,
                             device=dev).bfloat16()]
    elif case == "scale_48552":
        ng, n_pages, b, mb = 21, 2313, 8, 289
        arenas = [torch.rand(ng, n_pages, 16, 8, generator=gen,
                             device=dev).bfloat16()]
        tables = torch.full((b, mb), -1, dtype=torch.int32, device=dev)
        perm = torch.randperm(n_pages - 1, generator=gen, device=dev).int()
        tables[:6] = perm[:6 * mb].view(6, mb)
        tables[6, :40] = perm[:10].repeat(4)
        tables[5, mb // 2:] = -1
        assert ng * tables.numel() == 48552
    elif case.startswith("offset_"):
        off = int(case.split("_")[1])
        shape = (3, 20, 16, 8, 64)
        n = torch.Size(shape).numel()
        buf = torch.randint(-127, 128, (n + 64,), generator=gen, device=dev,
                            dtype=torch.int8)
        arenas = [buf[off:off + n].view(shape)]
        assert arenas[0].data_ptr() % 16 == off
    elif case == "out_over_2p32":
        side = 65537
        arenas = [torch.randint(-127, 128, (1, 5, 1, side), generator=gen,
                                device=dev, dtype=torch.int8)]
        tables = (torch.arange(side, dtype=torch.int32, device=dev) % 7
                  - 1).view(1, side)
        assert side * side > 2 ** 32
    else:
        ng, n_pages, bs, kh, hd = 1, 32780, 16, 8, 256
        arena = torch.empty((ng, n_pages, bs, kh, hd), dtype=torch.bfloat16,
                            device=dev)
        assert arena.numel() * arena.element_size() > 2 ** 31
        arena[:, -40:].copy_(torch.randn(ng, 40, bs, kh, hd, generator=gen,
                                         device=dev))
        arena[:, :40].copy_(torch.randn(ng, 40, bs, kh, hd, generator=gen,
                                        device=dev))
        arenas = [arena]
        tables = torch.tensor([[n_pages - 2, n_pages - 39, 3, -1],
                               [n_pages - 2, 5, n_pages + 1, -2]],
                              dtype=torch.int32, device=dev)
    for arena in arenas:
        paged_gather.reset_launches()
        got = ops.paged_gather(arena, tables)
        again = ops.paged_gather(arena, tables)
        want = ops.paged_gather(arena, tables, use_kernel=False)
        torch.cuda.synchronize()
        assert paged_gather.launches == {"paged_gather_pages": 2}
        assert got.dtype == arena.dtype and torch.equal(got, want)
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("quant", [False, True])
def test_cuda_gemma2_decode_step_makes_no_host_sync(dev, quant):
    """One bf16 decode step of the reduced gemma2-9b (a local and a
    global slot, window 8 over a wrapped ring, softcaps, post-norms,
    scaled embeddings; int8 cache with ``quant``) with the kernels, under
    ``torch.cuda.set_sync_debug_mode("error")``: same logits as without
    the mode, one ``flash_decode`` launch per layer."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.kernels import decode_attention as da
    from repro_torch.models import build_model
    cfg = reduced_config(get_config("gemma2-9b"))
    cfg = dataclasses.replace(cfg, dtype="bfloat16", attn=dataclasses.replace(
        cfg.attn, sliding_window=8, kv_cache_quant=quant))
    model = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = model.init(gen)
    pool = model.init_lora(gen, n_slots=4)
    tokens = torch.randint(0, cfg.vocab_size, (3, 16), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([16, 9, 5], dtype=torch.int32, device=dev)
    mode = LoRAMode("batched", torch.tensor([2, 0, 2], dtype=torch.int32,
                                            device=dev), 0.5, "sgmv")
    _, cache = model.prefill(params, {"tokens": tokens},
                             model.init_cache(3, 32), pool, mode,
                             lengths=lengths)
    nxt = tokens[:, 0].contiguous()

    def step():
        c = {k: {n: v.clone() for n, v in node.items()}
             for k, node in cache.items()}
        return model.decode_step(params, nxt, c, lengths, pool, mode)[0]

    want = step()
    torch.cuda.synchronize()
    da.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = step()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert da.launches == {"flash_decode": cfg.n_layers}
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,over", [
    ("gemma2-9b", dict(sliding_window=8, attn_logit_softcap=2.0)),
    ("starcoder2-7b", dict(sliding_window=8)),
    ("chameleon-34b", {}),
    ("gemma2-9b", dict(sliding_window=8, kv_cache_quant=True)),
])
def test_cuda_variant_kernel_route_matches_plain_route(dev, arch, over):
    """The reduced variants in f32 on the card: prefill past the window
    and two decode steps with the attention kernels against the plain
    attention code, within 1e-4 of max|logit| (an int8 ring: both
    dequantize in f32 here). Each decode step runs in both routes from
    the plain route's cache and tokens, so an int8 value that the two
    routes' f32 K/V round to neighbouring steps cannot compound."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    cfg = reduced_config(get_config(arch))
    cfg = dataclasses.replace(cfg, dtype="float32", attn=dataclasses.replace(
        cfg.attn, **over))
    plain = build_model(cfg, dev)
    params = plain.init(torch.Generator(device=dev).manual_seed(0))
    kern = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (3, 16), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([16, 9, 5], dtype=torch.int32, device=dev)
    models = {"plain": plain, "kernel": kern}
    out = {name: m.prefill(params, {"tokens": tokens}, m.init_cache(3, 32),
                           lengths=lengths) for name, m in models.items()}
    logits = {name: [lp] for name, (lp, _) in out.items()}
    cache = out["plain"][1]
    nxt, pos = torch.argmax(logits["plain"][0], -1).int(), lengths.clone()
    for _ in range(2):
        for name, m in models.items():
            c = {k: {n: v.clone() for n, v in node.items()}
                 for k, node in cache.items()}
            ld, c = m.decode_step(params, nxt, c, pos)
            logits[name].append(ld)
            if name == "plain":
                cache = c
        nxt, pos = torch.argmax(logits["plain"][-1], -1).int(), pos + 1
    torch.cuda.synchronize()
    for got, want in zip(logits["kernel"], logits["plain"]):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


# ---------------------------------------------------------------------------
# the MoE family: dbrx-132b (GQA 6), llama4-maverick (GQA 5, chunked-local
# rings of 8192)
# ---------------------------------------------------------------------------


def _chunk_ring(dev, depths, c):
    """Ring positions [B, c] of rows written up to ``depths`` (position p
    at index p % c; -1 where nothing was written) and each row's query
    position."""
    depth = torch.tensor(depths, dtype=torch.int32, device=dev)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    newest = (depth[:, None] - 1 - idx) // c * c + idx
    kv_pos = torch.where(newest >= 0, newest, -1).to(torch.int32)
    return kv_pos, (depth - 1).clamp_min(0)


@pytest.mark.cuda
@pytest.mark.parametrize("g", [5, 6])
def test_cuda_flash_decode_chunked_ring_8192(dev, g):
    """llama4's local decode layer: chunked-local, window 8192, over an
    8192-entry ring, bf16, rows past the chunk boundary (their visible
    keys start at 8192), at it, below it and idle."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(15)
    b, kh, hd, c = 8, 8, 128, 8192
    kv_pos, q_pos = _chunk_ring(dev, [8704, 8600, 8193, 8192, 4000, 100, 1,
                                      0], c)
    q = torch.randn(b, g * kh, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(b, c, kh, hd, generator=gen, device=dev).bfloat16()
            for _ in "kv")
    kw = dict(window=c, chunked=True)
    da.reset_launches()
    got = da.flash_decode(q, k, v, kv_pos, q_pos, **kw)
    want = da.flash_decode_plain(q, k, v, kv_pos, q_pos, **kw)
    torch.cuda.synchronize()
    assert da.launches == {"flash_decode": 1}
    _attn_close(got, want, torch.bfloat16)
    # the chunk is real: the plain sliding window of 8192 differs on the
    # rows past the boundary
    slide = da.flash_decode_plain(q, k, v, kv_pos, q_pos, window=c)
    assert (slide[:3].float() - want[:3].float()).abs().max() > 1e-2


@pytest.mark.cuda
@pytest.mark.parametrize("g", [5, 6])
def test_cuda_flash_prefill_chunked_past_8192(dev, g):
    """A prompt of 8704 tokens, chunked-local at 8192, bf16 (2 kv heads
    here to keep the plain version's score matrix small): the last 512
    queries see only their own chunk."""
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(16)
    s, kh, hd = 8704, 2, 128
    q = torch.randn(1, s, g * kh, hd, generator=gen, device=dev).bfloat16()
    k, v = (torch.randn(1, s, kh, hd, generator=gen, device=dev).bfloat16()
            for _ in "kv")
    kw = dict(window=8192, chunked=True)
    fp.reset_launches()
    got = fp.flash_prefill(q, k, v, **kw)
    want = fp.flash_prefill_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fp.launches == {"flash_prefill": 1}
    _attn_close(got, want, torch.bfloat16)


# (arch, attention overrides): llama4 at a chunk of 16, so the reduced
# model's prompts and decode steps cross it
MOE_ARCHS = [("dbrx-132b", {}),
             ("llama4-maverick-400b-a17b", dict(sliding_window=16))]


def _moe_problem(arch, over, b, s, **moe_over):
    """A reduced MoE config in f32, one layer's MoE params (and a batched
    LoRA on a shared expert) and x [b, s, d], drawn on the CPU."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import moe
    cfg = reduced_config(get_config(arch))
    cfg = dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(
        cfg.moe, **moe_over), attn=dataclasses.replace(cfg.attn, **over))
    gen = torch.Generator().manual_seed(17)
    params = moe.moe_init(gen, cfg, dtype=torch.float32)
    for leaf in (params["experts"], params.get("shared", {})):
        for name, w in leaf.items():
            leaf[name] = torch.randn(w.shape, generator=gen) / w.shape[-2] ** .5
    params["router"] = torch.randn(params["router"].shape, generator=gen)
    lora = None
    if "shared" in params:
        d, f = cfg.d_model, cfg.d_ff
        lora = {m: {"A": torch.randn(4, 4, di, generator=gen) / 2,
                    "B": 0.05 * torch.randn(4, do, 4, generator=gen)}
                for m, (di, do) in (("up", (d, f)), ("gate", (d, f)),
                                    ("down", (f, d)))}
    x = torch.randn(b, s, cfg.d_model, generator=gen)
    ids = torch.randint(0, 4, (b,), generator=gen, dtype=torch.int32)
    return cfg, params, lora, x, ids


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,cf", [(3, 16, 1.25), (2, 2100, 0.5)])
@pytest.mark.parametrize("arch,over", MOE_ARCHS)
def test_cuda_moe_block_matches_cpu(dev, arch, over, b, s, cf):
    """``moe_block`` on the card against itself on the CPU, f32: the same
    experts chosen and kept (lossless at [3, 16]; at [2, 2100] with cf 0.5
    choices drop), outputs within 1e-5 of max|y|, aux within 1e-5."""
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import moe
    cfg, params, lora, x, ids = _moe_problem(arch, over, b, s,
                                             capacity_factor=cf)

    def to(tree, where):
        if isinstance(tree, dict):
            return {k: to(v, where) for k, v in tree.items()}
        return None if tree is None else tree.to(where)

    out = {}
    for where in ("cpu", dev):
        p, lo = to(params, where), to(lora, where)
        xw = x.to(where)
        y, aux = moe.moe_block(p, xw, cfg, lo,
                               LoRAMode("batched", ids.to(where), 2.0,
                                        "einsum"))
        _, eids, _ = moe.route(p, xw.reshape(b * s, -1), cfg.moe)
        pos = moe.queue_positions(eids.reshape(-1), cfg.moe.n_experts)
        out[str(where)] = (y.cpu(), {k: float(v) for k, v in aux.items()},
                           eids.cpu(), pos.cpu())
    (yc, ac, ec, pc), (yg, ag, eg, pg) = out["cpu"], out[str(dev)]
    assert torch.equal(ec, eg) and torch.equal(pc, pg)
    cap = moe.capacity(b * s, cfg.moe)
    assert bool((pc < cap).all()) == (cf > 1)
    err = (yg - yc).abs().max().item()
    assert err <= 1e-5 * yc.abs().max().item(), err
    for k in ac:
        assert abs(ag[k] - ac[k]) <= 1e-5 * abs(ac[k]), (k, ag[k], ac[k])


@pytest.mark.cuda
@pytest.mark.parametrize("kv,step", [
    ("dense", "_prefill"), ("dense", "_decode"), ("paged", "_decode_paged"),
])
@pytest.mark.parametrize("arch,over", MOE_ARCHS)
def test_cuda_moe_engine_steps_make_no_host_sync(dev, arch, over, kv, step):
    """Whole engine steps of the reduced MoE models (the dispatch's sort,
    cumsum, scatter and gather; llama4's chunked-local rings and shared
    expert) under ``torch.cuda.set_sync_debug_mode("error")``: the same
    tokens as the captured call, one attention launch per layer, each
    SGMV kernel once per LoRA module (q, k, v, o) and layer."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_gather as pg
    fn, seen = _captured_step(dev, "edgelora", kv, step, arch, **over)
    for mod in (sgmv, da, fp, pg):
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tokens, _ = fn(*seen["args"], **seen["kw"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(tokens, seen["tokens"])
    n = 4 if arch.startswith("llama4") else 2      # reduced depths
    assert sgmv.launches["sgmv_shrink"] == 4 * n
    assert fp.launches["flash_prefill"] + da.launches["flash_decode"] == n
    pages = {"dense": 0, "paged": 2 if arch.startswith("dbrx") else 8}
    assert pg.launches["paged_gather_pages"] == (
        pages[kv] if "decode" in step else 0)


# ---------------------------------------------------------------------------
# head dim 80 (zamba2's shared block), the SSM family's widths and steps
# ---------------------------------------------------------------------------

# (b, sq, skv, h, kh, offset, window): GQA 1 (zamba2's 32/32) and 2,
# ragged Sq and Skv, a suffix over a cached prefix, a window
HD80_PREFILL = [
    (2, 64, 64, 32, 32, 0, None),
    (2, 77, 77, 4, 2, 0, None),
    (1, 300, 300, 8, 8, 0, 64),
    (2, 33, 97, 4, 2, 64, None),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,skv,h,kh,offset,window", HD80_PREFILL)
def test_cuda_flash_prefill_hd80_matches_plain(dev, dtype, b, sq, skv, h, kh,
                                               offset, window):
    """``flash_prefill`` at head dim 80 (the tensor-core template's 5
    k-steps and 10 n8 tiles; the f32 template's 48-row tile), within its
    tolerance of the plain version; a row that sees no key is the mean of
    V."""
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(80)
    q = torch.randn(b, sq, h, 80, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, kh, 80, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, kh, 80, generator=gen, device=dev).to(dtype)
    kw = dict(window=window)
    if offset:
        kw.update(qpos=torch.arange(offset, offset + sq, dtype=torch.int32,
                                    device=dev),
                  kpos=torch.arange(skv, dtype=torch.int32, device=dev))
    fp.reset_launches()
    got = fp.flash_prefill(q, k, v, **kw)
    want = fp.flash_prefill_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fp.launches == {"flash_prefill": 1}
    _attn_close(got, want, dtype)
    # an idle row: positions before every key
    qpos = torch.arange(sq, dtype=torch.int32, device=dev) - 1000
    qpos[1:] += 1000 + skv
    kpos = torch.arange(skv, dtype=torch.int32, device=dev)
    got = fp.flash_prefill(q, k, v, qpos=qpos, kpos=kpos)
    torch.cuda.synchronize()
    _attn_close(got, fp.flash_prefill_plain(q, k, v, qpos=qpos, kpos=kpos),
                dtype)
    _attn_close(got[:, 0], v.float().mean(1).repeat_interleave(h // kh, 1),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,h,kh,c", [(8, 32, 32, 4096), (3, 4, 2, 37),
                                      (2, 8, 4, 300)])
def test_cuda_flash_decode_hd80_matches_plain(dev, dtype, b, h, kh, c):
    """``flash_decode`` at head dim 80 (160-byte bf16 rows: 10 cp.async
    chunks), GQA 1 and 2, over rings split across CTAs (4096) or not,
    part-filled rows and an idle last row (the mean of V)."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(81)
    q = torch.randn(b, h, 80, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, c, kh, 80, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, c, kh, 80, generator=gen, device=dev).to(dtype)
    idx = torch.arange(c, device=dev, dtype=torch.int32)
    depth = torch.randint(1, c + 1, (b,), generator=gen, device=dev)
    kv_pos = torch.where(idx[None] < depth[:, None], idx[None], -1).to(
        torch.int32)
    kv_pos[-1] = -1
    q_pos = (depth - 1).to(torch.int32)
    da.reset_launches()
    got = da.flash_decode(q, k, v, kv_pos, q_pos)
    want = da.flash_decode_plain(q, k, v, kv_pos, q_pos)
    torch.cuda.synchronize()
    assert da.launches == {"flash_decode": 1}
    _attn_close(got, want, dtype)
    _attn_close(got[-1], v[-1].float().mean(0).repeat_interleave(h // kh, 0),
                dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("t", [8, 512])
@pytest.mark.parametrize("d_in,d_out", [(768, 3352), (2560, 10448),
                                        (49152, 8192)])
def test_cuda_sgmv_ssm_and_qwen15_widths(dev, dtype, t, d_in, d_out):
    """Rank 16 over a 16-slot pool at the widths new in this family:
    mamba2's and zamba2's ``in_proj`` expands (3352 and 10448, not
    multiples of 64) and qwen1.5-110b's ``down`` shrink (d_in 49152), the
    plan's ``n_used`` as the main path passes it; ``ops.sgmv`` beside."""
    from repro_torch.kernels import ref
    gen = torch.Generator(device=dev).manual_seed(15)
    r, n_pool = 16, 16
    x = torch.randn(t, d_in, generator=gen, device=dev).to(dtype)
    a = torch.randn(n_pool, r, d_in, generator=gen, device=dev) / r ** 0.5
    b = torch.randn(n_pool, d_out, r, generator=gen, device=dev) * 0.01
    slots = torch.randint(0, n_pool, (t,), generator=gen, device=dev,
                          dtype=torch.int32)
    blk_t = ops.auto_blk_t(t, n_pool)
    plan = ops.plan_grouping(slots, n_pool, blk_t)
    xbuf = x.new_zeros((plan.n_padded, d_in))
    xbuf[plan.padded_pos.long()] = x[plan.perm]
    bs, nu = plan.block_slots, plan.n_used
    s = sgmv.sgmv_shrink(xbuf, a, bs, blk_t=blk_t, n_used=nu)
    _sgmv_close(s, sgmv.shrink_plain(xbuf, a, bs, blk_t=blk_t, n_used=nu))
    y = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                         n_used=nu)
    _sgmv_close(y, sgmv.expand_plain(s, b, bs, blk_t=blk_t,
                                     compute_dtype=dtype, n_used=nu))
    got = ops.sgmv(x, a, b, slots, 2.0, n_slots=n_pool, blk_t=None)
    want = (2.0 * ref.sgmv_ref(x, a.to(dtype), b.to(dtype), slots,
                               1.0)).to(dtype)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_cuda_ssm_blocks_match_cpu(dev, arch, monkeypatch):
    """``ssm_block_full`` (ragged rows, ``seq_mask``, ``lengths``, a
    2-token prompt, over two chunks, batched LoRA) and two
    ``ssm_block_decode`` steps on the card against themselves on the CPU,
    in f32: outputs, states and conv tails within 1e-5 of max|cpu| plus
    the SSD's own conditioning. The reference's algorithm takes each decay
    exp(cs_i - cs_j) from within-chunk cumsums of dt·A, which reach
    |cs| of several hundred here (A up to 16): a difference of two such
    sums carries one f32 ulp of |cs| (~3e-5 at 485) as a relative error,
    and the card's parallel scan and the CPU's sequential sum round
    differently, so 8 ulps of the largest |cs| are added."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import ssm
    from repro_torch.models.transformer import group_view, init_lora_stack
    cfg = dataclasses.replace(reduced_config(get_config(arch)),
                              dtype="float32")
    gen = torch.Generator().manual_seed(3)
    sp = group_view(ssm.ssm_init(gen, cfg, stack=(1,), dtype=torch.float32),
                    0)
    for name in ("dt_bias", "conv_b", "D"):
        sp[name].normal_(0.0, 0.3, generator=gen)
    sp["gate_norm"]["scale"].normal_(0.0, 0.1, generator=gen)
    sp["in_proj"].mul_(sp["in_proj"].shape[0] ** -0.5)
    sp["out_proj"].mul_(sp["out_proj"].shape[0] ** -0.5)
    lora = group_view(init_lora_stack(gen, cfg, n_slots=4)["layers"],
                      0)["slot0"]
    for pair in lora.values():
        pair["B"].normal_(0.0, 0.05, generator=gen)
    lengths = torch.tensor([40, 2, 23], dtype=torch.int32)
    x = torch.randn(3, 40, cfg.d_model, generator=gen)
    mask = torch.arange(40)[None] < lengths[:, None]
    steps = [torch.randn(3, cfg.d_model, generator=gen) for _ in range(2)]
    ids = torch.tensor([2, 0, 3], dtype=torch.int32)
    cs_max = []
    ssd = ssm.ssd_chunked

    def recording(x, dt, a, b, c, *, chunk, initial_state=None):
        cs = (dt * a).reshape(dt.shape[0], -1, chunk, dt.shape[2]).cumsum(2)
        cs_max.append(cs.abs().max().item())
        return ssd(x, dt, a, b, c, chunk=chunk, initial_state=initial_state)

    monkeypatch.setattr(ssm, "ssd_chunked", recording)

    def to(tree, where):
        if isinstance(tree, dict):
            return {k: to(v, where) for k, v in tree.items()}
        return tree.to(where)

    out = {}
    for where in ("cpu", dev):
        p, lo = to(sp, where), to(lora, where)
        mode = LoRAMode("batched", ids.to(where), 2.0, "einsum")
        y, state, tail = ssm.ssm_block_full(
            p, x.to(where), cfg, lo, mode, return_state=True,
            seq_mask=mask.to(where), lengths=lengths.to(where))
        res, cache = [y, state, tail], {"conv": tail, "state": state}
        for xt in steps:
            yd, cache = ssm.ssm_block_decode(p, xt.to(where), cache, cfg, lo,
                                             mode)
            res += [yd, cache["state"], cache["conv"]]
        out[str(where)] = [t.cpu() for t in res]
    tol = 1e-5 + 8 * 2.0 ** -24 * max(cs_max)
    for c, g in zip(out["cpu"], out[str(dev)]):
        assert torch.isfinite(g).all()
        err = (g - c).abs().max().item()
        assert err <= tol * c.abs().max().item(), (err, tol)


@pytest.mark.cuda
@pytest.mark.parametrize("kv,step", [
    ("dense", "_prefill"), ("dense", "_decode"), ("paged", "_decode_paged"),
])
@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b"])
def test_cuda_ssm_engine_steps_make_no_host_sync(dev, arch, kv, step):
    """Whole engine steps of reduced mamba2 and zamba2 (the chunked SSD,
    the conv tail's gather, the recurrent decode; zamba2's shared block
    on the attention kernels at its reduced head dim) under
    ``torch.cuda.set_sync_debug_mode("error")``: the same tokens as the
    captured call; each SGMV kernel once per LoRA call (in_proj and
    out_proj a layer, q, k, v, o a shared-block application), one
    attention launch per shared-block application, the shared ring's two
    page gathers per paged decode step (none for mamba2)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_gather as pg
    fn, seen = _captured_step(dev, "edgelora", kv, step, arch)
    for mod in (sgmv, da, fp, pg):
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tokens, _ = fn(*seen["args"], **seen["kw"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(tokens, seen["tokens"])
    # reduced depths: mamba2 2 layers; zamba2 4 layers in 2 groups
    layers, shared = (2, 0) if arch.startswith("mamba2") else (4, 2)
    assert sgmv.launches["sgmv_shrink"] == 2 * layers + 4 * shared
    assert fp.launches["flash_prefill"] + da.launches["flash_decode"] == \
        shared
    assert pg.launches["paged_gather_pages"] == (
        2 if kv == "paged" and shared else 0)


# ---------------------------------------------------------------------------
# the encoder-decoder family: whisper-medium (hd 64, GQA 1, 1500 frames)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_prefill_whisper_layer(dev, dtype, causal):
    """``flash_prefill`` at whisper's layer, [2, 1500, 16/16, 64]: GQA 1
    at head dim 64, and 1500 positions, no multiple of any tile, so the
    last query and key tiles are ragged; causal (the decoder's
    self-attention) and not (the encoder's: every key visible), with
    explicit positions and without."""
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(64)
    b, s, h = 2, 1500, 16
    q, k, v = (torch.randn(b, s, h, 64, generator=gen, device=dev).to(dtype)
               for _ in range(3))
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    fp.reset_launches()
    got = fp.flash_prefill(q, k, v, qpos=pos, kpos=pos, causal=causal)
    want = fp.flash_prefill_plain(q, k, v, qpos=pos, kpos=pos, causal=causal)
    again = fp.flash_prefill(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fp.launches == {"flash_prefill": 2}
    _attn_close(got, want, dtype)
    assert torch.equal(got, again)
    if not causal:   # the first position sees the last key
        first = fp.flash_prefill_plain(q, k, v, causal=True)[:, 0]
        assert (want[:, 0].float() - first.float()).abs().max() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,c", [(8, 448), (3, 37)])
def test_cuda_flash_decode_whisper_layer(dev, dtype, b, c):
    """``flash_decode`` at whisper's decoder layer, q [B, 16, 64] over a
    ring of 16 kv heads (GQA 1, head dim 64): part-filled rows and an
    idle last row (the mean of V)."""
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(65)
    q = torch.randn(b, 16, 64, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, c, 16, 64, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, c, 16, 64, generator=gen, device=dev).to(dtype)
    idx = torch.arange(c, device=dev, dtype=torch.int32)
    depth = torch.randint(1, c + 1, (b,), generator=gen, device=dev)
    kv_pos = torch.where(idx[None] < depth[:, None], idx[None], -1).to(
        torch.int32)
    kv_pos[-1] = -1
    q_pos = (depth - 1).to(torch.int32)
    da.reset_launches()
    got = da.flash_decode(q, k, v, kv_pos, q_pos)
    want = da.flash_decode_plain(q, k, v, kv_pos, q_pos)
    torch.cuda.synchronize()
    assert da.launches == {"flash_decode": 1}
    _attn_close(got, want, dtype)
    _attn_close(got[-1], v[-1].float().mean(0), dtype)


def _whisper(dev, dtype="float32", **kw):
    """Reduced whisper on the card: (config, params, a pool of 4 with
    nonzero B, frames, tokens, right-padded lengths)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_config("whisper-medium")),
                              dtype=dtype, **kw)
    gen = torch.Generator(device=dev).manual_seed(0)
    model = build_model(cfg, dev)
    params = model.init(gen)
    pool = model.init_lora(gen, n_slots=4)

    def draw_b(tree):
        for key, node in tree.items():
            if key == "B":
                node.normal_(0.0, 0.02, generator=gen)
            elif isinstance(node, dict):
                draw_b(node)

    draw_b(pool)
    b = 3
    fr = torch.randn(b, cfg.encoder.n_frames, cfg.d_model, generator=gen,
                     device=dev).to(model.dtype)
    tokens = torch.randint(0, cfg.vocab_size, (b, 16), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([16, 9, 5], dtype=torch.int32, device=dev)
    return cfg, params, pool, fr, tokens, lengths


@pytest.mark.cuda
def test_cuda_whisper_kernel_route_matches_plain_route(dev):
    """Reduced whisper in f32 on the card: a prefill (right-padded rows,
    mixed adapters through the SGMV kernels) and two decode steps with
    the attention kernels (the encoder's non-causal ``flash_prefill``,
    the decoder's causal one, ``flash_decode``) against the plain
    attention code, within 1e-4 of max|logit|; each decode step runs on
    both routes from the plain route's cache and tokens. Launches: two
    ``flash_prefill`` a layer per prefill (encoder and decoder), one
    ``flash_decode`` a layer per decode step; each SGMV kernel once per
    LoRA call (encoder 5, decoder 5 and cross 2 a layer in a prefill;
    decoder and cross, 7 a layer, in a decode step)."""
    from repro_torch.core.lora import LoRAMode
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.models import build_model
    cfg, params, pool, fr, tokens, lengths = _whisper(dev)
    mode = LoRAMode("batched", torch.tensor([2, 0, 3], dtype=torch.int32,
                                            device=dev), cfg.lora.scale,
                    "sgmv")
    models = {name: build_model(cfg, dev, attn_kernel=name == "kernel")
              for name in ("plain", "kernel")}
    nl = cfg.n_layers
    logits, launches, out = {}, {}, {}
    for name, m in models.items():
        for mod in (sgmv, da, fp):
            mod.reset_launches()
        out[name] = m.prefill(params, {"tokens": tokens, "frames": fr},
                              m.init_cache(3, 32), pool, mode,
                              lengths=lengths)
        torch.cuda.synchronize()
        launches[name] = (fp.launches["flash_prefill"],
                          sgmv.launches["sgmv_shrink"])
        logits[name] = [out[name][0]]
    assert launches == {"plain": (0, 12 * nl), "kernel": (2 * nl, 12 * nl)}
    cache = out["plain"][1]
    nxt, pos = torch.argmax(logits["plain"][0], -1).int(), lengths.clone()
    for _ in range(2):
        for name, m in models.items():
            c = {"self": {n: t.clone() for n, t in cache["self"].items()},
                 "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
            da.reset_launches()
            sgmv.reset_launches()
            ld, c = m.decode_step(params, nxt, c, pos, pool, mode)
            torch.cuda.synchronize()
            assert da.launches["flash_decode"] == (
                nl if name == "kernel" else 0)
            assert sgmv.launches["sgmv_expand"] == 7 * nl
            logits[name].append(ld)
            if name == "plain":
                cache = c
        nxt, pos = torch.argmax(logits["plain"][-1], -1).int(), pos + 1
    for got, want in zip(logits["kernel"], logits["plain"]):
        assert torch.isfinite(got).all()
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
def test_cuda_whisper_decode_step_makes_no_host_sync(dev):
    """A bf16 whisper decode step on the kernels (SGMV, ``flash_decode``)
    under ``torch.cuda.set_sync_debug_mode("error")``, equal to the same
    step run without it."""
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import build_model
    cfg, params, pool, fr, tokens, lengths = _whisper(dev, "bfloat16")
    model = build_model(cfg, dev, attn_kernel=True)
    mode = LoRAMode("batched", torch.tensor([2, 0, 3], dtype=torch.int32,
                                            device=dev), cfg.lora.scale,
                    "sgmv")
    with torch.no_grad():
        logits, cache = model.prefill(params, {"tokens": tokens,
                                               "frames": fr},
                                      model.init_cache(3, 32), pool, mode,
                                      lengths=lengths)
        nxt = torch.argmax(logits, -1).int()

        def step():
            c = {"self": {n: t.clone() for n, t in cache["self"].items()},
                 "cross_k": cache["cross_k"], "cross_v": cache["cross_v"]}
            return model.decode_step(params, nxt, c, lengths, pool, mode)[0]

        want = step()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = step()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the distributed layer and the train step's remat on the card
# ---------------------------------------------------------------------------


class _NamedMesh:
    """A mesh of named axes and nothing else: ``logical_constraint`` has
    a mesh to read, and the step's tensors are plain, not DTensors."""
    shape = {"data": 16, "model": 16}


@pytest.mark.cuda
def test_cuda_steps_under_a_mesh_make_no_host_sync(dev):
    """A bf16 prefill and decode step of the reduced Llama (kernels on)
    with a mesh set: every ``logical_constraint`` of the model is the
    identity on a plain tensor and runs no op, and the ring writes
    (``scatter_`` / ``index_copy_``) wait on nothing, under
    ``torch.cuda.set_sync_debug_mode("error")``. Same logits as without
    the mode and without a mesh."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.distributed.sharding import use_mesh
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                              dtype="bfloat16")
    model = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(4)
    params = model.init(gen)
    pool = model.init_lora(gen, n_slots=4)
    tokens = torch.randint(0, cfg.vocab_size, (3, 8), generator=gen,
                           device=dev, dtype=torch.int32)
    pos = torch.tensor([8, 8, 8], dtype=torch.int32, device=dev)
    mode = LoRAMode("batched", torch.tensor([2, 0, 2], dtype=torch.int32,
                                            device=dev), 0.5, "sgmv")

    def steps():
        cache = model.init_cache(3, 16)
        first, cache = model.prefill(params, {"tokens": tokens}, cache, pool,
                                     mode)
        nxt, _ = model.decode_step(params, first.argmax(-1).int(), cache,
                                   pos, pool, mode)
        return first, nxt

    want = steps()
    torch.cuda.synchronize()
    with use_mesh(_NamedMesh()):
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = steps()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3-8b", "dbrx-132b", "mamba2-130m"])
def test_cuda_remat_equals_no_remat(dev, arch):
    """Two f32 LoRA train steps of a reduced config with remat on and off
    on the card: the same loss, grad norm, AdamW moments and adapter, bit
    for bit (the recompute runs the same kernels on the same inputs)."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.models import build_model
    from repro_torch.training import optimizer, train
    cfg = reduced_config(get_config(arch))
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(5)
    params = model.init(gen)
    lora = model.init_lora(gen)
    for t in optimizer.tree_leaves(lora):
        t.normal_(0.0, 0.02, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (3, 17), generator=gen,
                           device=dev, dtype=torch.int32)
    runs = []
    for remat in (False, True):
        step = train.make_train_step(model, remat=remat, peak_lr=1e-3,
                                     warmup=1, total_steps=4)
        state = train.TrainState(params, lora, optimizer.adamw_init(lora))
        mets = []
        for _ in range(2):
            state, met = step(state, {"tokens": tokens})
            mets.append(met)
        runs.append((state, mets))
    (s0, m0), (s1, m1) = runs
    for a, b in zip(m0, m1):
        assert set(a) == set(b)
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for t0, t1 in ((s0.lora, s1.lora), (s0.opt.mu, s1.opt.mu),
                   (s0.opt.nu, s1.opt.nu)):
        for a, b in zip(optimizer.tree_leaves(t0), optimizer.tree_leaves(t1)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_cuda_step_cost_equals_fake_count(dev, kind):
    """``step_cost`` of a reduced qwen2-0.5b step (plain route, einsum
    LoRA) on the card's tensors equals ``step_cost`` of the same step on
    fake copies of them: flops and bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.launch.analysis import step_cost
    from repro_torch.models import build_model
    cfg = dataclasses.replace(reduced_config(get_config("qwen2-0.5b")),
                              dtype="bfloat16")
    model = build_model(cfg, dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    params = model.init(gen)
    pool = model.init_lora(gen, n_slots=4, dtype=torch.bfloat16)
    cache = model.init_cache(4, 64)
    slots = torch.tensor([0, 3, 1, 3], dtype=torch.int32, device=dev)
    if kind == "prefill":
        tokens = torch.randint(0, cfg.vocab_size, (4, 32), generator=gen,
                               device=dev, dtype=torch.int32)
        args = (params, pool, {"tokens": tokens}, cache, slots)
    else:
        tokens = torch.randint(0, cfg.vocab_size, (4,), generator=gen,
                               device=dev, dtype=torch.int32)
        pos = torch.tensor([3, 40, 63, 0], dtype=torch.int32, device=dev)
        args = (params, pool, tokens, cache, pos, slots)

    def run(*a):
        mode = LoRAMode("batched", a[-1], cfg.lora.scale, "einsum")
        if kind == "prefill":
            return model.prefill(a[0], a[2], a[3], a[1], mode)
        return model.decode_step(a[0], a[2], a[3], a[4], a[1], mode)

    with torch.no_grad():
        real = step_cost(run, *args)
        with FakeTensorMode(allow_non_fake_inputs=True) as fm:
            fake_args = tree_map(fm.from_tensor, args)
        fake = step_cost(run, *fake_args)
    for key in ("mxu_flops", "vpu_flops", "bytes"):
        assert real[key] == fake[key] > 0, key


# ---------------------------------------------------------------------------
# the kernels' whole domain: any LoRA rank and token block, any head dim,
# each launch on its tensors' card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("used", ["below", "absent"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [65, 100, 128, 256])
@pytest.mark.parametrize("blk_t", [8, 128, 200, 256])
def test_cuda_sgmv_any_rank_and_block_match_plain(dev, blk_t, r, dtype, used):
    """Ranks past one 64-rank chunk (a ragged last chunk at 65 and 100;
    expand's rank chunks above 128 at 256) and blocks past 128 rows (200:
    two slices of 100; 256: two of 128), ragged d_in / d_out, ``n_used``
    below the block count (zeros past it) and absent. Within 1e-5 of
    max|plain|; the arrival counters back at zero."""
    nb = 5
    x, s, a, b, bs = _sgmv_problem(dev, dtype, blk_t, r, 1000, 333, nb=nb)
    n_used = (torch.tensor(nb - 2, dtype=torch.int32, device=dev)
              if used == "below" else None)
    sgmv.reset_launches()
    got_s = sgmv.sgmv_shrink(x, a, bs, blk_t=blk_t, n_used=n_used)
    got_y = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                             n_used=n_used)
    want_s = sgmv.shrink_plain(x, a, bs, blk_t=blk_t, n_used=n_used)
    want_y = sgmv.expand_plain(s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                               n_used=n_used)
    torch.cuda.synchronize()
    assert sgmv.launches == {"sgmv_shrink": 1, "sgmv_expand": 1}
    _sgmv_close(got_s, want_s)
    _sgmv_close(got_y, want_y)
    if used == "below":
        assert not got_s[(nb - 2) * blk_t:].any()
        assert not got_y[(nb - 2) * blk_t:].any()
    for arrived, _ in sgmv._SCRATCH.values():
        assert not arrived.any()


@pytest.mark.cuda
@pytest.mark.parametrize("r,d_in,d_out,blk_t", [
    (99, 333, 1000, 8),      # r % 4 != 0 past a chunk: element-wise loads
    (130, 4096, 77, 136),    # a 2-rank last chunk, 136 = 68 + 68 rows
    (1, 64, 16, 300),        # rank 1, three slices of 100
])
def test_cuda_sgmv_any_rank_unaligned_shapes(dev, r, d_in, d_out, blk_t):
    for dtype in (torch.float32, torch.bfloat16):
        x, s, a, b, bs = _sgmv_problem(dev, dtype, blk_t, r, d_in, d_out,
                                       nb=4, seed=5)
        nu = torch.tensor(3, dtype=torch.int32, device=dev)
        _sgmv_close(sgmv.sgmv_shrink(x, a, bs, blk_t=blk_t, n_used=nu),
                    sgmv.shrink_plain(x, a, bs, blk_t=blk_t, n_used=nu))
        _sgmv_close(sgmv.sgmv_expand(s, b, bs, blk_t=blk_t,
                                     compute_dtype=dtype, n_used=nu),
                    sgmv.expand_plain(s, b, bs, blk_t=blk_t,
                                      compute_dtype=dtype, n_used=nu))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sgmv_rank128_repeats_are_bit_equal(dev, dtype):
    """Rank 128 at Llama-3.1-8B's decode step and full prefill group: each
    split merges in split order per (block, rank chunk), so two calls give
    the same bits, and the counters are back at zero."""
    for t, d_in, d_out in ((8, 4096, 4096), (512, 14336, 4096)):
        gen = torch.Generator(device=dev).manual_seed(t)
        x = torch.randn(t, d_in, generator=gen, device=dev).to(dtype)
        a = torch.randn(8, 128, d_in, generator=gen, device=dev)
        b = torch.randn(8, d_out, 128, generator=gen, device=dev)
        slots = torch.randint(0, 8, (t,), generator=gen, device=dev,
                              dtype=torch.int32)
        blk_t = ops.auto_blk_t(t, 8)
        plan = ops.plan_grouping(slots, 8, blk_t)
        xbuf = x.new_zeros((plan.n_padded, d_in))
        xbuf[plan.padded_pos.long()] = x[plan.perm]
        outs = [sgmv.sgmv_shrink(xbuf, a, plan.block_slots, blk_t=blk_t,
                                 n_used=plan.n_used) for _ in range(2)]
        ys = [sgmv.sgmv_expand(outs[0], b, plan.block_slots, blk_t=blk_t,
                               compute_dtype=dtype, n_used=plan.n_used)
              for _ in range(2)]
        want = sgmv.shrink_plain(xbuf, a, plan.block_slots, blk_t=blk_t,
                                 n_used=plan.n_used)
        torch.cuda.synchronize()
        assert torch.equal(outs[0], outs[1]) and torch.equal(ys[0], ys[1])
        _sgmv_close(outs[0], want)
        for arrived, _ in sgmv._SCRATCH.values():
            assert not arrived.any()


@pytest.mark.cuda
def test_cuda_ops_sgmv_rank128_blk256_makes_no_host_sync(dev):
    """``ops.sgmv`` at rank 128 with ``blk_t`` 256 (two 128-row slices of
    each block, two rank chunks, derived on the device) under
    ``torch.cuda.set_sync_debug_mode("error")``: no host sync, one launch
    of each kernel, the same bits as the warm call and the reference's
    f32 math within 1e-5."""
    gen = torch.Generator(device=dev).manual_seed(12)
    t = 300
    x = torch.randn(t, 4096, generator=gen, device=dev)
    a = torch.randn(8, 128, 4096, generator=gen, device=dev) / 128 ** 0.5
    b = torch.randn(8, 1024, 128, generator=gen, device=dev)
    slots = torch.randint(0, 8, (t,), generator=gen, device=dev,
                          dtype=torch.int32)

    def run():
        return ops.sgmv(x, a, b, slots, 0.5, n_slots=8, blk_t=256)

    want = run()
    torch.cuda.synchronize()
    sgmv.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert sgmv.launches == {"sgmv_shrink": 1, "sgmv_expand": 1}
    assert torch.equal(got, want)
    from repro_torch.kernels import ref
    plain = ref.sgmv_ref(x, a, b, slots, 0.5)
    _sgmv_close(got, plain)


# (window, chunked, softcap) at each new head dim
_HD_MASKS = [(None, False, None), (16, False, 30.0), (16, True, None)]
# head dims off the built widths (8, 40, 100: padded to 32, 64, 128),
# on the new ones (96, 160, 192) and past 256 (320, 512: the run-time width)
_HEAD_DIMS = [8, 40, 96, 100, 160, 192, 320, 512]


@pytest.mark.cuda
@pytest.mark.parametrize("mask", range(len(_HD_MASKS)))
@pytest.mark.parametrize("qdtype,kvdtype", _KV_TYPES)
@pytest.mark.parametrize("hd", _HEAD_DIMS)
def test_cuda_flash_decode_any_head_dim(dev, hd, qdtype, kvdtype, mask):
    """``flash_decode`` at head dims off the built widths: f32, bf16 and
    int8 K/V (f32 and bf16 q), GQA 4, a ring split across CTAs (300
    entries), per-row positions with a wrapped row, a part-filled row and
    an idle row (the mean of V), window / chunk / softcap. One launch."""
    from repro_torch.kernels import decode_attention as da
    window, chunked, softcap = _HD_MASKS[mask]
    gen = torch.Generator(device=dev).manual_seed(hd)
    b, h, kh, c = 3, 8, 2, 300
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
    idx = torch.arange(c, device=dev, dtype=torch.int32)
    kv_pos = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    kv_pos[0] = idx + c
    kv_pos[1] = torch.where(idx < 170, idx, -1)
    q_pos = torch.tensor([2 * c - 1, 169, 0], dtype=torch.int32, device=dev)
    kw = dict(window=window, chunked=chunked, softcap=softcap, **scales)
    da.reset_launches()
    got = da.flash_decode(q, k, v, kv_pos, q_pos, **kw)
    want = da.flash_decode_plain(q, k, v, kv_pos, q_pos, **kw)
    torch.cuda.synchronize()
    assert da.launches == {"flash_decode": 1}
    assert got.shape == q.shape and got.dtype == qdtype
    _attn_close(got, want, qdtype)
    vf = v.float() * (scales["v_scale"][..., None] if scales else 1.0)
    _attn_close(got[2], vf[2].mean(0).repeat_interleave(h // kh, 0), qdtype)


# (b, sq, skv, h, kh, offset, causal, window, chunked, softcap)
_HD_PREFILL = [
    (2, 45, 45, 8, 2, 0, True, None, False, None),      # GQA 4, ragged
    (1, 70, 70, 4, 4, 0, True, 16, False, 20.0),        # window, softcap
    (2, 40, 40, 6, 2, 0, True, 16, True, None),         # chunked, GQA 3
    (1, 24, 88, 4, 2, 64, True, None, False, None),     # a suffix
    (2, 33, 50, 4, 1, 0, False, None, False, None),     # non-causal
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_HD_PREFILL)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", _HEAD_DIMS)
def test_cuda_flash_prefill_any_head_dim(dev, hd, dtype, case):
    """``flash_prefill`` at head dims off the built widths, both dtypes
    (bf16 on the tensor cores up to 256, the run-time-width kernel above),
    with the masks of the reference: causal, window, chunk, softcap, a
    suffix over explicit positions, non-causal. One launch."""
    from repro_torch.kernels import flash_prefill as fp
    b, sq, skv, h, kh, offset, causal, window, chunked, softcap = \
        _HD_PREFILL[case]
    gen = torch.Generator(device=dev).manual_seed(hd + case)
    q = torch.randn(b, sq, h, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, skv, kh, hd, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, skv, kh, hd, generator=gen, device=dev).to(dtype)
    kw = dict(causal=causal, window=window, chunked=chunked, softcap=softcap)
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
def test_cuda_attention_largest_head_dim(dev, dtype):
    """Both kernels at ``flash_prefill.MAX_HEAD_DIM`` (the wide kernel's
    smallest tile), against their plain versions; one past it, the
    prefill wrapper raises before launching."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    hd = fp.MAX_HEAD_DIM
    gen = torch.Generator(device=dev).manual_seed(22)
    q = torch.randn(1, 20, 4, hd, generator=gen, device=dev).to(dtype)
    k = torch.randn(1, 20, 2, hd, generator=gen, device=dev).to(dtype)
    _attn_close(fp.flash_prefill(q, k, k), fp.flash_prefill_plain(q, k, k),
                dtype)
    kv_pos = torch.arange(20, dtype=torch.int32, device=dev)[None]
    _attn_close(da.flash_decode(q[:, 0], k, k, kv_pos, 19),
                da.flash_decode_plain(q[:, 0], k, k, kv_pos, 19), dtype)
    wide = torch.zeros(1, 4, 2, hd + 1, device=dev, dtype=dtype)
    fp.reset_launches()
    with pytest.raises(ValueError, match="head dim"):
        fp.flash_prefill(wide, wide[:, :, :1], wide[:, :, :1])
    assert fp.launches == {"flash_prefill": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [96, 128])
def test_cuda_attention_unaligned_tensors(dev, dtype, hd):
    """q, K and V that start 2 bytes into their buffers (views of a larger
    allocation): the rows load element by element, with the same result."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    gen = torch.Generator(device=dev).manual_seed(21)

    def shifted(*shape):
        n = 1
        for d in shape:
            n *= d
        buf = torch.randn(n + 1, generator=gen, device=dev).to(dtype)
        t = buf[1:].view(*shape)
        assert t.data_ptr() % 16
        return t

    q, k, v = shifted(2, 30, 8, hd), shifted(2, 30, 2, hd), shifted(2, 30, 2,
                                                                   hd)
    _attn_close(fp.flash_prefill(q, k, v), fp.flash_prefill_plain(q, k, v),
                dtype)
    q3, ring, vring = shifted(2, 8, hd), shifted(2, 40, 2, hd), shifted(
        2, 40, 2, hd)
    kv_pos = torch.arange(40, dtype=torch.int32, device=dev).repeat(2, 1)
    q_pos = torch.tensor([39, 20], dtype=torch.int32, device=dev)
    _attn_close(da.flash_decode(q3, ring, vring, kv_pos, q_pos),
                da.flash_decode_plain(q3, ring, vring, kv_pos, q_pos), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,rank", [(40, 65), (96, 96), (192, 128),
                                     (320, 100)])
def test_cuda_head_dim_variant_kernel_route_matches_plain_route(dev, hd,
                                                                rank):
    """Reduced Llama-3.1-8B at head dims off the built widths and LoRA
    ranks past 64, in f32 on the card: a prefill and two decode steps on
    the kernel route (both attention kernels, the SGMV kernels) against
    the plain route (plain attention, einsum LoRA), within 1e-4 of
    max|logit|, each decode step from the plain route's cache."""
    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import build_model
    cfg = reduced_config(get_config("llama3-8b"))
    cfg = dataclasses.replace(cfg, dtype="float32", head_dim=hd,
                              lora=dataclasses.replace(cfg.lora, rank=rank))
    plain = build_model(cfg, dev)
    params = plain.init(torch.Generator(device=dev).manual_seed(0))
    kern = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    pool = plain.init_lora(gen, n_slots=4)
    for mods in pool["layers"].values():
        for pair in mods.values():
            pair["B"].normal_(0.0, 0.02, generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (3, 16), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([16, 9, 5], dtype=torch.int32, device=dev)
    sids = torch.tensor([2, 0, 3], dtype=torch.int32, device=dev)
    models = {"plain": (plain, "einsum"), "kernel": (kern, "sgmv")}
    logits, cache = {}, None
    for name, (m, backend) in models.items():
        mode = LoRAMode("batched", sids, cfg.lora.scale, backend)
        lp, c = m.prefill(params, {"tokens": tokens}, m.init_cache(3, 32),
                          pool, mode, lengths=lengths)
        logits[name] = [lp]
        if name == "plain":
            cache = c
    nxt, pos = torch.argmax(logits["plain"][0], -1).int(), lengths.clone()
    for _ in range(2):
        for name, (m, backend) in models.items():
            mode = LoRAMode("batched", sids, cfg.lora.scale, backend)
            c = {k: {n: v.clone() for n, v in node.items()}
                 for k, node in cache.items()}
            ld, c = m.decode_step(params, nxt, c, pos, pool, mode)
            logits[name].append(ld)
            if name == "plain":
                cache = c
        nxt, pos = torch.argmax(logits["plain"][-1], -1).int(), pos + 1
    torch.cuda.synchronize()
    for got, want in zip(logits["kernel"], logits["plain"]):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.cuda
def test_cuda_engine_decode_step_hd96_makes_no_host_sync(dev):
    """The engine's paged decode step of reduced Llama-3.1-8B at head dim
    96 with LoRA rank 96 (SGMV at two rank chunks, both attention kernels
    at the width 96, the page gather) under
    ``torch.cuda.set_sync_debug_mode("error")``: the same tokens as the
    captured call, one attention launch a layer, the SGMV kernels once
    per LoRA module and layer."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import paged_gather as pg
    from repro_torch.configs import get_config, reduced_config
    lora = reduced_config(get_config("llama3-8b")).lora
    fn, seen = _captured_step(dev, "edgelora", "paged", "_decode_paged",
                              "llama3-8b", cfg_over=dict(
                                  head_dim=96, lora=dataclasses.replace(
                                      lora, rank=96)))
    for mod in (sgmv, da, fp, pg):
        mod.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        tokens, _ = fn(*seen["args"], **seen["kw"])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert torch.equal(tokens, seen["tokens"])
    n = 2  # reduced config: two layers
    assert sgmv.launches["sgmv_shrink"] == len(lora.target_modules) * n
    assert da.launches["flash_decode"] == n
    assert fp.launches["flash_prefill"] == 0


@pytest.mark.cuda
def test_cuda_kernels_launch_on_their_tensors_card(dev):
    """Inputs on a card other than the current one: every wrapper launches
    on its tensors' card (rank 128 and blk_t 256 for the SGMV pair, head
    dim 96 for the attention pair, the page gather), each result equal to
    its plain version on that card, and the current device is unchanged.
    Skips with fewer than two cards."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    torch.cuda.set_device(0)
    d1 = torch.device("cuda", 1)
    x, s, a, b, bs = _sgmv_problem(d1, torch.bfloat16, 256, 128, 1000, 333,
                                   nb=3)
    nu = torch.tensor(2, dtype=torch.int32, device=d1)
    _sgmv_close(sgmv.sgmv_shrink(x, a, bs, blk_t=256, n_used=nu),
                sgmv.shrink_plain(x, a, bs, blk_t=256, n_used=nu))
    _sgmv_close(sgmv.sgmv_expand(s, b, bs, blk_t=256, n_used=nu,
                                 compute_dtype=torch.bfloat16),
                sgmv.expand_plain(s, b, bs, blk_t=256, n_used=nu,
                                  compute_dtype=torch.bfloat16))
    gen = torch.Generator(device=d1).manual_seed(0)
    q = torch.randn(2, 30, 8, 96, generator=gen, device=d1).bfloat16()
    k = torch.randn(2, 30, 2, 96, generator=gen, device=d1).bfloat16()
    _attn_close(fp.flash_prefill(q, k, k), fp.flash_prefill_plain(q, k, k),
                torch.bfloat16)
    ring = torch.randn(2, 300, 2, 96, generator=gen, device=d1).bfloat16()
    kv_pos = torch.arange(300, dtype=torch.int32, device=d1).repeat(2, 1)
    q_pos = torch.tensor([299, 100], dtype=torch.int32, device=d1)
    q1 = q[:, 0].contiguous()
    _attn_close(da.flash_decode(q1, ring, ring, kv_pos, q_pos),
                da.flash_decode_plain(q1, ring, ring, kv_pos, q_pos),
                torch.bfloat16)
    arena = torch.randn(2, 6, 16, 128, generator=gen, device=d1).bfloat16()
    tables = torch.tensor([[0, 2], [5, -1]], dtype=torch.int32, device=d1)
    assert torch.equal(paged_gather.paged_gather_pages(arena, tables),
                       paged_gather.paged_gather_pages_plain(arena, tables))
    torch.cuda.synchronize(d1)
    assert torch.cuda.current_device() == 0
