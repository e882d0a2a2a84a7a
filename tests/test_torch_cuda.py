"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither JAX nor the ``repro`` package, so it also runs on a
machine with PyTorch and the CUDA toolkit alone; ``tests/conftest.py``
imports JAX, so run it there without the conftest::

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
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
