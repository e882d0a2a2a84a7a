"""The page gather's launch plan (``gather_plan``, ``gather_work``) on the
CPU: the (output page, byte range) pieces every CTA of a plan copies
cover each output byte exactly once, the vector width is chosen as the
kernel's note says, and a numpy run of the work list, reading the table
with a floor modulo, equals the plain PyTorch version and the reference
Pallas kernel in interpret mode. The CUDA kernel that follows the plan
is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import paged_gather as jpaged  # noqa: E402
from repro_torch.kernels import paged_gather as pg  # noqa: E402

# page sizes in bytes: odd, below 16, small aligned, the int8 cache's
# scale page (16 tokens x 8 heads x bf16), a qwen2-0.5b K page, a
# Llama-3.1-8B page, a page one 16-byte step past 64 KiB
PAGE_BYTES = [1, 15, 16, 60, 256, 4096, 32768, 65536 + 16]


def _covered(plan):
    """How many times each output byte is copied, over every CTA."""
    hits = np.zeros(plan.n_out_pages * plan.page_bytes, np.int32)
    for cta in range(plan.grid):
        work = pg.gather_work(plan, cta)
        assert work, f"CTA {cta} of {plan} has no work"
        for page, lo, hi in work:
            assert 0 <= page < plan.n_out_pages and 0 <= lo < hi
            assert hi <= plan.page_bytes
            assert lo % plan.vec_bytes == 0 == hi % plan.vec_bytes
            hits[page * plan.page_bytes + lo:page * plan.page_bytes + hi] += 1
    return hits


@pytest.mark.parametrize("align", [(16, 16), (8, 16), (2, 16), (1, 16),
                                   (16, 4)])
@pytest.mark.parametrize("n_out_pages", [1, 5, 37])
@pytest.mark.parametrize("page_bytes", PAGE_BYTES)
def test_gather_work_covers_every_byte_once(page_bytes, n_out_pages, align):
    """Over the page-size sweep, with one output page, a few, and more
    than one block holds, at misaligned arena and output pointers: every
    output byte is copied by exactly one piece of one CTA, and no CTA of
    the grid is idle."""
    plan = pg.gather_plan(page_bytes, n_out_pages, *align)
    assert 1 <= plan.grid
    np.testing.assert_array_equal(_covered(plan), 1)


def test_gather_work_tracks_the_grid():
    """One CTA per block of 16 KiB (at 16-byte vectors): several small
    pages to a CTA, several CTAs to a large page."""
    run = pg.BLOCK_VECS * 16
    assert run == 16384
    # the scale leaf of gemma2-9b's step: 48,552 pages of 256 bytes,
    # 64 pages a CTA
    small = pg.gather_plan(256, 48552, 16, 16)
    assert small.vec_bytes == 16 and small.grid == -(-48552 * 256 // run)
    assert [len(pg.gather_work(small, c)) for c in (0, small.grid - 1)] == [
        64, 48552 - 64 * (small.grid - 1)]
    assert pg.gather_plan(256, 2, 16, 16).grid == 1
    # Llama-3.1-8B's leaf: 4352 pages of 32 KiB, two CTAs a page
    big = pg.gather_plan(32768, 4352, 16, 16)
    assert big.grid == 2 * 4352
    assert pg.gather_work(big, 3) == [(1, 16384, 32768)]
    # a 64 KiB + 16 page: blocks straddle pages
    odd = pg.gather_plan(65536 + 16, 3, 16, 16)
    assert odd.grid == -(-3 * (65536 + 16) // run)
    assert pg.gather_work(odd, 4) == [(0, 65536, 65552), (1, 0, 16368)]


def test_gather_plan_routes_as_documented():
    """The vector width is the widest of 16, 8, 4, 2, 1 that divides the
    page size and both pointers."""
    assert pg.gather_plan(256, 100, 16, 16).vec_bytes == 16
    assert pg.gather_plan(65536 + 16, 100, 16, 16).vec_bytes == 16
    assert pg.gather_plan(32768, 100, 8, 16).vec_bytes == 8
    assert pg.gather_plan(32768, 100, 16, 4).vec_bytes == 4
    assert pg.gather_plan(32768 + 2, 100, 16, 16).vec_bytes == 2
    assert pg.gather_plan(60, 100, 16, 16).vec_bytes == 4
    assert pg.gather_plan(15, 100, 16, 16).vec_bytes == 1
    assert pg.gather_plan(16, 100, 1, 16).vec_bytes == 1
    # raw pointers give the same widths as their alignments
    for ptr, want in ((0x7f0000000000, 16), (0x7f0000000008, 8),
                      (0x7f0000000006, 2), (0x7f0000000003, 1)):
        assert pg.vec_bytes(4096, ptr, 0x7f0000100000) == want
        assert pg.vec_bytes(4096, 0x7f0000100000, ptr) == want


def _execute(plan, arena_bytes, tables, n_pages):
    """Run the work list as the kernel does: each piece reads its output
    page's table entry (floor modulo) and copies its byte range."""
    ng = arena_bytes.shape[0]
    bmb = tables.size
    out = np.zeros(plan.n_out_pages * plan.page_bytes, np.uint8)
    src = arena_bytes.reshape(ng, n_pages, plan.page_bytes)
    flat = tables.reshape(-1)
    for cta in range(plan.grid):
        for page, lo, hi in pg.gather_work(plan, cta):
            g, e = divmod(page, bmb)
            t = int(flat[e]) % n_pages          # Python's % is a floor modulo
            out[page * plan.page_bytes + lo:page * plan.page_bytes + hi] = \
                src[g, t, lo:hi]
    return out


@pytest.fixture(scope="module")
def gather_inputs():
    """A float32 arena [2, 7, 3, 5] (60-byte pages) and a [4, 6] table
    with -1, repeats, entries >= n_pages and below -1, and an idle row;
    the reference Pallas kernel's output on them (interpret mode)."""
    rng = np.random.default_rng(7)
    ng, n_pages, bs, f = 2, 7, 3, 5
    arena = rng.normal(size=(ng, n_pages, bs, f)).astype(np.float32)
    tables = np.full((4, 6), -1, np.int32)
    tables[0, :5] = rng.permutation(n_pages)[:5]
    tables[1, :4] = [3, 3, 0, 3]                     # repeats
    tables[2, :4] = [n_pages, 2 * n_pages + 1, -8, 6]  # wrap both ways
    want = np.asarray(jpaged.paged_gather_pages(
        jnp.asarray(arena), jnp.asarray(tables), interpret=True))
    return arena, tables, want


@pytest.mark.parametrize("align", [16, 4, 1])
@pytest.mark.parametrize("view", ["float32", "int8", "bfloat16"])
def test_work_list_execution_matches_plain_and_reference(gather_inputs, view,
                                                         align):
    """The same 60-byte pages seen as float32, int8 and bfloat16 (rows
    of 20 bytes: 5, 20 or 10 elements), at 4-, 4- and 1-byte vectors
    (the arena aligned to 16, 4 or 1 byte): the numpy run of the work
    list equals the plain version and the reference kernel byte for
    byte."""
    arena, tables, want = gather_inputs
    ng, n_pages, bs, f = arena.shape
    plan = pg.gather_plan(60, ng * tables.size, align, 16)
    assert plan.vec_bytes == min(align, 4)
    raw = arena.view(np.uint8).reshape(ng, n_pages, 60)
    got = _execute(plan, raw, tables, n_pages)
    dtype = {"float32": torch.float32, "int8": torch.int8,
             "bfloat16": torch.bfloat16}[view]
    t_arena = torch.from_numpy(arena.copy()).view(dtype).reshape(
        ng, n_pages, bs, -1)
    plain = pg.paged_gather_pages(t_arena, torch.from_numpy(tables))
    assert plain.dtype == dtype and pg.launches["paged_gather_pages"] == 0
    plain_bytes = plain.contiguous().view(torch.uint8).numpy()
    np.testing.assert_array_equal(got, plain_bytes.reshape(-1))
    np.testing.assert_array_equal(got, want.view(np.uint8).reshape(-1))
