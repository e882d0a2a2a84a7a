"""The port's SGMV pieces that decide what the CUDA kernels do, on the CPU.

* ``plan_grouping`` counts tokens per slot on the device (no
  ``torch.bincount``, which reads back to the host) and returns
  ``n_used``, the blocks that hold tokens.
* ``shrink_plain`` / ``expand_plain`` with ``n_used`` against the Pallas
  kernels (interpret mode) on the same padded buffer: the blocks past
  ``n_used`` come out zero, as the Pallas kernels compute them from zero
  rows of x.
* ``shrink_work``, the Python mirror of ``sgmv_shrink``'s device-side work
  split, covers every (used block, column) exactly once, in column order,
  at the main path's decode and prefill shapes.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import sgmv as jsgmv  # noqa: E402
from repro_torch.kernels import ops, sgmv  # noqa: E402


def test_plan_grouping_makes_no_bincount(monkeypatch):
    """The per-slot counts come from ``scatter_add_``; ``bincount`` would
    synchronise with the host on CUDA."""
    def refuse(*args, **kwargs):
        raise AssertionError("plan_grouping called torch.bincount")
    monkeypatch.setattr(torch, "bincount", refuse)
    slots = torch.tensor([3, 0, 3, 1, 3, 0], dtype=torch.int32)
    plan = ops.plan_grouping(slots, 4, 8)
    assert int(plan.n_used) == 3          # slots 0, 1, 3: one block each
    assert plan.block_slots.tolist()[:3] == [0, 1, 3]


def _padded_problem(dtype, t, d_in, d_out, r, n_slots, seed):
    rng = np.random.default_rng(seed)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    x = jnp.asarray(rng.normal(size=(t, d_in)), jd)
    a = jnp.asarray(rng.normal(size=(n_slots, r, d_in)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(n_slots, d_out, r)), jnp.float32)
    slots = rng.integers(0, n_slots, t).astype(np.int32)
    blk_t = ops.auto_blk_t(t, n_slots)
    plan = jops.plan_grouping(jnp.asarray(slots), n_slots, blk_t)
    xbuf = jnp.zeros((plan.n_padded, d_in), jd).at[plan.padded_pos].set(
        x[plan.perm])
    tplan = ops.plan_grouping(torch.from_numpy(slots), n_slots, blk_t)
    return x, a, b, blk_t, plan, xbuf, tplan


def _t(v, dtype=None):
    out = torch.from_numpy(np.array(v, np.float32))
    return out.to(dtype) if dtype is not None else out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,r,n_slots", [(8, 32, 20), (21, 4, 4),
                                         (40, 16, 3)])
def test_plain_with_n_used_matches_pallas(dtype, t, r, n_slots):
    """The Pallas kernels walk every block of the padded buffer; the
    port's plain versions given ``n_used`` compute the used blocks and
    write zeros past them. Same numbers within 1e-5 of max|ref|. The
    Pallas kernels take the pool rounded to x's type, the port rounds it
    itself; the reference's s is f32, which expand takes as it is."""
    d_in, d_out = 256, 128
    x, a, b, blk_t, plan, xbuf, tplan = _padded_problem(
        dtype, t, d_in, d_out, r, n_slots, seed=t)
    jd = xbuf.dtype
    sj = jsgmv.sgmv_shrink(xbuf, a.astype(jd), plan.block_slots,
                           blk_t=blk_t, blk_d=128, interpret=True)
    yj = jsgmv.sgmv_expand(sj, b.astype(jd), plan.block_slots, blk_t=blk_t,
                           blk_d=128, interpret=True)
    td = getattr(torch, dtype)
    st_ = sgmv.sgmv_shrink(_t(xbuf, td), _t(a), tplan.block_slots,
                           blk_t=blk_t, n_used=tplan.n_used)
    yt = sgmv.sgmv_expand(_t(sj), _t(b), tplan.block_slots, blk_t=blk_t,
                          compute_dtype=td, n_used=tplan.n_used)
    used_rows = int(tplan.n_used) * blk_t
    assert used_rows < xbuf.shape[0]     # the problem has padding blocks
    for got, want in ((st_, sj), (yt, yj)):
        want = np.asarray(want, np.float32)
        assert not want[used_rows:].any()
        assert not got[used_rows:].any()
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=1e-5, atol=1e-5)


def test_plain_n_used_zeroes_padding_blocks_whatever_they_hold():
    """Past ``n_used`` the plain versions (like the kernels, which do not
    read them) give zeros even for rows that are not zero."""
    rng = np.random.default_rng(5)
    blk_t, nb, r, d = 8, 5, 4, 32
    x = torch.from_numpy(rng.normal(size=(nb * blk_t, d)).astype(np.float32))
    a = torch.from_numpy(rng.normal(size=(3, r, d)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, d, r)).astype(np.float32))
    bs = torch.tensor([0, 2, 1, 2, 2], dtype=torch.int32)
    n_used = torch.tensor(2, dtype=torch.int32)
    s_all = sgmv.shrink_plain(x, a, bs, blk_t=blk_t)
    s = sgmv.shrink_plain(x, a, bs, blk_t=blk_t, n_used=n_used)
    y = sgmv.expand_plain(s_all, b, bs, blk_t=blk_t,
                          compute_dtype=torch.float32, n_used=n_used)
    assert torch.equal(s[:2 * blk_t], s_all[:2 * blk_t])
    assert not s[2 * blk_t:].any() and s_all[2 * blk_t:].abs().min() > 0
    assert not y[2 * blk_t:].any() and y[:2 * blk_t].abs().max() > 0


def _check_work(n_used: int, d_in: int, grid: int):
    work = sgmv.shrink_work(n_used, d_in, grid)
    s = sgmv.shrink_splits(n_used, d_in, grid)
    assert len(work) == grid
    items = [it for cta in work for it in cta]
    assert len(items) == n_used * s
    # every item once; with more than one split a CTA takes at most one
    # item, so its partial's scratch row (the item) is below the grid
    assert len({(blk, split) for blk, split, _, _ in items}) == len(items)
    if s > 1:
        assert all(len(cta) <= 1 for cta in work)
    # a CTA's items come in increasing order, one grid apart
    for g, cta in enumerate(work):
        assert [blk * s + split for blk, split, _, _ in cta] == list(
            range(g, n_used * s, grid))
    # each used block: its splits, in merge order, tile [0, d_in) exactly
    by_blk = {}
    for blk, split, c0, c1 in items:
        by_blk.setdefault(blk, []).append((split, c0, c1))
    assert sorted(by_blk) == list(range(n_used))
    for parts in by_blk.values():
        parts.sort()
        assert [p[0] for p in parts] == list(range(s))
        edges = [c for _, c0, c1 in parts for c in (c0, c1)]
        assert edges[0] == 0 and edges[-1] == d_in
        assert all(c0 < c1 for _, c0, c1 in parts)
        assert all(parts[i][2] == parts[i + 1][1]
                   for i in range(len(parts) - 1))
        assert all(c0 % sgmv.SHRINK_TILE == 0 for _, c0, _ in parts)
    return s


# (n_used, d_in, grid): the decode step (8 rows, up to 8 used blocks) and
# prefill groups (up to 28 used blocks of 32 rows) at both shrink widths on
# a grid of two CTAs per SM of an H100; a ragged d_in; more used blocks
# than CTAs (each CTA loops); a single block; no block
WORK_CASES = [(8, 4096, 264), (8, 14336, 264), (3, 4096, 264),
              (26, 4096, 264), (28, 14336, 264), (20, 14336, 132),
              (5, 1000, 264), (600, 128, 264), (300, 4096, 264),
              (1, 333, 264), (1, 64, 264), (0, 4096, 264)]


@pytest.mark.parametrize("n_used,d_in,grid", WORK_CASES)
def test_shrink_work_covers_used_blocks_once_in_order(n_used, d_in, grid):
    s = _check_work(n_used, d_in, grid)
    kt = -(-d_in // sgmv.SHRINK_TILE)
    assert 1 <= s <= kt
    if n_used:
        # the card's CTAs spread over the used blocks, not the static bound
        assert s == max(1, min(grid // n_used, kt))
        assert n_used * s <= max(grid, n_used)


def test_shrink_work_at_decode_uses_the_grid():
    """8 decode rows on 8 distinct slots: 8 used blocks of the static
    bound's 21 (ceil(8/8) + 20 slots). On a grid of 264 CTAs each block's
    d_in 4096 (32 tiles) is cut into 32 one-tile splits, so 256 CTAs work
    and none walks a padding block; at d_in 14336 (112 tiles), 33 splits
    of 3 or 4 tiles keep all 264 busy."""
    slots = torch.arange(8, dtype=torch.int32) * 2
    plan = ops.plan_grouping(slots, 20, ops.auto_blk_t(8, 20))
    assert plan.block_slots.numel() == 21 and int(plan.n_used) == 8
    for d_in, busy, tiles in ((4096, 256, {1}), (14336, 264, {3, 4})):
        work = sgmv.shrink_work(int(plan.n_used), d_in, 264)
        sizes = [(c1 - c0) // sgmv.SHRINK_TILE for cta in work
                 for _, _, c0, c1 in cta]
        assert len(sizes) == busy and set(sizes) == tiles
        assert all(blk < int(plan.n_used) for cta in work
                   for blk, _, _, _ in cta)
