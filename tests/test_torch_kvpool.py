"""PyTorch port's paged KV arena vs the JAX package's.

* ``PagedKVPool`` + ``PrefixCache`` (the port's copies): the same op
  sequences — register, append, adopt/replace a cached prefix with
  copy-on-write, release, LRU reclaim — leave equal tables, free lists,
  refcounts, lengths and stats in both packages (a hypothesis case and
  the scenarios of ``tests/test_kvpool.py``).
* Device functions, on the same numpy arena: ring positions,
  ``paged_view`` under both routes (each against the reference's route of
  the same name: the gather route zeroes invalid ring indices, the
  indexing route reads the trash page there), ``scatter_prefill``,
  ``scatter_decode``, ``gather_prefix``, ``scatter_suffix`` and
  ``copy_block`` all match exactly. Scatters compare every real page;
  the trash page takes several colliding pad writes whose winner neither
  framework specifies, and nothing reads it at a valid position.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # container has no hypothesis: seeded fallback
    from _hypothesis_compat import given, settings, strategies as st

from repro.kernels import ops as jops  # noqa: E402
from repro.serving import kvpool as jkv  # noqa: E402
from repro.serving import prefix_cache as jpc  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.serving import kvpool as tkv  # noqa: E402
from repro_torch.serving import prefix_cache as tpc  # noqa: E402

BOTH = ((jkv, jpc), (tkv, tpc))

# ---------------------------------------------------------------------------
# host allocator + radix cache: op-sequence parity
# ---------------------------------------------------------------------------

BS = 4
# prompts sharing block-aligned prefixes; #2 is exactly block-aligned
# (a whole-prompt match copies on write), #5 is a longer sibling of #1
_RNG = np.random.default_rng(11)
_SYS = _RNG.integers(0, 50, 8, dtype=np.int32)
PROMPTS = [
    np.concatenate([_SYS, _RNG.integers(0, 50, 3, dtype=np.int32)]),
    np.concatenate([_SYS, _RNG.integers(0, 50, 6, dtype=np.int32)]),
    _SYS.copy(),
    _RNG.integers(0, 50, 9, dtype=np.int32),
    np.concatenate([_SYS[:4], _RNG.integers(0, 50, 5, dtype=np.int32)]),
]
PROMPTS.append(np.concatenate([PROMPTS[1], _RNG.integers(0, 50, 4,
                                                         dtype=np.int32)]))


def _state(pool, cache):
    nodes = {blk: (node.key, node.parent.block, node.last_used)
             for blk, node in cache.nodes.items()}
    return (list(pool.free), {k: list(v) for k, v in pool.tables.items()},
            dict(pool.lengths), dict(pool.refs), pool.stats.as_dict(),
            cache.stats.as_dict(), nodes, cache.reclaimable())


class _Driver:
    """The engine's use of one package's pool and prefix cache."""

    def __init__(self, mods, n_blocks):
        kv, pc = mods
        self.kv = kv
        self.pool = kv.PagedKVPool(n_blocks, BS)
        self.cache = pc.PrefixCache(self.pool, BS)
        assert self.pool.reclaimer is self.cache
        self.next_id = 0
        self.cows = 0

    def admit(self, p, adopt):
        toks = PROMPTS[p % len(PROMPTS)]
        n = len(toks)
        if not self.pool.can_allocate(n + 1):
            return "defer"
        sid = self.next_id
        self.next_id += 1
        self.pool.register(sid)
        key = (False, p % 2)
        if not adopt:
            self.pool.append_tokens(sid, n)
        blocks = self.cache.match(key, toks)
        matched = len(blocks) * BS
        plen = min(matched, n - 1)
        if plen <= 0:
            blocks, matched = [], 0
        if adopt:
            pair = self.pool.adopt_prefix(sid, blocks, n,
                                          cow_last=plen < matched)
        elif blocks:
            pair = self.pool.replace_prefix(sid, blocks,
                                            cow_last=plen < matched)
        else:
            pair = None
        self.cows += pair is not None
        self.cache.insert(key, toks, self.pool.tables[sid])
        return ("admit", sid, pair)

    def append(self, s, n):
        live = sorted(self.pool.tables)
        if not live:
            return None
        sid = live[s % len(live)]
        try:
            return ("append", self.pool.append_tokens(sid, n))
        except self.kv.OutOfBlocksError as e:
            return ("oom", str(e))

    def release(self, s):
        live = sorted(self.pool.tables)
        if not live:
            return None
        self.pool.release(live[s % len(live)])
        return "release"

    def step(self, op, a, b):
        if op in (0, 1):
            out = self.admit(a, adopt=op == 0)
        elif op == 2:
            out = self.append(a, b)
        elif op == 3:
            out = self.release(a)
        else:
            out = ("reclaim", self.cache.reclaim(b % 3))
        return out, _state(self.pool, self.cache)


def _run_both(ops, n_blocks=12):
    jd, td = _Driver(BOTH[0], n_blocks), _Driver(BOTH[1], n_blocks)
    for i, (op, a, b) in enumerate(ops):
        assert jd.step(op, a, b) == td.step(op, a, b), (i, op, a, b)
    return td


@settings(max_examples=25, deadline=None)
@given(ops=st.lists(st.tuples(st.integers(0, 4), st.integers(0, 11),
                              st.integers(1, 9)), min_size=1, max_size=40))
def test_pool_and_prefix_cache_trace_property(ops):
    _run_both(ops)


SCENARIOS = {
    # register / append / release (test_basic_lifecycle, test_out_of_blocks)
    "lifecycle_oom": [(1, 3, 0), (2, 0, 9), (2, 0, 9), (1, 3, 0), (2, 1, 9),
                      (3, 0, 0), (2, 0, 1)],
    # shared prefix pages survive their donor (refcounted release)
    "refcounted_shared": [(0, 0, 0), (0, 2, 0), (0, 4, 0), (3, 0, 0),
                          (3, 0, 0), (3, 0, 0)],
    # whole-prompt block-aligned match: adopt with COW, then replace COW
    "cow_adopt_and_replace": [(0, 2, 0), (0, 2, 0), (1, 2, 0), (1, 0, 0),
                              (0, 5, 0)],
    # cache-only pages reclaimed on demand before any OOM
    "reclaim_under_pressure": [(0, 3, 0), (0, 9, 0), (3, 0, 0), (3, 0, 0),
                               (0, 1, 0), (0, 5, 0), (0, 6, 0), (2, 0, 8),
                               (4, 0, 2), (0, 4, 0), (0, 10, 0)],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pool_and_prefix_cache_scenarios(name):
    td = _run_both(SCENARIOS[name], n_blocks=8)
    assert td.pool.stats.allocs > 0


def test_scenarios_reach_cow_reclaim_and_oom():
    """The scenarios above are not vacuous: between them they copy on
    write, reclaim cached pages and hit an exhausted arena."""
    cows = reclaimed = ooms = 0
    for ops in SCENARIOS.values():
        td = _run_both(ops, n_blocks=8)
        cows += td.cows
        reclaimed += td.cache.stats.reclaimed_blocks
        ooms += td.pool.stats.oom_events
    assert cows >= 2 and reclaimed > 0 and ooms > 0


def test_numpy_write_gather_roundtrip_matches_reference():
    arenas = []
    for kv, _ in BOTH:
        p = kv.PagedKVPool(n_blocks=8, block_size=4)
        arena = np.zeros((8, 4, 2, 3), np.float32)
        p.register(7)
        vals = np.random.default_rng(0).normal(size=(11, 2, 3))
        for pos in range(11):
            p.append_tokens(7, 1)
            kv.write_kv(arena, p, 7, pos, vals[pos].astype(np.float32))
        arenas.append(kv.gather_kv(arena, p.block_table(7, 8), 11))
    np.testing.assert_array_equal(arenas[0], arenas[1])


# ---------------------------------------------------------------------------
# ring positions
# ---------------------------------------------------------------------------

# the sweep of tests/test_paged_kv.py::test_dense_ring_positions_match_...
RING_SWEEP = [(8, 16, 5, 5), (8, 16, 5, 9), (8, 16, 16, 20), (8, 8, 8, 13),
              (16, 16, 3, 3), (16, 16, 3, 17), (4, 16, 11, 13),
              (48, 16, 9, 14)]


@pytest.mark.parametrize("clen,bw,lp,cur", RING_SWEEP)
def test_ring_positions_match_reference(clen, bw, lp, cur):
    args = [np.array([cur], np.int32), np.array([lp], np.int32),
            np.array([bw], np.int32)]
    want = np.asarray(jkv.dense_ring_positions(*args, clen))
    got = tkv.dense_ring_positions(*[torch.from_numpy(a) for a in args],
                                   clen)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_ring_view_positions_match_reference():
    """Every written length up to three ring wraps, in one batch."""
    clen = 8
    lens = np.arange(0, 3 * clen, dtype=np.int32)
    np.testing.assert_array_equal(
        tkv.ring_view_positions(torch.from_numpy(lens), clen).numpy(),
        np.asarray(jkv.ring_view_positions(lens, clen)))


# ---------------------------------------------------------------------------
# device functions on one numpy arena
# ---------------------------------------------------------------------------

NG, NB, KH, HD, B, CLEN = 2, 9, 2, 4, 4, 32
PATH = ("slot0",)


def _metas(bs=4, n_blocks=NB, clen=CLEN):
    mb = -(-(clen + 1) // bs)
    return (jkv.PagedMeta(((PATH, clen),), bs, n_blocks, mb),
            tkv.PagedMeta(((PATH, clen),), bs, n_blocks, mb))


def _arena(rng, bs=4, n_blocks=NB):
    return {"slot0": {
        k: rng.normal(size=(NG, n_blocks + 1, bs, KH, HD)).astype(np.float32)
        for k in ("k", "v")}}


def _tables(rng, mb, n_blocks=NB, rows=B):
    """Rows of distinct pages from a shuffled arena, -1 padded past each
    row's length; the last row inactive (all -1)."""
    perm = rng.permutation(n_blocks)
    t = np.full((rows, mb), -1, np.int32)
    used = 0
    for r in range(rows - 1):
        n = int(rng.integers(1, min(mb, n_blocks - used) // 2 + 1))
        t[r, :n] = perm[used:used + n]
        used += n
    return t


def _jx(tree):
    return {k: _jx(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else jnp.asarray(tree)


def _tt(tree):
    return {k: _tt(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else torch.from_numpy(np.array(tree))


def _np(tree):
    return {k: _np(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else (v.numpy() if isinstance((v := tree), torch.Tensor)
              else np.asarray(v))


def _assert_trees_equal(want, got, skip_trash=None):
    want, got = _np(want), _np(got)
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_equal(want[k], got[k], skip_trash)
            continue
        w, g = want[k], got[k]
        assert w.dtype == g.dtype and w.shape == g.shape, k
        if skip_trash is not None:
            w, g = w[:, :skip_trash], g[:, :skip_trash]
        np.testing.assert_array_equal(g, w, err_msg=k)


def _decode_inputs(rng, tables, bs):
    """Per-row written lengths inside each row's pages, prompt lengths
    and padded buckets as the engine forms them."""
    n_pages = (tables >= 0).sum(1)
    lengths = np.array([int(rng.integers(1, max(2, p * bs))) if p else 0
                        for p in n_pages], np.int32)
    plens = np.minimum(lengths, rng.integers(1, bs * 2, len(lengths))
                       ).astype(np.int32)
    bw = np.where(plens > 0, np.maximum(plens, 8), 0).astype(np.int32)
    return lengths, plens, bw


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("route", ["index", "gather"])
def test_paged_view_matches_reference(route, seed):
    rng = np.random.default_rng(seed)
    jm, tm = _metas()
    arena = _arena(rng)
    tables = _tables(rng, jm.max_blocks)
    lengths, plens, bw = _decode_inputs(rng, tables, jm.block_size)
    jgather = tgather = None
    if route == "gather":
        def jgather(leaf, t):
            return jops.paged_gather(leaf, t, interpret=True,
                                     use_kernel=True)
        tgather = tops.paged_gather
    want = jkv.paged_view(_jx(arena), jnp.asarray(tables), lengths, plens,
                          bw, jm, page_gather=jgather)
    got = tkv.paged_view(_tt(arena), torch.from_numpy(tables),
                         torch.from_numpy(lengths), torch.from_numpy(plens),
                         torch.from_numpy(bw), tm, page_gather=tgather)
    _assert_trees_equal(want, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_prefill_matches_reference(seed):
    rng = np.random.default_rng(seed)
    jm, tm = _metas()
    arena = _arena(rng)
    tables = _tables(rng, jm.max_blocks)
    bucket = 8
    lengths = rng.integers(1, bucket + 1, B).astype(np.int32)
    pad = np.full((B,), bucket, np.int32)
    mini = {"slot0": {k: rng.normal(size=(NG, B, CLEN, KH, HD)).astype(
        np.float32) for k in ("k", "v")}}
    mini["slot0"]["pos"] = np.zeros((NG, B, CLEN), np.int32)
    slot_idx = np.arange(B, dtype=np.int32)
    want = jkv.scatter_prefill(_jx(arena), _jx(mini), jnp.asarray(tables),
                               lengths, pad, jnp.asarray(slot_idx), jm)
    got = tkv.scatter_prefill(_tt(arena), _tt(mini), torch.from_numpy(tables),
                              torch.from_numpy(lengths), torch.from_numpy(pad),
                              torch.from_numpy(slot_idx), tm)
    _assert_trees_equal(want, got, skip_trash=NB)


@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_decode_matches_reference(seed):
    rng = np.random.default_rng(seed)
    jm, tm = _metas()
    arena = _arena(rng)
    tables = _tables(rng, jm.max_blocks)
    n_pages = (tables >= 0).sum(1)
    pos = np.array([int(rng.integers(0, p * jm.block_size)) if p else 0
                    for p in n_pages], np.int32)
    view = {"slot0": {k: rng.normal(size=(NG, B, CLEN, KH, HD)).astype(
        np.float32) for k in ("k", "v")}}
    view["slot0"]["pos"] = np.zeros((NG, B, CLEN), np.int32)
    want = jkv.scatter_decode(_jx(arena), _jx(view), jnp.asarray(tables),
                              pos, jm)
    got = tkv.scatter_decode(_tt(arena), _tt(view), torch.from_numpy(tables),
                             torch.from_numpy(pos), tm)
    _assert_trees_equal(want, got, skip_trash=NB)


@pytest.mark.parametrize("prefix_len", [4, 8, 6])
def test_gather_prefix_and_scatter_suffix_match_reference(prefix_len):
    rng = np.random.default_rng(prefix_len)
    jm, tm = _metas()
    arena = _arena(rng)
    tables = _tables(rng, jm.max_blocks)
    tables[:, :3] = np.array([[0, 1, 2], [3, 4, 5], [0, 1, 6], [7, 8, 2]])
    want = jkv.gather_prefix(_jx(arena), jnp.asarray(tables), prefix_len, jm)
    got = tkv.gather_prefix(_tt(arena), torch.from_numpy(tables),
                            prefix_len, tm)
    _assert_trees_equal(want, got)

    bucket = 12
    sfx = bucket - prefix_len
    lengths = np.array([12, 9, prefix_len + 1, 11], np.int32)
    mini = {"slot0": {k: rng.normal(size=(NG, B, CLEN, KH, HD)).astype(
        np.float32) for k in ("k", "v")}}
    want = jkv.scatter_suffix(_jx(arena), _jx(mini), jnp.asarray(tables),
                              lengths, prefix_len, sfx, jm)
    got = tkv.scatter_suffix(_tt(arena), _tt(mini), torch.from_numpy(tables),
                             torch.from_numpy(lengths), prefix_len, sfx, tm)
    _assert_trees_equal(want, got, skip_trash=NB)


def test_copy_block_matches_reference():
    rng = np.random.default_rng(5)
    jm, tm = _metas()
    arena = _arena(rng)
    want = jkv.copy_block(_jx(arena), jnp.int32(3), jnp.int32(7), jm)
    got = tkv.copy_block(_tt(arena), 3, 7, tm)
    _assert_trees_equal(want, got)


def test_build_arena_and_meta_match_reference():
    """A dense cache template maps to the same meta and arena shapes; the
    bridged arena tree (no 'pos' leaf) crosses with its dtypes."""
    from repro_torch import bridge

    dense = {"slot0": {
        "k": np.zeros((NG, B, CLEN, KH, HD), np.float32),
        "v": np.zeros((NG, B, CLEN, KH, HD), np.float32),
        "pos": np.full((NG, B, CLEN), -1, np.int32)}}
    jm = jkv.paged_meta(_jx(dense), NB, 4, CLEN)
    tm = tkv.paged_meta(_tt(dense), NB, 4, CLEN)
    assert tuple(jm) == tuple(tm)
    assert tkv.prefix_unsupported_reason(_tt(dense), CLEN) is None
    assert "window-local" in tkv.prefix_unsupported_reason(_tt(dense),
                                                           CLEN + 1)
    ja = jkv.build_arena(_jx(dense), jm)
    ta = tkv.build_arena(_tt(dense), tm)
    _assert_trees_equal(ja, ta)
    crossed = bridge.cache_from_numpy(_np(ja))
    assert crossed.keys() == ta.keys() and "pos" not in crossed["slot0"]
    _assert_trees_equal(ja, crossed)
