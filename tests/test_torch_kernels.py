"""PyTorch port's SGMV path vs the JAX package's (Pallas in interpret
mode) on the same numpy inputs.

On the CPU the port's wrappers run their kernels' plain versions, so
these tests hold the port's grouping plan, padded-buffer layout, plain
shrink/expand arithmetic, scatter, scale and cast against the reference.
The CUDA kernels themselves are compared with the plain versions on the
card by ``chip_smoke.py`` and by the ``cuda``-marked test below.
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
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sgmv as jsgmv  # noqa: E402
from repro_torch.kernels import ops, ref, sgmv  # noqa: E402

# the reference's grouping sweep (tests/test_kernels.py)
SWEEP = [(16, 128, 128, 8, 2, 8), (64, 256, 512, 16, 4, 16),
         (37, 384, 256, 32, 5, 8), (128, 512, 384, 16, 8, 32)]


def _assert_plans_equal(slots: np.ndarray, n_slots: int, blk_t: int):
    pj = jops.plan_grouping(jnp.asarray(slots), n_slots, blk_t)
    pt = ops.plan_grouping(torch.from_numpy(slots), n_slots, blk_t)
    np.testing.assert_array_equal(np.asarray(pj.padded_pos),
                                  pt.padded_pos.numpy())
    np.testing.assert_array_equal(np.asarray(pj.perm), pt.perm.numpy())
    np.testing.assert_array_equal(np.asarray(pj.block_slots),
                                  pt.block_slots.numpy())
    assert pj.n_padded == pt.n_padded


@pytest.mark.parametrize("t,d_in,d_out,r,n_slots,blk_t", SWEEP)
def test_plan_grouping_matches_reference(t, d_in, d_out, r, n_slots, blk_t):
    rng = np.random.default_rng(42)
    _assert_plans_equal(rng.integers(0, n_slots, t).astype(np.int32),
                        n_slots, blk_t)


@settings(max_examples=10, deadline=None)
@given(t=st.integers(1, 40), n_slots=st.integers(1, 6),
       blk_t=st.sampled_from([8, 16]), seed=st.integers(0, 2**31 - 1))
def test_plan_grouping_property(t, n_slots, blk_t, seed):
    """Any slot vector: the port's plan equals the reference's exactly."""
    rng = np.random.default_rng(seed)
    _assert_plans_equal(rng.integers(0, n_slots, t).astype(np.int32),
                        n_slots, blk_t)


@pytest.mark.parametrize("t,r,n_slots", [(8, 4, 4), (37, 32, 5),
                                         (64, 4, 20)])
def test_auto_blk_t_matches_reference(t, r, n_slots):
    assert ops.auto_blk_t(t, n_slots) == jops.auto_blk_t(t, n_slots)


def _inputs(dtype, t, d_in, d_out, r, n_slots, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(t, d_in)).astype(np.float32)
    a = rng.normal(size=(n_slots, r, d_in)).astype(np.float32)
    b = rng.normal(size=(n_slots, d_out, r)).astype(np.float32)
    slots = rng.integers(0, n_slots, t).astype(np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    # round once through JAX so both sides see the same bf16 values
    j = [jnp.asarray(v, jd) for v in (x, a, b)]
    td = getattr(torch, dtype)
    tt = [torch.from_numpy(np.array(v, np.float32)).to(td) for v in j]
    return j, tt, slots


# f32: both sides accumulate in f32 in different orders (rtol 1e-5).
# bf16: the two round the f32 result to bf16 at the end; a 1-ulp flip
# of bf16 is 2^-8 relative, so 2e-2 covers accumulation-order flips.
TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t,d_in,d_out,r,n_slots,blk_t", [
    (16, 128, 96, 4, 3, 8),
    (37, 256, 128, 32, 5, None),     # ragged T, auto block size
    (8, 128, 256, 32, 20, None),     # decode-like: T ≈ R
])
def test_sgmv_matches_reference(dtype, t, d_in, d_out, r, n_slots, blk_t):
    (xj, aj, bj), (xt, at, bt), slots = _inputs(dtype, t, d_in, d_out, r,
                                                n_slots)
    yj = jops.sgmv(xj, aj, bj, jnp.asarray(slots), 0.5, n_slots=n_slots,
                   blk_t=blk_t, interpret=True)
    y_ref = (0.5 * jref.sgmv_ref(xj, aj, bj, jnp.asarray(slots), 1.0)
             ).astype(xj.dtype)
    yt = ops.sgmv(xt, at, bt, torch.from_numpy(slots), 0.5, n_slots=n_slots,
                  blk_t=blk_t)
    assert yt.dtype == getattr(torch, dtype) and yt.shape == (t, d_out)
    got = yt.float().numpy()
    scale = float(np.abs(np.asarray(y_ref, np.float32)).max())
    for want in (yj, y_ref):
        want = np.asarray(want, np.float32) / scale
        np.testing.assert_allclose(got / scale, want, **TOL[dtype])


def test_sgmv_f32_pool_bf16_x_rounds_like_reference_cast():
    """An f32 pool with bf16 x: the port rounds each weight to bf16 in the
    kernel; the reference casts the pool to x.dtype first (lora.py)."""
    (xj, aj, bj), (xt, _, _), slots = _inputs("bfloat16", 24, 128, 64, 8, 3)
    rng = np.random.default_rng(1)
    a32 = rng.normal(size=(3, 8, 128)).astype(np.float32)
    b32 = rng.normal(size=(3, 64, 8)).astype(np.float32)
    yj = jops.sgmv(xj, jnp.asarray(a32).astype(jnp.bfloat16),
                   jnp.asarray(b32).astype(jnp.bfloat16), jnp.asarray(slots),
                   2.0, n_slots=3, blk_t=None, interpret=True)
    yt = ops.sgmv(xt, torch.from_numpy(a32), torch.from_numpy(b32),
                  torch.from_numpy(slots), 2.0, n_slots=3, blk_t=None)
    want = np.asarray(yj, np.float32)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(yt.float().numpy() / scale, want / scale,
                               **TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r", [4, 32])
def test_plain_shrink_expand_match_pallas_on_padded_buffer(dtype, r):
    """Same padded buffer and block_slots into the Pallas kernels
    (interpret mode) and the port's plain versions."""
    t, d_in, d_out, n_slots = 21, 256, 128, 4
    (xj, aj, bj), (xt, at, bt), slots = _inputs(dtype, t, d_in, d_out, r,
                                                n_slots, seed=3)
    blk_t = ops.auto_blk_t(t, n_slots)
    plan = jops.plan_grouping(jnp.asarray(slots), n_slots, blk_t)
    xbuf = jnp.zeros((plan.n_padded, d_in), xj.dtype).at[
        plan.padded_pos].set(xj[plan.perm])
    bs = np.asarray(plan.block_slots)
    sj = jsgmv.sgmv_shrink(xbuf, aj, plan.block_slots, blk_t=blk_t,
                           blk_d=128, interpret=True)
    yj = jsgmv.sgmv_expand(sj, bj, plan.block_slots, blk_t=blk_t, blk_d=128,
                           interpret=True)
    xbuf_t = torch.from_numpy(np.array(xbuf, np.float32)).to(xt.dtype)
    bs_t = torch.from_numpy(bs)
    st_ = sgmv.sgmv_shrink(xbuf_t, at, bs_t, blk_t=blk_t)
    yt = sgmv.sgmv_expand(torch.from_numpy(np.array(sj)), bt, bs_t,
                          blk_t=blk_t, compute_dtype=xt.dtype)
    assert st_.dtype == torch.float32 and yt.dtype == torch.float32
    # the per-token oracles of kernels/ref.py on the same buffer
    token_slots = bs_t.long().repeat_interleave(blk_t)
    s_ref = ref.sgmv_shrink_ref(xbuf_t, at.to(xt.dtype), token_slots)
    y_ref = ref.sgmv_expand_ref(torch.from_numpy(np.array(sj)),
                                bt.to(xt.dtype), token_slots)
    for got, want in ((st_, sj), (yt, yj), (s_ref, sj), (y_ref, yj)):
        want = np.asarray(want, np.float32)
        scale = float(np.abs(want).max())
        # f32 products of bf16-exact inputs on both sides
        np.testing.assert_allclose(got.numpy() / scale, want / scale,
                                   rtol=1e-5, atol=1e-5)


def test_launch_counters_stay_zero_on_cpu():
    sgmv.reset_launches()
    (_, _, _), (xt, at, bt), slots = _inputs("float32", 16, 64, 32, 4, 3)
    ops.sgmv(xt, at, bt, torch.from_numpy(slots), 1.0, n_slots=3, blk_t=8)
    assert sgmv.launches == {"sgmv_shrink": 0, "sgmv_expand": 0}


def test_wrappers_reject_bad_shapes():
    x = torch.zeros(12, 64)
    with pytest.raises(ValueError, match="multiple of blk_t"):
        sgmv.sgmv_shrink(x, torch.zeros(2, 4, 64),
                         torch.zeros(1, dtype=torch.int32), blk_t=8)
    with pytest.raises(ValueError, match="block_slots"):
        sgmv.sgmv_expand(torch.zeros(16, 4), torch.zeros(2, 32, 4),
                         torch.zeros(3, dtype=torch.int32), blk_t=8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernels_match_plain(dtype):
    """The CUDA kernels against their plain versions on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    (_, _, _), (xt, at, bt), slots = _inputs(dtype, 40, 1000, 333, 32, 5)
    xt, at, bt = xt.to(dev), at.float().to(dev), bt.float().to(dev)
    slots_t = torch.from_numpy(slots).to(dev)
    blk_t = ops.auto_blk_t(40, 5)
    plan = ops.plan_grouping(slots_t, 5, blk_t)
    xbuf = xt.new_zeros((plan.n_padded, 1000))
    xbuf[plan.padded_pos.long()] = xt[plan.perm]
    s = sgmv.sgmv_shrink(xbuf, at, plan.block_slots, blk_t=blk_t)
    y = sgmv.sgmv_expand(s, bt, plan.block_slots, blk_t=blk_t,
                         compute_dtype=xt.dtype)
    s_ref = sgmv.shrink_plain(xbuf, at, plan.block_slots, blk_t=blk_t)
    y_ref = sgmv.expand_plain(s, bt, plan.block_slots, blk_t=blk_t,
                              compute_dtype=xt.dtype)
    torch.cuda.synchronize()
    for got, want in ((s, s_ref), (y, y_ref)):
        err = ((got - want).abs().max() / want.abs().max()).item()
        assert err < 1e-5, err
