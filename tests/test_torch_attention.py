"""PyTorch port's attention kernels (``flash_decode``, ``flash_prefill``)
and their route through the model and the engine vs the JAX package.

On the CPU the kernel wrappers run their plain versions; the CUDA
kernels themselves are held against those plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

* Kernels, on numpy inputs handed to both packages, at the reference's
  sweeps (``tests/test_kernels.py``): ``flash_decode`` with a scalar
  ``q_pos`` against the Pallas kernel (interpret mode) and
  ``ref.decode_attention_ref``; with per-row ``q_pos`` and fully empty
  rows against the reference model's ``decode_attention``; int8 K/V
  against the Pallas kernel with scales from the reference's
  ``_quantize_kv``. ``flash_prefill`` at ``arange`` positions against the
  Pallas kernel, with offset query positions over more keys than queries
  (a suffix prefill) against ``blockwise_attention``, and at GQA group
  sizes 1, 2 and 4. Tolerances as the reference tests state them: 1e-5
  in f32, 3e-2 in bf16 (rtol, with atol ten times that).
* The traps: a row whose keys are all masked is the mean of V over its
  entries (the finite -1e30 sentinel), not zero or NaN; chunk indices
  floor-divide positions.
* Model (reduced Llama-3.1-8B, f32, ``attn_kernel=True``): ``prefill``,
  ``decode_step``, ``decode_step_paged`` and ``prefill_suffix`` match the
  JAX model within 1e-4 · max|ref|; in bf16 the kernel route keeps the
  probabilities in f32 and matches the plain route within 3e-2 of
  max|logit|.
* Engine (``_FakeTime``, f32, ``attn_kernel=True``): token streams and
  the whole ``ServingSummary`` equal the reference engine's, dense,
  paged, and paged with the prefix cache and chunked prefill.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import reduced_config as jax_reduced_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import flash_decode as jax_flash_decode  # noqa: E402
from repro.kernels.flash_prefill import flash_prefill as jax_flash_prefill  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.serving import engine as jax_engine  # noqa: E402
from repro.serving import workload as jax_workload  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config, reduced_config  # noqa: E402
from repro_torch.kernels import decode_attention as tdec  # noqa: E402
from repro_torch.kernels import flash_prefill as tpre  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import workload  # noqa: E402
from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig  # noqa: E402
from test_torch_engine import (  # noqa: E402
    _FakeTime, _configs, _engine_kwargs, _summary_json, weights)
from test_torch_model import (  # noqa: E402
    BUCKET, F32_TOL, LENGTHS, MAX_CTX, TOKENS_B, Pair, rel_err)
from test_torch_paged import (  # noqa: E402
    BS, SYS_LEN, CHUNK, _donor_arena, _jmode, _metas, _streams, _tables,
    _trace_fn)

assert weights  # the engine tests' module fixture, reused here

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def _pair_of(x, dtype):
    """A numpy array as (torch tensor, jax array) of one dtype, holding the
    same values (rounded once, by torch)."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(DTYPES[dtype][0])
    return t, jnp.asarray(t.float().numpy(), DTYPES[dtype][1])


def _f32(x):
    return np.asarray(x.float() if torch.is_tensor(x) else x, np.float32)


def _close(got, want, dtype):
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol,
                               atol=tol * 10)


def _jcfg(kind_kw):
    cfg = jax_reduced_config(jax_get_config("llama3-8b"))
    return dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn,
                                                             **kind_kw))


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

# the reference's sweep: plain, softcap, sliding window, chunked window
DECODE_CASES = [
    (2, 8, 2, 64, 128, 32, None, False, None),
    (1, 4, 4, 32, 64, 16, None, False, 50.0),
    (3, 8, 2, 64, 256, 64, 64, False, None),
    (2, 4, 1, 64, 128, 32, 32, True, None),
]


def _decode_inputs(b, h, kh, hd, c, dtype, seed=7):
    rng = np.random.default_rng(seed)
    q = _pair_of(rng.normal(size=(b, h, hd)), dtype)
    k = _pair_of(rng.normal(size=(b, c, kh, hd)), dtype)
    v = _pair_of(rng.normal(size=(b, c, kh, hd)), dtype)
    return q, k, v


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("b,h,kh,hd,c,blk_c,window,chunked,softcap",
                         DECODE_CASES)
def test_flash_decode_scalar_qpos_matches_reference(dtype, b, h, kh, hd, c,
                                                    blk_c, window, chunked,
                                                    softcap):
    (tq, jq), (tk, jk), (tv, jv) = _decode_inputs(b, h, kh, hd, c, dtype)
    kv_pos = np.broadcast_to(np.arange(c), (b, c)).astype(np.int32)
    kv_pos = np.where(kv_pos < c - 10, kv_pos, -1).astype(np.int32)
    qpos = c - 11
    kw = dict(window=window, chunked=chunked, softcap=softcap)
    tdec.reset_launches()
    got = tdec.flash_decode(tq, tk, tv, torch.from_numpy(kv_pos), qpos, **kw)
    assert tdec.launches == {"flash_decode": 0}   # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == (b, h, hd)
    jpos = jnp.asarray(kv_pos)
    want = jax_flash_decode(jq, jk, jv, jpos, jnp.int32(qpos), blk_c=blk_c,
                            interpret=True, **kw)
    _close(got, want, dtype)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jpos, jnp.int32(qpos),
                                          **kw), dtype)
    # ops' oracle route is the port's ref, the same function
    _close(tops.decode_attention(tq, tk, tv, torch.from_numpy(kv_pos), qpos,
                                 use_kernel=False, **kw), want, dtype)


# kind kwargs of the reference model's mask for each sweep case
DECODE_KINDS = [
    ("global", {}, None, False),
    ("global", {"attn_logit_softcap": 50.0}, None, False),
    ("local", {"sliding_window": 24}, 24, False),
    ("local", {"sliding_window": 16, "chunked_local": True}, 16, True),
]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,kind_kw,window,chunked", DECODE_KINDS)
def test_flash_decode_per_row_qpos_matches_model(dtype, kind, kind_kw, window,
                                                 chunked):
    """Per-row positions over a wrapped ring, a half-filled ring, and two
    empty rows (all -1: idle decode rows, trash-page rows), against the
    reference model's ``decode_attention``."""
    b, h, kh, hd, c = 4, 8, 2, 32, 48
    (tq, jq), (tk, jk), (tv, jv) = _decode_inputs(b, h, kh, hd, c, dtype, 11)
    kv_pos = np.full((b, c), -1, np.int32)
    kv_pos[0] = np.arange(c, 2 * c)   # wrapped: position p at index p % c
    kv_pos[1, :20] = np.arange(20)
    qpos = np.array([2 * c - 1, 19, 5, 0], np.int32)
    jcfg = _jcfg(kind_kw)
    want = jattn.decode_attention(
        jq, {"k": jk, "v": jv, "pos": jnp.asarray(kv_pos)},
        jnp.asarray(qpos), kind=kind, cfg=jcfg)
    got = tdec.flash_decode(tq, tk, tv, torch.from_numpy(kv_pos),
                            torch.from_numpy(qpos), window=window,
                            chunked=chunked,
                            softcap=kind_kw.get("attn_logit_softcap"))
    _close(got, want, dtype)
    # the empty rows: the mean of V over the whole ring, per kv head
    g = h // kh
    mean = tv.float().mean(dim=1).repeat_interleave(g, dim=1)   # [b, h, hd]
    for row in (2, 3):
        _close(got[row], mean[row].to(tq.dtype), dtype)
        assert torch.isfinite(got[row].float()).all()


def test_flash_decode_int8_matches_reference_kernel():
    """int8 K/V with per-(token, head) scales from the reference's
    ``_quantize_kv``: the plain version dequantises exactly as the Pallas
    kernel does in its tiles."""
    rng = np.random.default_rng(3)
    b, h, kh, hd, c = 2, 8, 2, 64, 128
    q = jnp.asarray(rng.normal(size=(b, h, hd)), jnp.float32)
    kq, ks = jattn._quantize_kv(jnp.asarray(rng.normal(size=(b, c, kh, hd)),
                                            jnp.float32))
    vq, vs = jattn._quantize_kv(jnp.asarray(rng.normal(size=(b, c, kh, hd)),
                                            jnp.float32))
    pos = np.broadcast_to(np.arange(c), (b, c)).astype(np.int32)
    pos = np.where(np.arange(c) < c - 7, pos, -1).astype(np.int32)
    want = jax_flash_decode(q, kq, vq, jnp.asarray(pos), jnp.int32(c - 9),
                            k_scale=ks, v_scale=vs, blk_c=32, interpret=True)
    t = {n: torch.from_numpy(np.array(a)) for n, a in
         dict(q=q, kq=kq, vq=vq, ks=ks, vs=vs).items()}
    assert t["kq"].dtype == torch.int8
    got = tdec.flash_decode(t["q"], t["kq"], t["vq"], torch.from_numpy(pos),
                            c - 9, k_scale=t["ks"], v_scale=t["vs"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


def test_chunk_index_floors_positions():
    """Chunked windows floor-divide positions: without the causal mask a
    query at -1 lies in chunk -1 and sees no key, where C's truncating
    division would put it in chunk 0 with keys 0..3."""
    q = torch.ones(1, 2, 1, 32)
    k = torch.zeros(1, 4, 1, 32)
    v = torch.arange(4.0)[None, :, None, None].expand(1, 4, 1, 32)
    out = tpre.flash_prefill(q, k, v, qpos=torch.tensor([-1, 2]),
                             kpos=torch.tensor([0, 1, 2, 5]), causal=False,
                             window=4, chunked=True)
    # row -1: no key visible, the sentinel mean over all four entries;
    # row 2: keys 0, 1, 2 (position 5 is in chunk 1)
    torch.testing.assert_close(out[0, :, 0], torch.tensor(
        [[1.5] * 32, [1.0] * 32]))


@pytest.mark.parametrize("b,kh,c,g,hd,itemsize", [
    (8, 8, 256, 4, 128, 2),       # the main path's decode step
    (2, 2, 128, 4, 64, 4), (3, 2, 200, 4, 128, 1), (1, 1, 37, 8, 256, 4),
    (2, 8, 257, 4, 128, 2), (1, 1, 10, 4, 32, 2), (8, 8, 8192, 4, 128, 2),
    (1, 4, 4096, 8, 256, 4), (64, 8, 256, 4, 128, 2)])
def test_decode_split_plan_covers_the_ring(b, kh, c, g, hd, itemsize):
    """The decode kernel's split plan: contiguous splits that cover C
    exactly with none empty, at least two CTAs per SM of an H100 wherever
    C has enough keys, and a split's shared memory within the budget."""
    keys, n = tdec.split_plan(b, kh, c, g, hd, itemsize)
    assert keys >= 1 and (n - 1) * keys < c <= n * keys
    per_key = 2 * hd * itemsize + 16 + 4 * g + 4 + 8 * (itemsize == 1)
    assert 4 * g * (hd + 2) + keys * per_key <= tdec.SPLIT_SMEM
    if c >= tdec.MIN_SPLIT_KEYS * -(-tdec.SPLIT_CTAS // (b * kh)):
        assert b * kh * n >= tdec.SPLIT_CTAS
    if (b, kh, c) == (8, 8, 256):
        assert (keys, n) == (52, 5) and b * kh * n >= 2 * 132


def _split_decode_np(q, k, v, kv_pos, q_pos, keys, window=None,
                     chunked=False, softcap=None):
    """The decode kernel's algorithm in numpy: the ring cut into splits of
    ``keys`` entries; each split's (m, l, acc) with the finite -1e30
    sentinel, an invisible split skipped (m = -1e30, l = 0) only when its
    row has a visible key elsewhere; the partials merged in split order.
    Returns the output and the number of splits skipped."""
    b, h, hd = q.shape
    c, kh = k.shape[1], k.shape[2]
    g = h // kh
    valid = (kv_pos >= 0) & (kv_pos <= q_pos)
    if window is not None:
        valid &= ((q_pos // window) == (kv_pos // window) if chunked
                  else (q_pos - kv_pos) < window)
    out = np.empty((b, h, hd), np.float32)
    skipped = 0
    for bi in range(b):
        for kj in range(kh):
            qg = q[bi, kj * g:(kj + 1) * g]
            parts = []
            for c0 in range(0, c, keys):
                sl = slice(c0, min(c, c0 + keys))
                if not valid[bi, sl].any() and valid[bi].any():
                    parts.append((np.full(g, -1e30, np.float32),
                                  np.zeros(g, np.float32), None))
                    skipped += 1
                    continue
                s = (qg @ k[bi, sl, kj].T) * np.float32(hd ** -0.5)
                if softcap is not None:
                    s = np.tanh(s / softcap) * softcap
                s = np.where(valid[bi, sl], s, np.float32(-1e30))
                m = s.max(1)
                p = np.exp(s - m[:, None])
                parts.append((m, p.sum(1), p @ v[bi, sl, kj]))
            m = np.full(g, -1e30, np.float32)
            for ms, _, _ in parts:
                m = np.maximum(m, ms)
            l = np.zeros(g, np.float32)
            acc = np.zeros((g, hd), np.float32)
            for ms, ls, accs in parts:
                if accs is None:
                    continue
                w = np.exp(ms - m)
                l += w * ls
                acc += w[:, None] * accs
            out[bi, kj * g:(kj + 1) * g] = acc / np.maximum(l, 1e-30)[:, None]
    return out, skipped


@pytest.mark.parametrize("keys,c,window,chunked,softcap", [
    (None, 256, None, False, None),     # split_plan's own split
    (7, 48, None, False, None),         # many splits, a ragged last one
    (5, 23, 8, False, 30.0),            # sliding window, softcap
    (16, 40, 16, True, None),           # chunked window
    (48, 48, None, False, None),        # one split: no merge
])
def test_decode_split_combine_matches_reference(keys, c, window, chunked,
                                                softcap):
    """The split-and-merge rule the decode kernel implements, against the
    JAX reference's decode oracle on seeded numpy inputs: a row that sees
    only the last split, a row that sees no key anywhere (the mean of V
    over every split), a row with a fully masked first split; f32 within
    1e-5."""
    b, h, kh, hd = 4, 8, 2, 32
    rng = np.random.default_rng(17)
    q = rng.normal(size=(b, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, c, kh, hd)).astype(np.float32)
    v = rng.normal(size=(b, c, kh, hd)).astype(np.float32)
    if keys is None:
        keys, _ = tdec.split_plan(8, 8, c, h // kh, hd, 4)
    q_pos = c + 10
    kv_pos = np.full((b, c), -1, np.int32)
    kv_pos[0] = np.arange(c)                          # all visible
    kv_pos[1, -3:] = [c + 8, c + 9, c + 10]           # only in the last split
    kv_pos[2] = c + 11 + np.arange(c)                 # none: future positions
    kv_pos[3, keys:] = np.arange(keys, c)             # first split empty
    got, skipped = _split_decode_np(q, k, v, kv_pos, np.int32(q_pos), keys,
                                    window, chunked, softcap)
    want = jref.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(kv_pos),
        jnp.int32(q_pos), window=window, chunked=chunked, softcap=softcap)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    mean = v[2].mean(0).repeat(h // kh, 0)            # [h, hd]
    np.testing.assert_allclose(got[2], mean, rtol=1e-5, atol=1e-5)
    if c > keys:
        assert skipped > 0     # invisible splits of rows with keys skip
    # the port's plain version agrees (the kernel is held to it on the card)
    tgot = tdec.flash_decode_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_pos), q_pos, window=window, chunked=chunked,
        softcap=softcap)
    np.testing.assert_allclose(tgot.numpy(), got, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# flash_prefill
# ---------------------------------------------------------------------------

# the reference's four masks
PREFILL_KINDS = [
    ("global", {}),
    ("local", {"sliding_window": 16}),
    ("local", {"sliding_window": 16, "chunked_local": True}),
    ("global", {"attn_logit_softcap": 30.0}),
]


def _mask_kw(kind_kw):
    return dict(window=kind_kw.get("sliding_window"),
                chunked=kind_kw.get("chunked_local", False),
                softcap=kind_kw.get("attn_logit_softcap"))


def _prefill_inputs(b, sq, skv, h, kh, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    return (_pair_of(rng.normal(size=(b, sq, h, hd)), dtype),
            _pair_of(rng.normal(size=(b, skv, kh, hd)), dtype),
            _pair_of(rng.normal(size=(b, skv, kh, hd)), dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,kind_kw", PREFILL_KINDS)
def test_flash_prefill_matches_reference_kernel(dtype, kind, kind_kw):
    b, s, h, kh, hd = 2, 64, 4, 2, 32
    (tq, jq), (tk, jk), (tv, jv) = _prefill_inputs(b, s, s, h, kh, hd, dtype)
    kw = _mask_kw(kind_kw)
    tpre.reset_launches()
    got = tpre.flash_prefill(tq, tk, tv, causal=True, **kw)
    assert tpre.launches == {"flash_prefill": 0}   # CPU: the plain version
    assert got.dtype == tq.dtype and got.shape == (b, s, h, hd)
    want = jax_flash_prefill(jq, jk, jv, causal=True, blk_q=16, blk_kv=16,
                             interpret=True, **kw)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind,kind_kw", PREFILL_KINDS)
def test_flash_prefill_offset_positions_match_blockwise(dtype, kind,
                                                        kind_kw):
    """A suffix prefill: 24 queries at positions 40..63 over the 40 cached
    prefix keys followed by the 24 fresh ones, against the reference
    model's ``blockwise_attention`` (the function the kernel route
    replaces in the model)."""
    b, p, sq, h, kh, hd = 2, 40, 24, 4, 2, 32
    (tq, jq), (tk, jk), (tv, jv) = _prefill_inputs(b, sq, p + sq, h, kh, hd,
                                                   dtype, seed=1)
    qpos = np.arange(p, p + sq, dtype=np.int32)
    kpos = np.arange(p + sq, dtype=np.int32)
    want = jattn.blockwise_attention(jq, jk, jv, jnp.asarray(qpos),
                                     jnp.asarray(kpos), kind=kind,
                                     cfg=_jcfg(kind_kw), block_q=8,
                                     block_kv=16)
    got = tops.flash_prefill(tq, tk, tv, qpos=torch.from_numpy(qpos),
                             kpos=torch.from_numpy(kpos), causal=True,
                             **_mask_kw(kind_kw))
    _close(got, want, dtype)


@pytest.mark.parametrize("g", [1, 2, 4])
def test_flash_prefill_gqa_groups_match_reference_kernel(g):
    """Head h reads kv head h // g (the reference kernel copies K/V g
    times instead)."""
    b, s, kh, hd = 1, 32, 2, 64
    (tq, jq), (tk, jk), (tv, jv) = _prefill_inputs(b, s, s, g * kh, kh, hd,
                                                   "float32", seed=g)
    got = tpre.flash_prefill(tq, tk, tv)
    want = jax_flash_prefill(jq, jk, jv, blk_q=16, blk_kv=16, interpret=True)
    _close(got, want, "float32")
    # head h against kv head h // g alone
    h0 = tpre.flash_prefill(tq[:, :, g:g + 1], tk[:, :, 1:2], tv[:, :, 1:2])
    torch.testing.assert_close(got[:, :, g:g + 1], h0)


def test_flash_prefill_row_without_keys_is_sentinel_mean():
    """Keys at positions the queries cannot see (and one empty entry):
    every row is the mean of V over all Skv entries, as softmax over the
    finite -1e30 gives; never zero or NaN."""
    q = torch.randn(1, 3, 2, 32)
    k = torch.randn(1, 5, 1, 32)
    v = torch.randn(1, 5, 1, 32)
    out = tpre.flash_prefill(q, k, v, qpos=torch.tensor([0, 1, 2]),
                             kpos=torch.tensor([7, 8, 9, -1, 10]))
    mean = v.mean(dim=1, keepdim=True).expand(1, 3, 2, 32)
    torch.testing.assert_close(out, mean)


# ---------------------------------------------------------------------------
# model: the kernel route on the reduced Llama, f32 and bf16
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kpair():
    """The model pair of ``test_torch_model`` with the port's attention
    routed through the kernel wrappers."""
    p = Pair("float32")
    p.tm.attn_kernel = True
    return p


def test_model_kernel_route_prefill_and_decode_match_reference(kpair):
    p = kpair
    (jl, jc), (tl, tc) = p.prefill("einsum")
    assert rel_err(tl.numpy(), jl) <= F32_TOL
    tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    pos = LENGTHS.copy()
    for _ in range(3):
        (jl, jc), (tl, tc) = p.decode("einsum", jc, tc, tokens, pos)
        assert rel_err(tl.numpy(), jl) <= F32_TOL
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1


def test_model_kernel_route_paged_decode_and_suffix_match_reference(kpair):
    p = kpair
    jm, tm = _metas()
    # decode_step_paged: the ordinary decode over the paged view
    lengths = np.array([16, 9, 5], np.int32)
    tables = _tables(lengths, extra=2)
    ja, ta, _ = _donor_arena(p, "sgmv", lengths, tables, jm)
    jstep = jax.jit(functools.partial(
        p.jm.decode_step_paged, lora_mode=_jmode(p, "sgmv"), meta=jm,
        page_gather=None))
    tokens = np.random.default_rng(4).integers(
        0, p.cfg.vocab_size, TOKENS_B).astype(np.int32)
    pos, pad = lengths.copy(), np.full(TOKENS_B, BUCKET, np.int32)
    for _ in range(2):
        jl, ja = jstep(p.jp, jnp.asarray(tokens), ja, jnp.asarray(tables),
                       jnp.asarray(pos), jnp.asarray(lengths),
                       jnp.asarray(pad), jnp.asarray(pos), lora=p.jpool)
        tl, ta = p.tm.decode_step_paged(
            p.tp, torch.from_numpy(tokens), ta, torch.from_numpy(tables),
            torch.from_numpy(pos), torch.from_numpy(lengths),
            torch.from_numpy(pad), torch.from_numpy(pos), p.tpool,
            p.mode("sgmv"), meta=tm,
            page_gather=functools.partial(tops.paged_gather,
                                          use_kernel=True))
        assert rel_err(tl.numpy(), jl) <= F32_TOL
        tokens = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
        pos = pos + 1
    # prefill_suffix: queries at positions [BS, 16) over prefix + suffix
    lengths = np.array([16, 13, 9], np.int32)
    tables = _tables(lengths, extra=1)
    ja, ta, _ = _donor_arena(p, "einsum", lengths, tables, jm)
    sfx = np.ascontiguousarray(p.tokens[:, BS:])
    jl, _ = jax.jit(functools.partial(
        p.jm.prefill_suffix, prefix_len=BS, lora_mode=_jmode(p, "einsum"),
        meta=jm))(p.jp, jnp.asarray(sfx), p.jm.init_cache(TOKENS_B, MAX_CTX),
                  ja, jnp.asarray(tables), jnp.asarray(lengths), lora=p.jpool)
    tl, _ = p.tm.prefill_suffix(
        p.tp, torch.from_numpy(sfx), p.tm.init_cache(TOKENS_B, MAX_CTX), ta,
        torch.from_numpy(tables), torch.from_numpy(lengths), BS, p.tpool,
        p.mode("einsum"), meta=tm)
    assert rel_err(tl.numpy(), jl) <= F32_TOL


def test_model_kernel_route_bf16_within_logit_tolerance():
    """bf16: the kernel route keeps p in f32 where the plain route rounds
    it to V's dtype (as the reference model does), so the routes differ
    by rounding only: within 3e-2 of max|logit| (the bf16 model
    tolerance of ``test_torch_model``), prefill and one decode step."""
    cfg = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                              dtype="bfloat16")
    plain = build_model(cfg, "cpu")
    params = plain.init(torch.Generator().manual_seed(0))
    kern = build_model(cfg, "cpu", attn_kernel=True)
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (TOKENS_B, BUCKET)).astype(np.int32))
    lengths = torch.from_numpy(LENGTHS)
    out = {}
    for name, m in (("plain", plain), ("kernel", kern)):
        lp, cache = m.prefill(params, {"tokens": tokens},
                              m.init_cache(TOKENS_B, MAX_CTX),
                              lengths=lengths)
        ld, _ = m.decode_step(params, torch.argmax(lp, -1).int(), cache,
                              lengths.int())
        out[name] = (lp.float(), ld.float())
    for got, want in zip(out["kernel"], out["plain"]):
        assert 0 < rel_err(got.numpy(), want.numpy()) <= 3e-2


# ---------------------------------------------------------------------------
# engine: streams and summary with attn_kernel=True
# ---------------------------------------------------------------------------


def _serve_kernel_route(monkeypatch, weights, policy, trace_fn, **ekw):
    """The reference engine and the port's with ``attn_kernel=True`` on
    one trace under the fake timer."""
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
    teng = EdgeLoRAEngine(
        tcfg, EngineConfig(**_engine_kwargs(tcfg, policy), attn_kernel=True,
                           **ekw),
        params=bridge.tree_from_numpy(params), device="cpu",
        adapter_source=lambda aid: bridge.lora_pool_from_numpy(
            adapters[aid]),
        timer=_FakeTime())
    assert teng.attn_kernel is True and teng.model.attn_kernel is True
    ttrace = trace_fn(workload, tcfg)
    tsum = teng.serve(ttrace)
    assert jsum.n_completed == jsum.n_requests == len(jtrace) >= 6
    assert _streams(jtrace) == _streams(ttrace)
    assert _summary_json(jsum) == _summary_json(tsum)
    return jsum, teng


@pytest.mark.parametrize("case", ["dense", "paged", "prefix_chunk"])
def test_engine_kernel_route_matches_reference(monkeypatch, weights, case):
    policy, trace_fn, ekw = "edgelora", _trace_fn(), {}
    if case == "paged":
        policy, ekw = "edgelora_no_aas", dict(kv_backend="paged")
    elif case == "prefix_chunk":
        trace_fn = _trace_fn(duration=0.3, system_prompt_len=SYS_LEN,
                             full_sys_every=3)
        ekw = dict(kv_backend="paged", kv_block_size=8, prefix_cache=True,
                   prefill_chunk=CHUNK)
    jsum, teng = _serve_kernel_route(monkeypatch, weights, policy, trace_fn,
                                     **ekw)
    if case == "prefix_chunk":
        assert jsum.prefix_stats["hit_requests"] > 0
        assert any(k[0] == "prefill_sfx" for k in teng._durations)


def test_engine_resolves_attn_kernel_per_device():
    """``None`` resolves to the plain code on the CPU; the engine records
    the resolved value and hands it to its model."""
    _, tcfg = _configs()
    for knob, want in ((None, False), (True, True), (False, False)):
        eng = EdgeLoRAEngine(tcfg, EngineConfig(
            **_engine_kwargs(tcfg, "edgelora"), attn_kernel=knob),
            device="cpu")
        assert eng.attn_kernel is want and eng.model.attn_kernel is want
