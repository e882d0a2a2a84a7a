#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # the whole check; needs one CUDA GPU
    python3 chip_smoke.py --profile   # also profile decode steps by kernel
                                      # (attention kernels on and off): SGMV
                                      # ms, host syncs and busy share per step

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. The card: ``nvidia-smi`` name and power limit, torch/CUDA versions;
   TF32 off for matmuls and cuDNN.
2. Build every CUDA kernel of the port with nvcc (``sm_90a``) from the
   sources in this checkout (``sgmv.cu``, ``paged_gather.cu``,
   ``decode_attention.cu``, ``flash_prefill.cu``: one nvcc per source,
   started together; each source's seconds printed).
3. Kernels: ``sgmv_shrink``, ``sgmv_expand`` and the full ``ops.sgmv`` on
   the card against their plain PyTorch versions at the main path's
   shapes (Llama-3.1-8B LoRA: d ∈ {4096, 1024, 14336}, r = 32, R = 20
   pool slots; T = 8 decode rows and every prefill group size the serve
   forms, 1..8 rows × buckets 32/64 = 32..512 tokens, which reaches every
   block size and accumulator layout of the kernels; bf16 and f32
   activations, f32 pool; both kernels given the plan's ``n_used``, as the
   main path calls them), each timed with CUDA events (L2 flushed
   between launches) beside its plain version, a one-call library
   yardstick, and the least time the card could take (its bound: the
   bytes and FLOPs of the T real rows and the adapters they use; the
   figure for the whole padded buffer is kept beside it as
   ``bound_padded_ms``), with the wrapper's host µs per call while the
   card is busy (``enqueue_us``); ``ops.sgmv`` timed by CUDA events, by
   the host clock to a sync, and by its host µs per call; the timing
   method's floor (a 4-byte memset timed the same way) beside them.
   ``paged_gather_pages`` at the paged decode step's shape (32 layers, 137 pages of 16 tokens × 8·128
   features, 8 rows × 17 table entries mixing shuffled pages, repeats
   and an idle all -1 row) in bf16 and f32, bit-equal to its plain
   version, timed beside it, ``torch.index_select`` and its bound.
   ``flash_decode`` at the decode step's layer (q [8, 32, 128], a
   256-entry ring [8, 256, 8, 128], per-row positions with one idle
   all -1 row) in bf16, f32 and int8 K/V, and ``flash_prefill`` at a
   prefill group's layer ([8, 64, 32, 128] causal; bf16, the tensor-core
   template, and f32, the CUDA-core one) and a suffix step's (32 queries
   over 64 + 32 keys, bf16), against their plain versions, each timed
   beside its plain version, the library call
   (``scaled_dot_product_attention`` with GQA, a yardstick only) and its
   bound, with the wrapper's host µs per call while the card is busy.
4. Serve: ``EdgeLoRAEngine`` on the full Llama-3.1-8B config (bf16, 32
   layers, random weights from a seeded ``torch.Generator`` on the card,
   rescaled to fan-in scale),
   ``policy='edgelora'``, ``lora_backend='auto'`` (must resolve to
   ``sgmv``), serving a synthetic multi-tenant trace to completion with
   adapters that have nonzero B. The kernels' launch counts are zeroed
   just before the serve and must have risen just after, in its prefill
   steps and in its decode steps alike (each counted apart): each SGMV
   kernel 160 times per step call (5 LoRA modules x 32 layers), in every
   serve. On one decode
   step's inputs, the ``sgmv`` and ``einsum`` backends must agree on the
   logits. Every serve runs with the default ``attn_kernel=None``, which
   must resolve to the attention kernels: ``flash_prefill`` launches 32
   times per prefill step call (suffix and chunk steps included),
   ``flash_decode`` 32 times per decode step call. Then one full-depth
   bf16 prefill and one decode step on the serve's weights with
   ``attn_kernel`` on and off: logits within 5 % of max|logit|, top-1
   equal on every live row whose top-2 margin exceeds that.
5. Dense vs paged KV, same weights and adapters: one burst trace served
   twice under the same deterministic timer (``FakeTime`` through the
   engine's ``timer=`` hook), ``kv_backend='dense'`` then ``'paged'``
   (``kv_gather_kernel`` left to resolve to the CUDA kernel). Every
   request's token stream and the summaries (but for ``kv_stats``) must
   be equal, and the page gather must have launched exactly twice (k and
   v) per paged decode step call.
6. Paged KV with the shared-prefix cache and chunked prefill on the real
   timer: requests of 4 tenants open with their tenant's 32-token system
   prompt (prompts 40–96 tokens), prefilled in chunks of 32. All must
   complete with prefix hits, saved prefill tokens and at least one
   request prefilled in more than one chunk.

Each serve's kernel launch counts are zeroed just before it and read just
after; every kernel its path runs must have launched.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {...}}``. Writes details to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SLEEP_CYCLES = 4_000_000                    # ~2 ms of device time
R_POOL, RANK, N_SLOTS = 20, 32, 8          # llama3_8b max_resident, rank
MAX_CTX, KV_BLOCK = 256, 16                 # the serves' max_ctx, page size
# paged arena at dense-equivalent capacity: ceil(257/16) = 17 pages per
# sequence, 8 · 17 = 136 pages + the trash page, one leaf per layer
PAGES_PER_SEQ = -(-(MAX_CTX + 1) // KV_BLOCK)
N_PAGES = N_SLOTS * PAGES_PER_SEQ + 1
N_LAYERS, N_HEADS, N_KV_HEADS, HEAD_DIM = 32, 32, 8, 128
SHRINK_D = (4096, 14336)                    # q,k,v,up in; down in
EXPAND_D = (4096, 1024, 14336)              # q,down out; k,v out; up out
MODULES = {"q": (4096, 4096), "k": (4096, 1024), "v": (4096, 1024),
           "up": (4096, 14336), "down": (14336, 4096)}
# (phase, T): decode runs all n_slots rows; a prefill group is B rows
# (B a power of two up to n_slots) of one prompt bucket (32 or 64).
# auto_blk_t gives blk_t 8, 16 and 32 across these, so every shrink
# accumulator layout the serve uses (1, 2, 4 outputs per thread) is held
# against its plain version here.
CASES = [("decode", N_SLOTS)] + [("prefill", t)
                                 for t in (32, 64, 128, 256, 512)]
# kernel vs plain: both accumulate in f32 in different orders (1e-5 of
# max|ref|); a bf16 result may differ by one rounding step, at most 2^-7
# of its value.
TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
# sgmv vs einsum backend on one full-depth bf16 decode step: the einsum
# path rounds the LoRA shrink and expand to bf16 where sgmv keeps f32,
# a difference of a few bf16 steps (2^-8 each) per projection, carried
# through 32 layers; held to 5e-2 of max|logit| and to top-1 agreement on
# rows whose top-2 margin exceeds that.
BACKEND_TOL = 5e-2
# attention kernels vs their plain versions: both in f32 in different
# orders (1e-5 of max|plain|); a bf16 output may differ by one rounding
# step, 2^-8 of its value (1e-2).
ATTN_TOL = {"float32": 1e-5, "bfloat16": 1e-2}
# attn_kernel on vs off over one full-depth bf16 prefill and decode step:
# the plain route rounds the softmax probabilities to bf16 where the
# kernels keep f32, a few bf16 steps per layer carried through 32 layers
# (the sgmv vs einsum check's bound, BACKEND_TOL)
ATTN_STEP_TOL = 5e-2
# adapters: A ~ N(0, 1/r) as the reference draws it; B ~ N(0, B_STD^2)
# instead of zeros, which makes each LoRA delta about 15% of its base
# projection at fan-in scale
B_STD = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


class FakeTime:
    """Deterministic step timer for the engine's ``timer=`` hook: every
    ``perf_counter`` call advances a fixed tick, so two engines that run
    the same steps see the same step durations."""

    def __init__(self, tick: float = 5e-3) -> None:
        self.t = 0.0
        self.tick = tick

    def perf_counter(self) -> float:
        self.t += self.tick
        return self.t


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def cuda_ms(torch, fn, flush, iters: int = 20, warm: int = 3) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls, each between two
    CUDA events, after an L2 flush (the main path reads each layer's
    adapters cold). A device-side sleep before each start event keeps the
    card busy while the host enqueues ``fn``, so the events time the
    device work and not the host's launch overhead."""
    for _ in range(warm):
        fn()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def host_ms(torch, fn, iters: int = 20, warm: int = 3) -> float:
    """Mean wall ms of ``fn`` up to a device sync: the whole ``ops.sgmv``
    path as a caller waiting on its result sees it."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


def enqueue_us(torch, fn, iters: int = 50, warm: int = 3) -> float:
    """Mean host µs per call of ``fn`` while the card is kept busy (a
    device-side sleep of ~50 ms queued first), so no call waits on the
    device: the wrapper's own cost (checks, allocations, launches). Keep
    ``iters`` x launches per call well under CUDA's launch queue (about a
    thousand), or the host blocks on a full queue."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(25 * SLEEP_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * seconds / iters


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def kernel_phase(torch, dev):
    from repro_torch.kernels import ops, ref, sgmv

    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    # the timing method's floor: one 4-byte memset timed as the kernels are
    tiny = torch.empty(1, dtype=torch.float32, device=dev)
    rows = [dict(kernel="event_floor", ms=cuda_ms(torch, tiny.zero_, flush))]
    log(f"event floor (one 4-byte memset): {1e3 * rows[0]['ms']:.1f} us")

    def inputs(t, d_in, d_out, dtype):
        x = torch.randn(t, d_in, generator=gen, device=dev).to(dtype)
        a = torch.randn(R_POOL, RANK, d_in, generator=gen,
                        device=dev) / RANK ** 0.5
        b = torch.randn(R_POOL, d_out, RANK, generator=gen,
                        device=dev) * 0.01
        slots = torch.randint(0, R_POOL, (t,), generator=gen, device=dev,
                              dtype=torch.int32)
        blk_t = ops.auto_blk_t(t, R_POOL)
        plan = ops.plan_grouping(slots, R_POOL, blk_t)
        xbuf = x.new_zeros((plan.n_padded, d_in))
        xbuf[plan.padded_pos.long()] = x[plan.perm]
        return x, a, b, slots, blk_t, plan, xbuf

    def err(got, want, dtype):
        d = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(d <= TOL[dtype] * scale,
              f"max abs err {d:.3e} > {TOL[dtype]:.1e} x {scale:.3e}")
        return d

    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        esize = torch.empty((), dtype=dtype).element_size()
        for phase, t in CASES:
            for d_in in SHRINK_D:
                x, a, _, slots, blk_t, plan, xbuf = inputs(t, d_in, 16, dtype)
                bs, nu = plan.block_slots, plan.n_used
                got = sgmv.sgmv_shrink(xbuf, a, bs, blk_t=blk_t, n_used=nu)
                want = sgmv.shrink_plain(xbuf, a, bs, blk_t=blk_t,
                                         n_used=nu)
                torch.cuda.synchronize()
                e = err(got, want, "float32")
                nb = bs.numel()
                xb = xbuf.reshape(nb, blk_t, d_in)
                a_t = a[bs.long()].to(dtype).transpose(1, 2).contiguous()
                # the function: T real rows of x, the A tiles of the slots
                # those rows use, T rows of s; 2·r FLOPs per x element
                used = int(torch.unique(slots).numel())
                bnd, by = bound_ms(t * d_in * esize + used * RANK * d_in * 4
                                   + t * RANK * 4, 2.0 * t * RANK * d_in,
                                   dname)
                # what the kernels walk: every padded row and block
                pad_used = int(torch.unique(bs).numel())
                bnd_pad, _ = bound_ms(
                    xbuf.numel() * esize + pad_used * RANK * d_in * 4
                    + nb * 4 + xbuf.shape[0] * RANK * 4,
                    2.0 * xbuf.shape[0] * RANK * d_in, dname)
                rows.append(dict(
                    kernel="sgmv_shrink", phase=phase, dtype=dname, T=t,
                    T_pad=xbuf.shape[0], blk_t=blk_t, d=d_in,
                    n_used=int(nu), max_abs_err=e,
                    ms=cuda_ms(torch, lambda: sgmv.sgmv_shrink(
                        xbuf, a, bs, blk_t=blk_t, n_used=nu), flush),
                    plain_ms=cuda_ms(torch, lambda: sgmv.shrink_plain(
                        xbuf, a, bs, blk_t=blk_t, n_used=nu), flush),
                    host_us=enqueue_us(torch, lambda: sgmv.sgmv_shrink(
                        xbuf, a, bs, blk_t=blk_t, n_used=nu)),
                    library_ms=cuda_ms(torch, lambda: torch.bmm(xb, a_t),
                                       flush),
                    bound_ms=bnd, bound_by=by, bound_padded_ms=bnd_pad))
            for d_out in EXPAND_D:
                _, _, b, slots, blk_t, plan, xbuf = inputs(t, 16, d_out, dtype)
                bs, nu = plan.block_slots, plan.n_used
                s = torch.randn(xbuf.shape[0], RANK, generator=gen,
                                device=dev)
                got = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t,
                                       compute_dtype=dtype, n_used=nu)
                want = sgmv.expand_plain(s, b, bs, blk_t=blk_t,
                                         compute_dtype=dtype, n_used=nu)
                torch.cuda.synchronize()
                e = err(got, want, "float32")
                nb = bs.numel()
                sb = s.reshape(nb, blk_t, RANK)
                b_t = b[bs.long()].to(dtype).float().transpose(
                    1, 2).contiguous()
                # the function: T real rows of s, the B tiles of the slots
                # those rows use, T f32 rows of y; 2·r FLOPs per y element
                used = int(torch.unique(slots).numel())
                bnd, by = bound_ms(t * RANK * 4 + used * d_out * RANK * 4
                                   + t * d_out * 4, 2.0 * t * RANK * d_out,
                                   "float32")
                pad_used = int(torch.unique(bs).numel())
                bnd_pad, _ = bound_ms(
                    s.numel() * 4 + pad_used * d_out * RANK * 4 + nb * 4
                    + s.shape[0] * d_out * 4,
                    2.0 * s.shape[0] * RANK * d_out, "float32")
                rows.append(dict(
                    kernel="sgmv_expand", phase=phase, dtype=dname, T=t,
                    T_pad=s.shape[0], blk_t=blk_t, d=d_out, n_used=int(nu),
                    max_abs_err=e,
                    ms=cuda_ms(torch, lambda: sgmv.sgmv_expand(
                        s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                        n_used=nu), flush),
                    plain_ms=cuda_ms(torch, lambda: sgmv.expand_plain(
                        s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                        n_used=nu), flush),
                    host_us=enqueue_us(torch, lambda: sgmv.sgmv_expand(
                        s, b, bs, blk_t=blk_t, compute_dtype=dtype,
                        n_used=nu)),
                    library_ms=cuda_ms(torch, lambda: torch.bmm(sb, b_t),
                                       flush),
                    bound_ms=bnd, bound_by=by, bound_padded_ms=bnd_pad))
            for mod, (d_in, d_out) in MODULES.items():
                x, a, b, slots, _, _, _ = inputs(t, d_in, d_out, dtype)
                got = ops.sgmv(x, a, b, slots, 2.0, n_slots=R_POOL,
                               blk_t=None)
                want = (2.0 * ref.sgmv_ref(x, a.to(dtype), b.to(dtype),
                                           slots, 1.0)).to(dtype)
                torch.cuda.synchronize()
                e = err(got, want, dname)
                def call():
                    return ops.sgmv(x, a, b, slots, 2.0, n_slots=R_POOL,
                                    blk_t=None)
                rows.append(dict(
                    kernel="ops.sgmv", phase=phase, dtype=dname, T=t,
                    module=mod, d_in=d_in, d_out=d_out, max_abs_err=e,
                    ms=cuda_ms(torch, call, flush), wall_ms=host_ms(
                        torch, call), host_us=enqueue_us(torch, call,
                                                         iters=10)))
            log(f"kernels {phase:7s} T={t:3d} {dname:8s} ok")
    return rows


def gather_phase(torch, dev):
    """``paged_gather_pages`` against its plain version at the paged
    decode step's shape, bf16 and f32; timed beside the plain version,
    ``torch.index_select`` and its bound."""
    from repro_torch.kernels import paged_gather as pg

    gen = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    ng, bs, feat = N_LAYERS, KV_BLOCK, N_KV_HEADS * HEAD_DIM
    b, mb = N_SLOTS, PAGES_PER_SEQ
    # rows 0-5: distinct shuffled pages for lengths of 1..17 pages, -1
    # past each row's length; row 6 repeats pages; row 7 is idle (all -1)
    perm = torch.randperm(N_PAGES - 1, generator=gen, device=dev).int()
    tables = torch.full((b, mb), -1, dtype=torch.int32, device=dev)
    used = 0
    for row, n in enumerate((17, 16, 9, 17, 4, 1)):
        tables[row, :n] = perm[used:used + n]
        used += n
    tables[6, :6] = perm[:3].repeat(2)
    rows = []
    for dname in ("bfloat16", "float32"):
        dtype = getattr(torch, dname)
        arena = torch.randn(ng, N_PAGES, bs, feat, generator=gen,
                            device=dev).to(dtype)
        got = pg.paged_gather_pages(arena, tables)
        want = pg.paged_gather_pages_plain(arena, tables)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"paged_gather_pages {dname} differs from its plain version")
        idx = (tables.long() % N_PAGES).flatten()
        lib = torch.index_select(arena, 1, idx).reshape(got.shape)
        check(torch.equal(lib, want), "index_select yardstick differs")
        # bytes the function must move: every distinct page the tables
        # name read once, the gathered run written once, the table read
        page_bytes = bs * feat * arena.element_size()
        distinct = int(torch.unique(idx).numel())
        nbytes = (ng * distinct * page_bytes + got.numel()
                  * got.element_size() + tables.numel() * 4)
        bnd, by = bound_ms(nbytes, 0.0, dname)
        rows.append(dict(
            kernel="paged_gather_pages", dtype=dname, ng=ng,
            n_pages=N_PAGES, bs=bs, F=feat, B=b, MB=mb,
            distinct_pages=distinct, out_mb=got.numel()
            * got.element_size() / 1e6, max_abs_err=0.0,
            ms=cuda_ms(torch, lambda: pg.paged_gather_pages(arena, tables),
                       flush),
            plain_ms=cuda_ms(torch, lambda: pg.paged_gather_pages_plain(
                arena, tables), flush),
            library_ms=cuda_ms(torch, lambda: torch.index_select(
                arena, 1, idx), flush),
            bound_ms=bnd, bound_by=by,
            # the read-and-write-everything figure (every table entry's
            # page read, repeats and -1 included)
            bound_all_entries_ms=2 * got.numel() * got.element_size()
            / HBM_BYTES_PER_S * 1e3))
        del arena, got, want, lib
        log(f"paged_gather_pages {dname} ok: " + json.dumps(rows[-1]))
    return rows


def attention_phase(torch, dev):
    """``flash_decode`` and ``flash_prefill`` against their plain versions
    at the main path's shapes, each timed beside its plain version, the
    library call (``scaled_dot_product_attention`` with GQA; a yardstick
    only, the port never calls it) and its bound.

    decode: one decode step's layer (q [8, 32, 128], a 256-entry ring
    [8, 256, 8, 128]) with per-row positions (rows at depths 17..256, the
    deepest wrapped, and one idle row whose ring is empty), in bf16, f32,
    and int8 K/V with f32 scales (bf16 q). prefill: a full prefill
    group's layer ([8, 64, 32, 128] causal) in bf16 and f32, and a suffix
    step's (32 queries at positions 64..95 over 64 cached + 32 fresh
    keys) in bf16. Each row also carries the wrapper's host µs per call
    (``enqueue_us``). Bounds count what these inputs need: K and V of
    visible entries (only V of a row with no visible key, whose output
    is the mean of V), positions, q and out; 4·hd operations per visible
    (query head, key) pair."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp

    gen = torch.Generator(device=dev).manual_seed(99)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    h, kh, hd, b, c = N_HEADS, N_KV_HEADS, HEAD_DIM, N_SLOTS, MAX_CTX
    g = h // kh
    rows = []

    def randn(*shape, dtype):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def err(got, want, dname):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), "non-finite output")
        d = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(d <= ATTN_TOL[dname] * scale,
              f"max abs err {d:.3e} > {ATTN_TOL[dname]:.1e} x {scale:.3e}")
        return d

    # ---- flash_decode ---------------------------------------------------
    depth = torch.tensor([256, 200, 128, 64, 33, 17, 300, 0],
                         dtype=torch.int32, device=dev)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    # ring index i of a row at depth n holds the newest position p < n
    # with p % c == i (-1 where none): row 6 has wrapped
    newest = (depth[:, None] - 1 - idx) // c * c + idx
    kv_pos = torch.where(newest >= 0, newest, -1).to(torch.int32)
    q_pos = (depth - 1).clamp_min(0)
    visible = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    no_key = ~visible.any(1)
    check(bool(no_key[-1]) and int(no_key.sum()) == 1, "decode rows")
    n_vis = int(visible.sum())
    mask = visible[:, None, None, :]                       # SDPA's mask
    for dname, kvname in (("bfloat16", "bfloat16"), ("float32", "float32"),
                          ("bfloat16", "int8")):
        dtype = getattr(torch, dname)
        q = randn(b, h, hd, dtype=dtype)
        if kvname == "int8":
            k = torch.randint(-127, 128, (b, c, kh, hd), generator=gen,
                              device=dev, dtype=torch.int8)
            v = torch.randint(-127, 128, (b, c, kh, hd), generator=gen,
                              device=dev, dtype=torch.int8)
            ks = torch.rand(b, c, kh, generator=gen, device=dev) / 127
            vs = torch.rand(b, c, kh, generator=gen, device=dev) / 127
            scales = dict(k_scale=ks, v_scale=vs)
            kv_es, extra = 1, 4        # an f32 scale per (entry, kv head)
        else:
            k, v = randn(b, c, kh, hd, dtype=dtype), randn(b, c, kh, hd,
                                                          dtype=dtype)
            scales, kv_es, extra = {}, dtype.itemsize, 0
        got = da.flash_decode(q, k, v, kv_pos, q_pos, **scales)
        want = da.flash_decode_plain(q, k, v, kv_pos, q_pos, **scales)
        e = err(got, want, dname)
        # the idle row is the mean of V over its ring
        vf = v.float() * (scales["v_scale"][..., None] if scales else 1.0)
        e_idle = (got[-1].float() - vf[-1].mean(0).repeat_interleave(
            g, 0)).abs().max().item()
        check(e_idle <= ATTN_TOL[dname] * vf[-1].abs().max().item(),
              f"idle decode row is not the mean of V ({e_idle:.3e})")
        per_entry = kh * (hd * kv_es + extra)      # K or V bytes of entry
        nbytes = (2 * q.numel() * q.element_size() + kv_pos.numel() * 4
                  + b * 4 + n_vis * 2 * per_entry
                  + int(no_key.sum()) * c * per_entry)
        flops = 4.0 * hd * g * n_vis + 2.0 * hd * h * c * int(no_key.sum())
        bnd, by = bound_ms(nbytes, flops, dname)
        qs = q[:, :, None, :]
        ksd = (k.float() * scales["k_scale"][..., None]).to(dtype) \
            if scales else k
        vsd = vf.to(dtype) if scales else v
        kl, vl = (x.transpose(1, 2).contiguous() for x in (ksd, vsd))
        rows.append(dict(
            kernel="flash_decode", dtype=dname, kv_dtype=kvname,
            shape=f"q [{b},{h},{hd}] k,v [{b},{c},{kh},{hd}] {kvname}, "
                  f"[B] q_pos, one idle row", visible_entries=n_vis,
            max_abs_err=e, ms=cuda_ms(torch, lambda: da.flash_decode(
                q, k, v, kv_pos, q_pos, **scales), flush),
            host_us=enqueue_us(torch, lambda: da.flash_decode(
                q, k, v, kv_pos, q_pos, **scales)),
            plain_ms=cuda_ms(torch, lambda: da.flash_decode_plain(
                q, k, v, kv_pos, q_pos, **scales), flush),
            library_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                qs, kl, vl, attn_mask=mask, enable_gqa=True), flush),
            bound_ms=bnd, bound_by=by))
        log("flash_decode " + json.dumps(rows[-1]))

    # ---- flash_prefill --------------------------------------------------
    for label, sq, p0, dname in (("prefill", 64, 0, "bfloat16"),
                                 ("suffix", 32, 64, "bfloat16"),
                                 ("prefill", 64, 0, "float32")):
        dtype = getattr(torch, dname)
        skv = p0 + sq
        q = randn(b, sq, h, hd, dtype=dtype)
        k, v = randn(b, skv, kh, hd, dtype=dtype), randn(b, skv, kh, hd,
                                                          dtype=dtype)
        qpos = torch.arange(p0, skv, dtype=torch.int32, device=dev)
        kpos = torch.arange(skv, dtype=torch.int32, device=dev)
        kw = dict(qpos=qpos, kpos=kpos) if p0 else {}
        got = fp.flash_prefill(q, k, v, **kw)
        want = fp.flash_prefill_plain(q, k, v, **kw)
        e = err(got, want, dname)
        vis = (kpos[None, :] <= qpos[:, None])
        pairs = int(vis.sum())
        nbytes = dtype.itemsize * (2 * q.numel() + k.numel() + v.numel()) + (
            4 * (sq + skv) if p0 else 0)
        bnd, by = bound_ms(nbytes, 4.0 * b * h * hd * pairs, dname)
        ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if p0:
            def lib():
                return F.scaled_dot_product_attention(
                    ql, kl, vl, attn_mask=vis, enable_gqa=True)
        else:
            def lib():
                return F.scaled_dot_product_attention(
                    ql, kl, vl, is_causal=True, enable_gqa=True)
        rows.append(dict(
            kernel="flash_prefill", dtype=dname, case=label,
            shape=f"q [{b},{sq},{h},{hd}] k,v [{b},{skv},{kh},{hd}] {dname} "
                  f"causal, q positions {p0}..{skv - 1}",
            visible_pairs=pairs, max_abs_err=e,
            ms=cuda_ms(torch, lambda: fp.flash_prefill(q, k, v, **kw),
                       flush),
            host_us=enqueue_us(torch, lambda: fp.flash_prefill(q, k, v,
                                                               **kw)),
            plain_ms=cuda_ms(torch, lambda: fp.flash_prefill_plain(
                q, k, v, **kw), flush),
            library_ms=cuda_ms(torch, lib, flush),
            bound_ms=bnd, bound_by=by))
        log("flash_prefill " + json.dumps(rows[-1]))
    return rows


def step_check_phase(torch, dev, shared):
    """One full-depth bf16 prefill and one decode step of the full model
    with ``attn_kernel=True`` and ``False`` on the same inputs (weights of
    the serve, no adapters): logits within ATTN_STEP_TOL of max|logit|,
    top-1 equal on every live row whose top-2 margin exceeds that (the
    rule of the sgmv vs einsum check); the agreement over all live rows
    is reported beside it. The decode step runs over the kernel
    route's prefilled cache, cloned for each route; row 7 is idle (token
    0, position 0), as the engine runs it."""
    from repro_torch.models import build_model

    cfg, params = shared["cfg"], shared["params"]
    gen = torch.Generator(device=dev).manual_seed(7)
    b, s = N_SLOTS, 64
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([64, 60, 50, 40, 33, 20, 9, 64],
                           dtype=torch.int32, device=dev)
    models = {on: build_model(cfg, dev, attn_kernel=on)
              for on in (True, False)}
    out, caches = {}, {}
    with torch.no_grad():
        for on, m in models.items():
            logits, caches[on] = m.prefill(params, {"tokens": tokens},
                                           m.init_cache(b, MAX_CTX),
                                           lengths=lengths)
            out[("prefill", on)] = logits.float()
        nxt = out[("prefill", True)].argmax(-1).int()
        pos = lengths.clone()
        nxt[-1], pos[-1] = 0, 0
        for on, m in models.items():
            cache = {k: {n: v.clone() for n, v in c.items()}
                     for k, c in caches[True].items()}
            logits, _ = m.decode_step(params, nxt, cache, pos)
            out[("decode", on)] = logits.float()
    torch.cuda.synchronize()
    live = {"prefill": torch.ones(b, dtype=torch.bool, device=dev),
            "decode": torch.arange(b, device=dev) < b - 1}
    res = {}
    for step in ("prefill", "decode"):
        kern, plain = out[(step, True)], out[(step, False)]
        d = (kern - plain).abs().max().item()
        scale = plain.abs().max().item()
        top2 = plain.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        agree = kern.argmax(-1) == plain.argmax(-1)
        # rows where the plain route's top-2 margin exceeds the logit
        # tolerance: there a flip is a fault, not a tie broken the other
        # way by rounding (bf16 logits tie exactly at times)
        clear = live[step] & (margin > ATTN_STEP_TOL * scale)
        res[step] = dict(max_abs=d, max_logit=scale,
                         top1_agree_live=int(agree[live[step]].sum()),
                         live_rows=int(live[step].sum()),
                         clear_rows=int(clear.sum()),
                         top2_margins_live=margin[live[step]].tolist())
        log(f"attn_kernel on vs off, full-depth bf16 {step}: "
            + json.dumps(res[step]))
        check(d <= ATTN_STEP_TOL * scale,
              f"{step}: kernel vs plain attention logits differ by {d:.3e}"
              f" > {ATTN_STEP_TOL} x {scale:.3e}")
        check(bool(agree[clear].all()),
              f"{step}: top-1 differs on a live row whose top-2 margin "
              f"exceeds {ATTN_STEP_TOL} x max|logit|")
    del models, caches
    return res


# ---------------------------------------------------------------------------
# phase 4: serve the full model through the sgmv kernels
# ---------------------------------------------------------------------------


def serve_phase(torch, dev, profile: bool):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models.transformer import init_lora_stack
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate_trace

    cfg = get_config("llama3-8b")
    n_adapters = 2 * cfg.lora.max_resident    # misses force swap-ins
    cfg = dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, n_adapters=n_adapters))
    check(cfg.n_layers == 32 and cfg.d_model == 4096
          and cfg.dtype == "bfloat16", "not the full llama3_8b config")

    def adapter_source(aid: int):
        """A ~ N(0, 1/r) as the reference draws it, and B ~ N(0, B_STD^2)
        instead of zeros, so every LoRA delta is real."""
        gen = torch.Generator(device=dev).manual_seed(10_000 + aid)
        tree = init_lora_stack(gen, cfg)
        for mods in tree["layers"].values():
            for pair in mods.values():
                pair["B"].normal_(0.0, B_STD, generator=gen)
        return tree

    # top_k=1: AAS takes the router's first choice, so the trace's cold
    # adapters are swapped into the pool during the serve
    ecfg = EngineConfig(n_slots=N_SLOTS, top_k=1, policy="edgelora",
                        max_ctx=MAX_CTX, prompt_buckets=(32, 64),
                        lora_backend="auto", seed=0)
    t0 = time.perf_counter()
    engine = EdgeLoRAEngine(cfg, ecfg, device=dev,
                            adapter_source=adapter_source)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(engine.lora_backend == "sgmv",
          f"lora_backend 'auto' resolved to {engine.lora_backend!r}")
    check(engine.attn_kernel and engine.model.attn_kernel,
          "attn_kernel did not resolve to the kernels on CUDA")
    # The engine draws the reference's init: stacked weights with stddev
    # 1/sqrt(n_groups). Rescale them in place to 1/sqrt(d_in) (fan-in) so
    # activations stay O(1) and a bf16 step is well conditioned enough
    # for the backend comparison below to mean something.
    with torch.no_grad():
        for slot in engine.params["layers"].values():
            for module in slot.values():
                for w in module.values():
                    if w.dim() == 3:
                        w.mul_((w.shape[0] / w.shape[-2]) ** 0.5)
    log(f"engine init {init_s:.1f}s (model + pool + {cfg.lora.max_resident}"
        " adapters)")

    trace = generate_trace(WorkloadConfig(
        n_adapters=n_adapters, request_rate=4.0, duration=3.0,
        input_range=(8, 64), output_range=(8, 32),
        vocab_size=cfg.vocab_size, seed=0))
    check(8 <= len(trace) <= 24, f"trace of {len(trace)} requests")

    # record one decode step's real inputs, time every step call, and
    # count each kernel's launches per path (prefill, decode)
    step_ms = {"prefill": [], "decode": []}
    path_launches = {p: dict.fromkeys(_counts(), 0) for p in step_ms}
    captured = {}

    def timed(name, fn):
        def run(*args):
            if name == "decode" and len(step_ms["decode"]) == 6:
                params, pool, tokens, cache, pos, sids = args
                captured.update(tokens=tokens.clone(), pos=pos.clone(),
                                sids=sids.clone(),
                                cache={k: {n: v.clone() for n, v in
                                           c.items()}
                                       for k, c in cache.items()})
            before = _counts()
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - t))
            for k, n in _counts().items():
                path_launches[name][k] += n - before[k]
            return out
        return run

    raw_decode = engine._decode
    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)

    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    summary = engine.serve(trace)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    check(summary.n_completed == summary.n_requests == len(trace),
          f"completed {summary.n_completed}/{summary.n_requests}")
    for r in trace:
        check(r.finish_time is not None and len(r.tokens) == r.generated > 0,
              f"request {r.request_id} unfinished")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.request_id}: token out of range")
    for path, counts in path_launches.items():
        _check_sgmv_launches(f"dense serve, {path} steps", counts,
                             len(step_ms[path]))
    check(path_launches["prefill"]["flash_decode"] == 0
          and path_launches["decode"]["flash_prefill"] == 0,
          f"attention kernel on the wrong path: {path_launches}")
    _check_attention_launches(
        "dense serve", launches, len(step_ms["prefill"]),
        len(step_ms["decode"]))
    check(launches["paged_gather_pages"] == 0,
          "the dense serve launched the page gather")
    check(all(launches[k] == sum(c[k] for c in path_launches.values())
              for k in launches), "launches outside the prefill and decode "
          f"steps: {launches} vs {path_launches}")
    per_step = {p: {k: n / len(step_ms[p]) for k, n in c.items()}
                for p, c in path_launches.items()}
    check(bool(captured), "no decode step captured")

    from repro_torch.launch.serve import summary_row
    log(summary_row("edgelora", n_adapters, summary))
    mean = {k: sum(v) / len(v) for k, v in step_ms.items()}
    med = {k: sorted(v)[len(v) // 2] for k, v in step_ms.items()}
    log(f"serve: {len(trace)} requests in {serve_s:.1f}s wall; "
        f"{summary.prefill_steps} prefill + {summary.decode_steps} decode "
        f"steps; step ms mean/median: prefill {mean['prefill']:.1f}/"
        f"{med['prefill']:.1f}, decode {mean['decode']:.1f}/"
        f"{med['decode']:.1f} (warm-up calls included); peak memory "
        f"{peak_gb:.1f} GB; launches {path_launches} over "
        f"{len(step_ms['prefill'])} prefill + {len(step_ms['decode'])} "
        f"decode step calls, per call {per_step}")

    # sgmv vs einsum on the captured decode step (launches not counted)
    params, pool, scale = engine.params, engine.lora_pool, cfg.lora.scale

    def decode_logits(backend):
        cache = {k: {n: v.clone() for n, v in c.items()}
                 for k, c in captured["cache"].items()}
        mode = LoRAMode("batched", captured["sids"], scale, backend)
        with torch.no_grad():
            logits, _ = engine.model.decode_step(
                params, captured["tokens"], cache, captured["pos"], pool,
                mode)
        return logits.float()

    l_sgmv = decode_logits("sgmv")
    l_ein = decode_logits("einsum")
    d = (l_sgmv - l_ein).abs().max().item()
    scale_l = l_ein.abs().max().item()
    top2 = l_ein.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > BACKEND_TOL * scale_l
    agree = (l_sgmv.argmax(-1) == l_ein.argmax(-1))
    log(f"backends on one decode step: max|sgmv-einsum| {d:.3e} "
        f"(max|logit| {scale_l:.3e}); top-1 agree {int(agree.sum())}/"
        f"{agree.numel()} rows")
    check(d <= BACKEND_TOL * scale_l,
          f"sgmv vs einsum logits differ by {d:.3e} > "
          f"{BACKEND_TOL} x {scale_l:.3e}")
    check(bool(agree[clear].all()), "top-1 disagrees on a clear row")

    prof = None
    if profile:
        # the same decode step with the attention kernels on and off, in
        # turns: on, off, off, on
        from repro_torch.models import build_model
        plain_model = build_model(cfg, dev, attn_kernel=False)

        @torch.no_grad()
        def plain_decode(params, pool, tokens, cache, pos, sids):
            mode = LoRAMode("batched", sids, scale, engine.lora_backend)
            logits, cache = plain_model.decode_step(params, tokens, cache,
                                                    pos, pool, mode)
            return torch.argmax(logits, -1).to(torch.int32), cache

        routes = {True: raw_decode, False: plain_decode}
        runs = [(on, profile_decode(torch, routes[on], engine, captured,
                                    f"attn_kernel={on}"))
                for on in (True, False, False, True)]
        prof = {f"attn_kernel={on}": [r for o, r in runs if o == on]
                for on in (True, False)}
    result = dict(summary=dataclasses.asdict(summary), launches=launches,
                  path_launches=path_launches, launches_per_step=per_step,
                  init_s=init_s,
                  serve_s=serve_s, step_ms=step_ms, peak_gb=peak_gb,
                  backend_max_abs=d, backend_max_logit=scale_l,
                  top1_agree=int(agree.sum()), profile=prof)
    # what the later serves share: the config, the (rescaled) weights and
    # the adapters; the engine itself and its pool are freed on return
    shared = dict(cfg=cfg, params=engine.params,
                  adapter_source=adapter_source)
    return result, shared


# ---------------------------------------------------------------------------
# phases 5-6: the paged KV arena, the prefix cache, chunked prefill
# ---------------------------------------------------------------------------


def _kernel_modules():
    from repro_torch.kernels import (decode_attention, flash_prefill,
                                     paged_gather, sgmv)
    return (sgmv, paged_gather, decode_attention, flash_prefill)


def _counts():
    out = {}
    for mod in _kernel_modules():
        out.update(mod.launches)
    return out


def _reset_counts() -> None:
    for mod in _kernel_modules():
        mod.reset_launches()


def _check_sgmv_launches(where, launches, step_calls):
    """Every LoRA module of every layer of every step call launches each
    SGMV kernel once."""
    want = N_LAYERS * len(MODULES) * step_calls
    got = {k: launches[k] for k in ("sgmv_shrink", "sgmv_expand")}
    check(want > 0 and all(n == want for n in got.values()),
          f"{where}: SGMV launches {got}, want {want} ({N_LAYERS} layers x "
          f"{len(MODULES)} modules per step call over {step_calls} calls)")


def _check_attention_launches(where, launches, prefill_calls, decode_calls):
    """Every layer of every prefill / decode step call launches its
    attention kernel once."""
    want = {"flash_prefill": N_LAYERS * prefill_calls,
            "flash_decode": N_LAYERS * decode_calls}
    got = {k: launches[k] for k in want}
    check(got == want and min(want.values()) > 0,
          f"{where}: attention launches {got}, want {want} ({N_LAYERS} per "
          f"step call over {prefill_calls} prefill and {decode_calls} "
          "decode step calls)")


def _timed_steps(torch, engine, names):
    """Wrap engine step functions to record host ms per call (each call
    ends in a device sync). Returns {name: [ms, ...]}."""
    out = {}
    for name in names:
        fn = getattr(engine, name)
        calls = out.setdefault(name, [])

        def run(*args, _fn=fn, _calls=calls, **kw):
            t = time.perf_counter()
            res = _fn(*args, **kw)
            torch.cuda.synchronize()
            _calls.append(1e3 * (time.perf_counter() - t))
            return res
        setattr(engine, name, run)
    return out


def _mean(xs):
    return sum(xs) / len(xs) if xs else None


def _release(torch) -> None:
    """Return a freed engine's device memory (its pool and caches)."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def paged_compare_phase(torch, dev, shared):
    """One burst trace served under the same deterministic timer by a
    dense and a paged engine: equal token streams and summaries (but for
    ``kv_stats``), two page-gather launches per paged decode step call,
    and one attention kernel launch per layer of every step call."""
    import dataclasses

    from repro_torch.launch.serve import summary_row
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate_trace

    cfg = shared["cfg"]
    # ~10 requests arriving within 50 ms of virtual time (10 steps of the
    # 5 ms fake tick), so they overlap in the batch
    wl = WorkloadConfig(n_adapters=cfg.lora.n_adapters, request_rate=200.0,
                        duration=0.05, input_range=(8, 64),
                        output_range=(8, 32), vocab_size=cfg.vocab_size,
                        seed=1)
    streams, summaries, out = {}, {}, {}
    for backend in ("dense", "paged"):
        ecfg = EngineConfig(n_slots=N_SLOTS, top_k=1, policy="edgelora",
                            max_ctx=MAX_CTX, prompt_buckets=(32, 64),
                            lora_backend="auto", kv_backend=backend,
                            kv_block_size=KV_BLOCK, seed=0)
        engine = EdgeLoRAEngine(cfg, ecfg, params=shared["params"],
                                device=dev,
                                adapter_source=shared["adapter_source"],
                                timer=FakeTime())
        decode = "_decode_paged" if backend == "paged" else "_decode"
        if backend == "paged":
            check(engine.kv_gather_kernel,
                  "kv_gather_kernel did not resolve to the kernel on CUDA")
        steps = _timed_steps(torch, engine, ("_prefill", decode))
        trace = generate_trace(wl)
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_counts()
        t0 = time.perf_counter()
        summary = engine.serve(trace)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = _counts()
        check(summary.n_completed == summary.n_requests == len(trace) >= 6,
              f"{backend}: completed {summary.n_completed}/"
              f"{summary.n_requests}")
        n_dec = len(steps[decode])
        _check_sgmv_launches(f"{backend} serve", launches,
                             len(steps["_prefill"]) + n_dec)
        gathers = launches["paged_gather_pages"]
        if backend == "paged":
            check(gathers == 2 * n_dec > 0,
                  f"paged_gather_pages launched {gathers} times over "
                  f"{n_dec} paged decode step calls (want 2 per call)")
        else:
            check(gathers == 0, "the dense serve launched the page gather")
        check(engine.attn_kernel, f"{backend}: attn_kernel did not resolve "
              "to the kernels on CUDA")
        _check_attention_launches(f"{backend} serve", launches,
                                  len(steps["_prefill"]), n_dec)
        streams[backend] = {r.request_id: list(r.tokens) for r in trace}
        # the summary apart from the KV backend's own accounting
        fields = dataclasses.asdict(summary)
        fields.pop("kv_stats")
        summaries[backend] = json.dumps(fields, sort_keys=True, default=str)
        row = summary_row("edgelora", cfg.lora.n_adapters, summary)
        out[backend] = dict(
            requests=len(trace), serve_s=serve_s, launches=launches,
            decode_step_calls=n_dec,
            prefill_step_calls=len(steps["_prefill"]),
            prefill_ms_mean=_mean(steps["_prefill"]),
            decode_ms_mean=_mean(steps[decode]),
            decode_ms_median=sorted(steps[decode])[n_dec // 2],
            peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9, row=row,
            kv_stats=summary.kv_stats)
        log(f"{backend} serve (deterministic timer): {row}")
        log(f"  {len(trace)} requests in {serve_s:.1f}s wall; prefill "
            f"{out[backend]['prefill_ms_mean']:.1f} ms mean over "
            f"{len(steps['_prefill'])} calls, decode "
            f"{out[backend]['decode_ms_mean']:.1f} ms mean / "
            f"{out[backend]['decode_ms_median']:.1f} median over {n_dec} "
            f"calls; peak {out[backend]['peak_gb']:.1f} GB; launches "
            f"{launches}")
        del engine
        _release(torch)
    same = sum(streams["dense"][k] == streams["paged"][k]
               for k in streams["dense"])
    log(f"dense vs paged token streams: {same}/{len(streams['dense'])} "
        "requests equal")
    check(streams["dense"] == streams["paged"],
          "dense and paged token streams differ under one timer")
    check(summaries["dense"] == summaries["paged"],
          "dense and paged summaries differ under one timer")
    out["streams_equal"] = same
    return out


def prefix_chunk_phase(torch, dev, shared):
    """Paged KV with the prefix cache and chunked prefill on the real
    timer: 4 tenants' 32-token system prompts, 32-token chunks."""
    from repro_torch.launch.serve import summary_row
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate_trace

    cfg = shared["cfg"]
    sys_len, chunk, tenants = 32, 32, 4
    wl = WorkloadConfig(n_adapters=tenants, request_rate=4.0, duration=3.0,
                        input_range=(8, 64), output_range=(8, 32),
                        system_prompt_len=sys_len,
                        vocab_size=cfg.vocab_size, seed=2)
    ecfg = EngineConfig(n_slots=N_SLOTS, top_k=1, policy="edgelora",
                        max_ctx=MAX_CTX, prompt_buckets=(32, 64),
                        lora_backend="auto", kv_backend="paged",
                        kv_block_size=KV_BLOCK, prefix_cache=True,
                        prefill_chunk=chunk, seed=0)
    engine = EdgeLoRAEngine(cfg, ecfg, params=shared["params"], device=dev,
                            adapter_source=shared["adapter_source"])
    check(engine.kv_gather_kernel and engine.prefix_enabled
          and engine.chunked, "paged + prefix + chunk engine not built")
    steps = _timed_steps(torch, engine,
                         ("_prefill", "_prefill_suffix", "_decode_paged"))
    # requests still prefilling after one of their chunks: prefilled in
    # more than one chunk
    multi = set()
    run_chunk = engine._prefill_chunk

    def chunked(bucket, start, width, group, now):
        dt = run_chunk(bucket, start, width, group, now)
        multi.update(s.request.request_id for s in group
                     if s.request.prompt_len > start + width)
        return dt
    engine._prefill_chunk = chunked

    trace = generate_trace(wl)
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_counts()
    t0 = time.perf_counter()
    summary = engine.serve(trace)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    check(summary.n_completed == summary.n_requests == len(trace) >= 6,
          f"prefix/chunk: completed {summary.n_completed}/"
          f"{summary.n_requests}")
    for r in trace:
        check(len(r.tokens) == r.generated > 0
              and all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.request_id}: bad output")
    ps = summary.prefix_stats
    check(ps["hit_requests"] > 0 and ps["saved_prefill_tokens"] > 0,
          f"no prefix hits: {ps}")
    check(bool(multi), "no request was prefilled in more than one chunk")
    for name, n in launches.items():
        check(n > 0, f"prefix/chunk serve: {name} never launched")
    prefill_ms = steps["_prefill"] + steps["_prefill_suffix"]
    _check_attention_launches("prefix/chunk serve", launches,
                              len(prefill_ms), len(steps["_decode_paged"]))
    _check_sgmv_launches("prefix/chunk serve", launches,
                         len(prefill_ms) + len(steps["_decode_paged"]))
    row = summary_row("edgelora", cfg.lora.n_adapters, summary)
    out = dict(requests=len(trace), serve_s=serve_s, launches=launches,
               prompt_lens=[r.prompt_len for r in trace],
               multi_chunk_requests=len(multi),
               prefill_step_calls=len(prefill_ms),
               prefill_ms_mean=_mean(prefill_ms),
               decode_step_calls=len(steps["_decode_paged"]),
               decode_ms_mean=_mean(steps["_decode_paged"]),
               peak_gb=peak_gb, row=row, kv_stats=summary.kv_stats,
               prefix_stats=ps, summary_prefill_steps=summary.prefill_steps)
    log(f"prefix + chunk serve: {row}")
    log(f"  {len(trace)} requests (prompts {min(out['prompt_lens'])}-"
        f"{max(out['prompt_lens'])} tokens) in {serve_s:.1f}s wall; "
        f"{len(multi)} prefilled in >1 chunk; prefill "
        f"{out['prefill_ms_mean']:.1f} ms mean over {len(prefill_ms)} "
        f"calls, decode {out['decode_ms_mean']:.1f} ms mean over "
        f"{out['decode_step_calls']} calls; peak {peak_gb:.1f} GB; launches "
        f"{launches}")
    del engine
    _release(torch)
    return out


def profile_decode(torch, decode, engine, captured, label: str,
                   steps: int = 5):
    """Device time by kernel over a few decode steps of ``decode`` on the
    captured inputs (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    def run():
        cache = {k: {n: v.clone() for n, v in c.items()}
                 for k, c in captured["cache"].items()}
        torch.cuda.synchronize()
        return decode(engine.params, engine.lora_pool, captured["tokens"],
                      cache, captured["pos"], captured["sids"])

    for _ in range(2):
        run()
    torch.cuda.synchronize()
    wall = 0.0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall += time.perf_counter() - t0
    rows = []
    # host waits on the device: the runtime's synchronising calls (less
    # the two of the loop above per step) and device-to-host copies
    sync_calls = dtoh = 0
    for ev in prof.key_averages():
        if ev.key in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                      "cudaEventSynchronize"):
            sync_calls += ev.count
        if ev.device_type == torch.autograd.DeviceType.CUDA and (
                "DtoH" in ev.key or "Device -> Pageable" in ev.key
                or "Device -> Pinned" in ev.key):
            dtoh += ev.count
        # device-side rows only (kernels, memcpy, memset): a CPU op's row
        # repeats the device time of the kernels it launched
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = ev.self_cuda_time_total
        rows.append((dev_us, ev.key, ev.count))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    kernel_ms = {name: sum(r[0] for r in rows if name in r[1]) / 1e3 / steps
                 for name in ("sgmv_shrink", "sgmv_expand")}
    kernel_calls = {name: sum(r[2] for r in rows if name in r[1]) / steps
                    for name in kernel_ms}
    syncs = max(0, sync_calls - 2 * steps) / steps
    log(f"profile ({label}): {steps} decode steps, wall "
        f"{1e3 * wall / steps:.2f} ms/step, device busy "
        f"{busy_ms / steps:.2f} ms/step "
        f"({100 * busy_ms / (1e3 * wall):.1f}% of wall), "
        f"{sum(r[2] for r in rows) // steps} device ops/step, "
        f"{syncs:.1f} sync calls and {dtoh / steps:.1f} device-to-host "
        f"copies per step; " + ", ".join(
            f"{k} {v:.3f} ms/step ({kernel_calls[k]:.0f} calls)"
            for k, v in kernel_ms.items()))
    for us, key, count in rows[:15]:
        log(f"  {us / 1e3 / steps:8.3f} ms/step  {count // steps:5d}/step"
            f"  {key[:90]}")
    return dict(wall_ms_per_step=1e3 * wall / steps,
                busy_ms_per_step=busy_ms / steps,
                device_ops_per_step=sum(r[2] for r in rows) / steps,
                sync_calls_per_step=syncs, dtoh_copies_per_step=dtoh / steps,
                kernel_ms_per_step=kernel_ms,
                kernel_calls_per_step=kernel_calls,
                top=[dict(ms_per_step=us / 1e3 / steps,
                          calls_per_step=count / steps, name=key)
                     for us, key, count in rows[:40]])


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile decode steps by kernel")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {SRC}: run from a "
              "checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()

    # ---- 1. the card ----------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}; allow_tf32 matmul="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
        f"{torch.backends.cudnn.allow_tf32}")

    # ---- 2. build ---------------------------------------------------------
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    build_s = _build.build()
    check(sorted(build_s) == ["decode_attention", "flash_prefill",
                              "paged_gather", "sgmv"],
          f"unexpected kernel sources {sorted(build_s)}")
    log(f"kernel build {time.perf_counter() - t0:.1f}s wall, one nvcc per "
        "source: " + ", ".join(f"{n}.cu {t:.1f}s"
                               for n, t in sorted(build_s.items())))

    # ---- 3. kernels -----------------------------------------------------
    t0 = time.perf_counter()
    rows = kernel_phase(torch, dev)
    for r in rows:
        log("  " + json.dumps(r))
    gather_rows = gather_phase(torch, dev)
    attention = attention_phase(torch, dev)
    log(f"kernel phase {time.perf_counter() - t0:.1f}s")

    # ---- 4. serve -------------------------------------------------------
    serve, shared = serve_phase(torch, dev, args.profile)
    _release(torch)
    step_check = step_check_phase(torch, dev, shared)
    _release(torch)

    # ---- 5-6. paged KV, prefix cache, chunked prefill -------------------
    t0 = time.perf_counter()
    paged = paged_compare_phase(torch, dev, shared)
    prefix = prefix_chunk_phase(torch, dev, shared)
    log(f"paged phases {time.perf_counter() - t0:.1f}s")

    def pick(kernel):
        """The main path's decode shape: 8 bf16 rows, 4096 wide."""
        return next(r for r in rows if r["kernel"] == kernel
                    and r["phase"] == "decode" and r["dtype"] == "bfloat16"
                    and r["d"] == 4096)

    sources = {"sgmv_shrink": "src/repro/kernels/sgmv.py:62",
               "sgmv_expand": "src/repro/kernels/sgmv.py:98"}
    kernels = []
    for name, replaces in sources.items():
        r = pick(name)
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/sgmv.cu", replaces=replaces,
            launches=serve["launches"][name],
            launches_prefill=serve["path_launches"]["prefill"][name],
            launches_decode=serve["path_launches"]["decode"][name],
            max_abs_err=max(x["max_abs_err"] for x in rows
                            if x["kernel"] == name),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            bound_padded_ms=r["bound_padded_ms"], host_us=r["host_us"],
            shape=f"decode T={r['T']} (T_pad={r['T_pad']}) d={r['d']} "
                  f"r={RANK} R={R_POOL} {r['dtype']} x, f32 pool"))
    g = next(r for r in gather_rows if r["dtype"] == "bfloat16")
    gather_launches = {"paged_compare": paged["paged"]["launches"][
        "paged_gather_pages"], "prefix_chunk": prefix["launches"][
        "paged_gather_pages"]}
    kernels.append(dict(
        name="paged_gather_pages", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_gather.cu",
        replaces="src/repro/kernels/paged_gather.py:31",
        launches=sum(gather_launches.values()),
        launches_by_serve=gather_launches,
        max_abs_err=max(r["max_abs_err"] for r in gather_rows),
        ms=g["ms"], plain_ms=g["plain_ms"], bound_ms=g["bound_ms"],
        bound_by=g["bound_by"], library_ms=g["library_ms"],
        shape=f"ng={g['ng']} n_pages={g['n_pages']} bs={g['bs']} "
              f"F={g['F']} B={g['B']} MB={g['MB']} bf16"))
    # the attention kernels: launches over every serve, times at the main
    # path's bf16 shape (decode step; full prefill group)
    serves = {"dense": serve["launches"],
              "paged_compare_dense": paged["dense"]["launches"],
              "paged_compare_paged": paged["paged"]["launches"],
              "prefix_chunk": prefix["launches"]}
    for name, src, replaces, pick_row in (
            ("flash_decode", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:85",
             lambda r: r["kv_dtype"] == "bfloat16"),
            ("flash_prefill", "flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:82",
             lambda r: r["case"] == "prefill"
             and r["dtype"] == "bfloat16")):
        mine = [r for r in attention if r["kernel"] == name]
        r = next(x for x in mine if pick_row(x))
        by_serve = {k: v[name] for k, v in serves.items()}
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=sum(by_serve.values()), launches_by_serve=by_serve,
            max_abs_err=max(x["max_abs_err"] for x in mine),
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            host_us=r["host_us"], shape=r["shape"]))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, build_s=build_s,
             kernels=kernels, kernel_rows=rows, gather_rows=gather_rows,
             attention_rows=attention, step_check=step_check,
             serve=serve,
             paged_compare=paged, prefix_chunk=prefix,
             seconds=time.perf_counter() - t_start), indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
