#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py             # the whole check; needs one CUDA GPU
    python3 chip_smoke.py --profile   # also profile decode steps by kernel

Phases (any failure exits non-zero; nothing falls back to the CPU):

1. The card: ``nvidia-smi`` name and power limit, torch/CUDA versions;
   TF32 off for matmuls and cuDNN.
2. Build every CUDA kernel of the port with nvcc (``sm_90a``) from the
   sources in this checkout.
3. Kernels: ``sgmv_shrink``, ``sgmv_expand`` and the full ``ops.sgmv`` on
   the card against their plain PyTorch versions at the main path's
   shapes (Llama-3.1-8B LoRA: d ∈ {4096, 1024, 14336}, r = 32, R = 20
   pool slots; T = 8 decode rows and every prefill group size the serve
   forms, 1..8 rows × buckets 32/64 = 32..512 tokens, which reaches every
   block size and accumulator layout of the kernels; bf16 and f32
   activations, f32 pool), each timed with CUDA events (L2 flushed
   between launches) beside its plain version, a one-call library
   yardstick, and the least time the card could take (its bound: the
   bytes and FLOPs of the T real rows and the adapters they use; the
   figure for the whole padded buffer the kernels walk is kept beside
   it as ``bound_padded_ms``).
4. Serve: ``EdgeLoRAEngine`` on the full Llama-3.1-8B config (bf16, 32
   layers, random weights from a seeded ``torch.Generator`` on the card,
   rescaled to fan-in scale),
   ``policy='edgelora'``, ``lora_backend='auto'`` (must resolve to
   ``sgmv``), serving a synthetic multi-tenant trace to completion with
   adapters that have nonzero B. The kernels' launch counts are zeroed
   just before the serve and must have risen just after, in its prefill
   steps and in its decode steps alike (each counted apart). On one decode
   step's inputs, the ``sgmv`` and ``einsum`` backends must agree on the
   logits.

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
# adapters: A ~ N(0, 1/r) as the reference draws it; B ~ N(0, B_STD^2)
# instead of zeros, which makes each LoRA delta about 15% of its base
# projection at fan-in scale
B_STD = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts) -> None:
    print(*parts, flush=True)


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
    """Mean wall ms of ``fn`` up to a device sync. For the whole
    ``ops.sgmv`` path: its grouping plan synchronises with the host
    (``torch.bincount``), so device events would time host gaps anyway."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / iters


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
    rows = []

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
                bs = plan.block_slots
                got = sgmv.sgmv_shrink(xbuf, a, bs, blk_t=blk_t)
                want = sgmv.shrink_plain(xbuf, a, bs, blk_t=blk_t)
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
                    max_abs_err=e,
                    ms=cuda_ms(torch, lambda: sgmv.sgmv_shrink(
                        xbuf, a, bs, blk_t=blk_t), flush),
                    plain_ms=cuda_ms(torch, lambda: sgmv.shrink_plain(
                        xbuf, a, bs, blk_t=blk_t), flush),
                    library_ms=cuda_ms(torch, lambda: torch.bmm(xb, a_t),
                                       flush),
                    bound_ms=bnd, bound_by=by, bound_padded_ms=bnd_pad))
            for d_out in EXPAND_D:
                _, _, b, slots, blk_t, plan, xbuf = inputs(t, 16, d_out, dtype)
                bs = plan.block_slots
                s = torch.randn(xbuf.shape[0], RANK, generator=gen,
                                device=dev)
                got = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t,
                                       compute_dtype=dtype)
                want = sgmv.expand_plain(s, b, bs, blk_t=blk_t,
                                         compute_dtype=dtype)
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
                    T_pad=s.shape[0], blk_t=blk_t, d=d_out, max_abs_err=e,
                    ms=cuda_ms(torch, lambda: sgmv.sgmv_expand(
                        s, b, bs, blk_t=blk_t, compute_dtype=dtype), flush),
                    plain_ms=cuda_ms(torch, lambda: sgmv.expand_plain(
                        s, b, bs, blk_t=blk_t, compute_dtype=dtype), flush),
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
                rows.append(dict(
                    kernel="ops.sgmv", phase=phase, dtype=dname, T=t,
                    module=mod, d_in=d_in, d_out=d_out, max_abs_err=e,
                    wall_ms=host_ms(torch, lambda: ops.sgmv(
                        x, a, b, slots, 2.0, n_slots=R_POOL, blk_t=None))))
            log(f"kernels {phase:7s} T={t:3d} {dname:8s} ok")
    return rows


# ---------------------------------------------------------------------------
# phase 4: serve the full model through the sgmv kernels
# ---------------------------------------------------------------------------


def serve_phase(torch, dev, profile: bool):
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.kernels import sgmv
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
                        max_ctx=256, prompt_buckets=(32, 64),
                        lora_backend="auto", seed=0)
    t0 = time.perf_counter()
    engine = EdgeLoRAEngine(cfg, ecfg, device=dev,
                            adapter_source=adapter_source)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    check(engine.lora_backend == "sgmv",
          f"lora_backend 'auto' resolved to {engine.lora_backend!r}")
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
    path_launches = {p: dict.fromkeys(sgmv.launches, 0) for p in step_ms}
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
            before = dict(sgmv.launches)
            t = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            step_ms[name].append(1e3 * (time.perf_counter() - t))
            for k, n in sgmv.launches.items():
                path_launches[name][k] += n - before[k]
            return out
        return run

    raw_decode = engine._decode
    engine._prefill = timed("prefill", engine._prefill)
    engine._decode = timed("decode", engine._decode)

    torch.cuda.reset_peak_memory_stats(dev)
    sgmv.reset_launches()
    t0 = time.perf_counter()
    summary = engine.serve(trace)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = dict(sgmv.launches)
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

    check(summary.n_completed == summary.n_requests == len(trace),
          f"completed {summary.n_completed}/{summary.n_requests}")
    for r in trace:
        check(r.finish_time is not None and len(r.tokens) == r.generated > 0,
              f"request {r.request_id} unfinished")
        check(all(0 <= t < cfg.vocab_size for t in r.tokens),
              f"request {r.request_id}: token out of range")
    for path, counts in path_launches.items():
        for name, n in counts.items():
            check(n > 0, f"{name} was never launched in the serve's "
                  f"{path} steps")
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

    prof = (profile_decode(torch, raw_decode, engine, captured)
            if profile else None)
    return dict(summary=dataclasses.asdict(summary), launches=launches,
                path_launches=path_launches, launches_per_step=per_step,
                init_s=init_s,
                serve_s=serve_s, step_ms=step_ms, peak_gb=peak_gb,
                backend_max_abs=d, backend_max_logit=scale_l,
                top1_agree=int(agree.sum()), profile=prof)


def profile_decode(torch, decode, engine, captured, steps: int = 5):
    """Device time by kernel over a few decode steps on the captured
    inputs (torch.profiler)."""
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
    for ev in prof.key_averages():
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
    log(f"profile: {steps} decode steps, wall {1e3 * wall / steps:.2f} "
        f"ms/step, device busy {busy_ms / steps:.2f} ms/step "
        f"({100 * busy_ms / (1e3 * wall):.1f}% of wall), "
        f"{sum(r[2] for r in rows) // steps} device ops/step")
    for us, key, count in rows[:15]:
        log(f"  {us / 1e3 / steps:8.3f} ms/step  {count // steps:5d}/step"
            f"  {key[:90]}")
    return dict(wall_ms_per_step=1e3 * wall / steps,
                busy_ms_per_step=busy_ms / steps,
                device_ops_per_step=sum(r[2] for r in rows) / steps,
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
    _build.build()
    log(f"kernel build {time.perf_counter() - t0:.1f}s "
        f"({', '.join(_build.sources())})")

    # ---- 3. kernels -----------------------------------------------------
    t0 = time.perf_counter()
    rows = kernel_phase(torch, dev)
    for r in rows:
        log("  " + json.dumps(r))
    log(f"kernel phase {time.perf_counter() - t0:.1f}s")

    # ---- 4. serve -------------------------------------------------------
    serve = serve_phase(torch, dev, args.profile)

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
            bound_padded_ms=r["bound_padded_ms"],
            shape=f"decode T={r['T']} (T_pad={r['T_pad']}) d={r['d']} "
                  f"r={RANK} R={R_POOL} {r['dtype']} x, f32 pool"))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, kernels=kernels,
             kernel_rows=rows, serve=serve,
             seconds=time.perf_counter() - t_start), indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
