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
   version, timed beside it, ``torch.index_select`` and its bound, with
   the plan's vector width and its share of the bound.
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

7. qwen2-0.5b at full width (bf16, 24 layers, d 896, 14/2 heads, hd 64,
   d_ff 4864, vocab 151936, QKV bias drawn nonzero, tied embeddings; LoRA
   rank 16 on q,k,v,o,up,gate,down, a pool of 32, 64 adapters, whose
   17.6 MB each fit llamacpp's default ``memory_budget``), every serve
   under its own fake timer: ``edgelora``, ``llamacpp`` (merged only) and
   ``dlora`` on a single-adapter trace (merged only) and on an
   adapter-diverse one (must unmerge), each dense and paged with equal
   streams and summaries. Every step call is counted apart: each SGMV
   kernel 168 times (7 modules x 24 layers) on an unmerged step and never
   on a merged one, the step's attention kernel 24 times, the page
   gather twice per paged decode step. The kernel phase (3) runs again
   at qwen2-0.5b's decode and full-prefill shapes.
8. Tracing: one ``edgelora`` serve with an ``EngineTracer``: streams and
   summary equal to the untraced serve's; the exported trace
   (``chiprun_out/qwen2_trace.json``) passes ``tools/trace_export.py``
   and reads back through ``tools/trace_report_torch.py`` (the
   reference's report on the port's serving modules). Then an
   ``edgelora`` serve on an overcommitted arena (24 pages, a seventh of
   dense capacity) with the prefix cache: deferrals or preemptions,
   copy-on-write pages, streams equal to a dense serve's. Then
   ``llamacpp`` and ``dlora`` (adapter-diverse) over 4 tenants' 32-token
   system prompts in 32-token chunks, dense (chunked) and paged with the
   prefix cache: equal streams, prefix hits, llamacpp's merged suffix
   steps (``_prefill_sfx_dense_merged``, ``_prefill_suffix_merged``)
   counted, dlora's suffix steps run.
9. Full-width bf16 steps of qwen2-0.5b, llama3.2-3b and openelm-1.1b:
   one prefill and one decode step on four routes (attention kernels
   on/off x sgmv/einsum LoRA), the kernel route's logits held against
   each other route's, each route's kernel launches held.

10. The learned router (runs after phase 6, on phase 4's Llama-3.1-8B
    weights; its data draws token ids from the first 4096 of the
    vocabulary, the model stays at full width): a router head trained
    with Table 12's settings (240 prompts of 32 tokens, 4 tasks, 40
    adapters; 6 epochs on 192, batch 16, lr 3e-3; the BCE must fall) and
    its top-1 accuracy on the other 48 beside chance and the best static
    adapter; ``scores_batch`` on [8, 32] with ``flash_prefill`` against
    plain attention (within 1e-2 of max|plain|; the pooled features
    within 5e-2), each router call one ``flash_prefill`` launch per layer
    and nothing else; ``edgelora`` + ``LearnedRouter`` against
    ``edgelora_no_aas`` on phase 4's trace under the real timer, two
    serves each in turns (Table 6's first-token ratio), then phase 5's
    burst arrivals (outputs of 4–12 tokens) under one fake timer with
    router batching on and off, dense, and on, paged (every serve
    completes, router steps ≤ requests, paged streams and selections
    equal dense); a 12-step LoRA fine-tune
    (``train_loop``, batch 4 × 64, peak lr 5e-3, warmup 2): base params
    bit-equal after, every LoRA leaf changed, the loss falling, no
    kernel launched (training differentiates the plain attention), and
    the adapter's checkpoint round trip exact.

11. The dense attention variants at full width (after phase 9), bf16,
    random weights as ``prepare_weights`` draws them (QK-norm and
    post-norm scales nonzero; gemma2's tied embedding at 1/sqrt(d), as it
    scales it up by sqrt(d)). Each model's kernels first, at its shapes,
    against their plain versions, timed beside them, the library call and
    the bound: SGMV at its decode widths, ``flash_decode`` over its
    4096/4608-entry rings (window 4096, softcap 50 for gemma2; gemma2's
    int8 ring with bf16 scales too, the scales' cast timed apart),
    ``flash_prefill`` at [2, 4352] past the window (chameleon: [8, 64]),
    the page gather at gemma2's paged step at all 42 layers (21 groups x
    8 rows x 289 entries: bf16 and int8 K pages, bf16 scale pages).
    gemma2-9b (full width, 12 of its 42 layers, which keeps the run
    inside its time: d 3584, 16/8 heads, hd 256, d_ff 14336, vocab
    256000, tied, local/global slots, window 4096, softcaps 50/30,
    post-norms, scaled embeddings; LoRA rank 16 on 7 modules, a pool of
    8): a route check (2 rows of 4352 and 4200 tokens, 4 decode steps on
    the wrapped rings; the kernel route against plain attention and
    einsum LoRA within ``ROUTE_TOL``, 12 ``flash_prefill`` launches a
    prefill and 12 ``flash_decode`` a decode step, 84 of each SGMV
    kernel a step), the same prefill and one decode step with an int8
    cache against plain attention over the dequantized ring; dense vs
    paged ``edgelora`` serves of 8 requests (3 prompts of 4100–4400
    tokens, ``max_ctx`` 4608), bf16 and int8, under one fake timer: equal
    streams and summaries, 4 page-gather launches per paged decode step
    (8 with the scales), 84 of each SGMV kernel per unmerged step call;
    ``prefix_cache`` and ``prefill_chunk`` refused with the reference's
    ``ValueError``. starcoder2-7b (32 layers, d 4608, 36/4 heads, d_ff
    18432, vocab 49152, QKV bias, all-local window 4096, non-GLU GELU,
    untied): the route check at 4352, dense vs paged ``edgelora``, a
    ``llamacpp`` serve (merged: no SGMV launch; a pool without ``gate``).
    chameleon-34b at full width and 8 of its 48 layers (64/8 heads, d_ff
    22016, vocab 65536, QK-norm): the four-route check at [8, 64], an
    ``edgelora`` serve paged with the prefix cache and 32-token chunks
    against a dense serve, in bf16 (streams counted: its logits tie in
    bf16, and the suffix and chunk steps run other GEMM and SGMV shapes
    than whole-prompt prefills) and in f32 (streams held equal).

12. The MoE family at full width (after phase 11), bf16, random weights
    drawn one stacked group at a time (``_moe_params``: the routers f32,
    the expert stacks [ng, E, d, f] at fan-in scale). Each model's SGMV
    and attention kernels at its shapes, as in phase 11, and one MoE
    layer's expert FFN (three ``torch.bmm`` over all E experts) at a
    decode step's buffer and at the route check's prefill, beside the
    bytes of all E experts' weights at the HBM rate (the decode step's
    floor: the capacity path reads every expert), and the whole
    ``moe_block`` at decode.
    dbrx-132b (full width, 8 of its 40 layers: d 6144, 48/8 heads, d_ff
    10752, vocab 100352, 16 experts top-4; LoRA rank 16 on q,k,v,o, a
    pool of 8, 16 adapters): a route check at [2, 4096] (8192 choices a
    MoE layer past the lossless 4096: a capacity of 2560 an expert, the
    dropped choices reported) and 4 lossless decode steps, the kernel
    route against plain attention and einsum LoRA within ``ROUTE_TOL``;
    dense vs paged ``edgelora`` serves of 8 requests (groups of up to 8 x
    256 tokens: a finite capacity in serving too), equal streams and
    summaries; ``llamacpp`` (merged only) and ``dlora`` (unmerges) serves
    on short prompts; a paged serve with the prefix cache and 32-token
    chunks against a dense one, counted in bf16 at 8 layers and held
    equal in f32 at 2 layers (every group lossless, so chunks drop
    nothing a whole prompt keeps). llama4-maverick (full width, 4 of its
    48 layers and 32 of its 128 experts: d 5120, 40/8 heads, d_ff 8192,
    vocab 202048, top-1 and a shared expert, MoE on slots 1 and 3, three
    chunked-local slots of 8192 and a global one): a route check at
    [2, 8704] past the chunk boundary and 4 decode steps on the chunked
    rings; dense vs paged ``edgelora`` serves of 8 requests (3 prompts of
    8200-8600 tokens, ``max_ctx`` 8704), equal streams; the prefix cache
    and chunks refused with the reference's ``ValueError``. Every step
    call of every serve counted: 32 (dbrx) and 16 (llama4) launches of
    each SGMV kernel an unmerged step, one attention launch a layer, the
    gathers of a paged decode step (2 and 8).

13. The SSM family and qwen1.5-110b at full width (after phase 12),
    bf16. Each model's kernels at its shapes, as in phases 11-12: SGMV at
    its decode rows and its route check's prefill (8192 or 4096 rows);
    for zamba2 ``flash_decode`` (q [8, 32, 80] over a 4096 ring) and
    ``flash_prefill`` ([2, 4096, 32/32, 80]) at head dim 80 and the page
    gather of its shared ring; for qwen1.5 the same at [2, 2048] and hd
    128. One ``ssm_block_full`` at [2, 4096] and one ``ssm_block_decode``
    at 8 rows (plain PyTorch, as the reference computes the SSD) timed
    beside their bound. mamba2-130m (all 24 layers: d 768, 24 SSD heads
    of 64, d_state 128, tied; LoRA rank 16 on in_proj and out_proj, a
    pool of 16) and zamba2-2.7b (all 54 layers and 9 shared-block
    applications: d 2560, 32/32 heads of hd 80, an MLP of 10240 on every
    Mamba slot and in the shared block, d_state 64, 80 SSD heads; LoRA on
    in_proj, out_proj and the shared q, k, v, o): a route check at
    [2, 4096] with ragged lengths and 4 decode steps, the kernel route
    against plain attention and einsum LoRA, counted in bf16 (there the
    routes differ by ~10 % of max|logit|: rounding amplified through the
    gated SSD blocks) and held within ``F32_ROUTE_TOL`` in f32 (mamba2 at
    full depth, zamba2 at 12 of 54 layers); dense
    vs paged ``edgelora`` serves of 8 requests with equal streams and
    summaries (mamba2's paged serve is the pool's bookkeeping only),
    ``llamacpp`` (merged only) and ``dlora`` serves; the prefix cache and
    chunked prefill refused with the reference's ``ValueError``; the
    state carry in f32 (at the f32 route check's depths): a prefill of S tokens then a decode step equals the last position of
    a prefill of S + 1 within 1e-4 of max|logit|. qwen1.5-110b (full
    width, 16 of its 80 layers: d 8192, 64/8 heads, d_ff 49152, vocab
    152064, QKV bias, untied): the route check at [2, 2048] held within
    ``ROUTE_TOL`` in bf16, the same serves. Every step call counted: 48 (mamba2), 144 (zamba2: 108 +
    36) and 112 (qwen1.5) launches of each SGMV kernel an unmerged step;
    0, 9 and 16 attention launches a step; 0, 2 and 2 gathers a paged
    decode step.

14. whisper-medium, the encoder-decoder family, at full depth (after
    phase 13): 24 encoder + 24 decoder layers, d 1024, 16/16 heads of hd
    64 (GQA 1), a GELU MLP of 4096, no RoPE, vocab 51865, LoRA rank 16 on
    q, v, o, up, down (the cross block: q, o), bf16, random weights at
    fan-in scale from a seeded generator on the card, frames N(0, 1) of
    [B, 1500, 1024]. Its kernels at its shapes: SGMV at d 1024 / 4096 at
    8 decode rows and the encoder's 3000 rows, ``flash_decode`` at hd 64
    GQA 1 over a 448-entry ring, ``flash_prefill`` non-causal at
    [2, 1500, 16/16, 64] (the encoder's). Route checks in bf16 (held at
    5e-2) and f32 (held at ``F32_ROUTE_TOL``): ``forward``, a ``prefill``
    of 3 right-padded rows with mixed adapters and 3 decode steps, the
    kernel route against plain attention and einsum LoRA; every call's
    launches counted: 48 ``flash_prefill`` a forward or prefill (24 of
    them non-causal, counted by ``_CausalProbe``), 24 ``flash_decode`` a
    decode step, each SGMV kernel 288 times a prefill (120 encoder + 120
    decoder + 48 cross) and 168 a decode step. ``encode`` at [2, 1500] on
    both routes and one layer's ``cross_attention`` at a prefill and at
    a decode step (plain PyTorch, as in the reference), timed beside
    their bound; two LoRA train steps (loss, grad norm, ms, peak memory;
    no kernel launched); the engine's refusal (no ``frames``).

15. The distributed layer and ``remat`` (after phase 14; no kernel runs
    on these paths). (a) llama3-8b LoRA train steps at full width and
    depth, B 1, on the plain route, with ``remat`` off and on at the
    longest S of 4096, 2048, 1024 that fits without it (an out-of-memory
    S is recorded), then with ``remat`` at 4096: loss, grad norm, AdamW
    moments and adapter bit-equal (else within ``REMAT_TOL``, recorded),
    peak memory and the median ms of 3 warm steps of each. (b) qwen2-0.5b
    at full width and depth, bf16, plain route, prefill [8, 512] and a
    decode step over a 4096 ring: the dry-run's arguments on a one-rank fake mesh against
    the card's allocation growth for the same arguments (within 1 %),
    ``launch/analysis.step_cost`` on the card's tensors equal to its
    count on fake copies, each step's device time at least its largest
    one-GPU roofline term. (c) ``launch/dryrun.run_combo`` of decode_32k
    at full depth on the fake 16x16 mesh for dbrx-132b, llama4-maverick
    and qwen1.5-110b (all ``ok``; args/dev, dominant term with and
    without the replicate fallback's gathers, trace s), in this process;
    after the first arch, one that would take the phase past 90 s is
    skipped and recorded so.

16. The repo's examples on the card (after phase 15). (a) The four
    ``examples/*_torch.py`` as written, ``--device cuda``, each in a child
    process (started together), which prints its kernel launch counts
    after the script: exit code 0; the quickstart's max err and decoded
    tokens, the multi-tenant serve's three rows (``llamacpp`` refused:
    out of memory), the SSM example's 72.1 KB state, the training
    example's losses, per-task evaluation (each task's own adapter below
    the base model, the other task's not) and router accuracy; the
    quickstart launches each SGMV kernel 140 times, ``flash_prefill`` 12
    and ``flash_decode`` 16, the multi-tenant serve all four, the SSM
    serve the SGMV pair and no attention kernel (mamba2 has no
    attention), the training example ``flash_prefill`` only (evaluation
    and the router's trunk; its train steps run the plain route). (b) The
    quickstart's body at Llama-3.1-8B's full width and depth (bf16,
    fan-in weights, rank-32 adapters with nonzero B, 4 tenants x 16
    tokens, 8 decode steps) on the kernel route (2240 launches of each
    SGMV kernel, 192 ``flash_prefill``, 256 ``flash_decode``) and the
    plain route (none): batched against per-request error relative to
    max|logit| on each, and the decoded tokens the routes share; then in
    f32 at the example's reduced size, on fan-in weights, where batched
    and per-request must agree within ``QUICKSTART_F32_TOL`` of
    max|logit| on the kernel route, and on the example's own weights,
    recorded beside how far a one-ulp perturbation of their params moves
    the logits (their attention scores reach ~3000). (c) mamba2-130m at
    full width and depth: the decode state's bytes, equal for a 64 and a
    524288-token context, and decode steps at positions 10, 10 000 and
    500 000.

17. The kernels' whole domain (after phase 10, on phase 4's Llama-3.1-8B
    weights). Kernel rows, each held against its plain version and timed
    as in phase 3 (L2 flushed, the bound, the library call, the wrapper's
    host µs): the SGMV pair at LoRA rank 128 at the decode step (8 rows,
    d 4096) and the full prefill group (512 rows, d 14336), at rank 100
    (not a multiple of 16) at the decode step, and at ``blk_t`` 256 over a
    full group; ``flash_decode`` (q [8, 32, hd] over a 256-entry ring) and
    ``flash_prefill`` ([8, 64, 32/8, hd] causal) in bf16 at head dims 96,
    192 and 320 (no config of the repo has them: the rows are padded in
    shared memory to the kernels' widths 96 and 192; 320 takes the
    run-time width). Llama-3.1-8B at full width and depth with rank-128
    adapters (5 modules, a pool of 8 slots, 16 adapters of 0.9 GB): the
    four-route check of phase 9 (prefill [8, 64], 2 decode steps, an
    idle row) and an ``edgelora`` dense serve of 8 requests under a fake
    timer, 160 launches of each SGMV kernel an unmerged step call. The
    same route check and a paged ``edgelora`` serve for Llama-3.1-8B's
    widths at head dims 96 and 192, 4 of 32 layers.

Each serve's kernel launch counts are zeroed just before it and read just
after; every kernel its path runs must have launched.

After the last phase, each module-level cache of the port's compile and
cache registry (``tools/lint_torch/compile_registry.json``, checked by
``tools/lint_torch`` rule EL003) is counted: a count over the bound its
entry states fails the run; an entry with no numeric bound is counted and
not held.

Prints a ``{"kernels": [...]}`` line, then a ``{"caches": {...}}`` line,
then as its last line ``{"ok": true, "device": {...}}``. Writes details
to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
REGISTRY = ROOT / "tools" / "lint_torch" / "compile_registry.json"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SLEEP_CYCLES = 4_000_000                    # ~2 ms of device time
R_POOL, RANK, N_SLOTS = 20, 32, 8          # llama3_8b max_resident, rank
MAX_CTX, KV_BLOCK = 256, 16                 # the serves' max_ctx, page size
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

# The shapes each kernel phase runs at, per model: LoRA pool slots and
# rank, shrink d_in and expand d_out, the LoRA modules (d_in, d_out), the
# (phase, T) cases, attention heads (h, kv heads, head dim) and layers;
# optionally the SGMV token block (``blk_t``; default ``ops.auto_blk_t``).
LLAMA_SPEC = dict(
    model="llama3.1-8b", r_pool=R_POOL, rank=RANK, shrink_d=SHRINK_D,
    expand_d=EXPAND_D, modules=MODULES, cases=CASES,
    heads=(N_HEADS, N_KV_HEADS, HEAD_DIM), layers=N_LAYERS)
# qwen2-0.5b (configs/qwen2_0_5b.py): 24 layers, d 896, 14 heads over 2
# kv heads (GQA group 7), hd 64, d_ff 4864; LoRA rank 16 on all seven
# modules, a pool of 32; its decode step and its full prefill group
QWEN_SPEC = dict(
    model="qwen2-0.5b", r_pool=32, rank=16, shrink_d=(896, 4864),
    expand_d=(128, 896, 4864),
    modules={"q": (896, 896), "k": (896, 128), "v": (896, 128),
             "o": (896, 896), "up": (896, 4864), "gate": (896, 4864),
             "down": (4864, 896)},
    cases=[("decode", N_SLOTS), ("prefill", 512)], heads=(14, 2, 64),
    layers=24)


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


def kernel_phase(torch, dev, spec):
    from repro_torch.kernels import ops, ref, sgmv

    r_pool, rank, model = spec["r_pool"], spec["rank"], spec["model"]
    gen = torch.Generator(device=dev).manual_seed(1234)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    # the timing method's floor: one 4-byte memset timed as the kernels are
    tiny = torch.empty(1, dtype=torch.float32, device=dev)
    rows = [dict(kernel="event_floor", model=model,
                 ms=cuda_ms(torch, tiny.zero_, flush))]
    log(f"event floor (one 4-byte memset): {1e3 * rows[0]['ms']:.1f} us")

    def inputs(t, d_in, d_out, dtype):
        x = torch.randn(t, d_in, generator=gen, device=dev).to(dtype)
        a = torch.randn(r_pool, rank, d_in, generator=gen,
                        device=dev) / rank ** 0.5
        b = torch.randn(r_pool, d_out, rank, generator=gen,
                        device=dev) * 0.01
        slots = torch.randint(0, r_pool, (t,), generator=gen, device=dev,
                              dtype=torch.int32)
        blk_t = spec.get("blk_t") or ops.auto_blk_t(t, r_pool)
        plan = ops.plan_grouping(slots, r_pool, blk_t)
        xbuf = x.new_zeros((plan.n_padded, d_in))
        xbuf[plan.padded_pos.long()] = x[plan.perm]
        return x, a, b, slots, blk_t, plan, xbuf

    def err(got, want, dtype, exact=None):
        """max|got - want|, held within TOL[dtype] of max|want|; with
        ``exact`` (the f64 product), a longer f32 sum may also pass by
        lying no further from it than twice the plain version does."""
        d = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        if d > TOL[dtype] * scale and exact is not None:
            dk = (got.double() - exact).abs().max().item()
            dp = (want.double() - exact).abs().max().item()
            log(f"  f32 sum over d={got.shape} vs the f64 product: kernel "
                f"{dk:.3e}, plain {dp:.3e} (max|ref| {scale:.3e})")
            check(dk <= 2 * dp, f"max abs err {d:.3e} > {TOL[dtype]:.1e} x "
                  f"{scale:.3e}, and {dk:.3e} from the f64 product, more "
                  f"than twice the plain version's {dp:.3e}")
            return d
        check(d <= TOL[dtype] * scale,
              f"max abs err {d:.3e} > {TOL[dtype]:.1e} x {scale:.3e}")
        return d

    def shrink_f64(xbuf, a, bs, blk_t, nu, dtype):
        """The shrink's exact product: x and the A tiles rounded to the
        activation type as the kernel reads them, summed in f64."""
        nb = bs.numel()
        out = torch.einsum("ntd,nrd->ntr",
                           xbuf.double().reshape(nb, blk_t, -1),
                           a[bs.long()].to(dtype).double())
        live = torch.arange(nb, device=out.device) < nu.to(out.device)
        return (out * live[:, None, None]).reshape(nb * blk_t, -1)

    for dname in spec.get("dtypes", ("bfloat16", "float32")):
        dtype = getattr(torch, dname)
        esize = torch.empty((), dtype=dtype).element_size()
        for phase, t in spec["cases"]:
            for d_in in spec["shrink_d"]:
                x, a, _, slots, blk_t, plan, xbuf = inputs(t, d_in, 16, dtype)
                bs, nu = plan.block_slots, plan.n_used
                got = sgmv.sgmv_shrink(xbuf, a, bs, blk_t=blk_t, n_used=nu)
                want = sgmv.shrink_plain(xbuf, a, bs, blk_t=blk_t,
                                         n_used=nu)
                torch.cuda.synchronize()
                e = err(got, want, "float32",
                        exact=shrink_f64(xbuf, a, bs, blk_t, nu, dtype))
                nb = bs.numel()
                xb = xbuf.reshape(nb, blk_t, d_in)
                a_t = a[bs.long()].to(dtype).transpose(1, 2).contiguous()
                # the function: T real rows of x, the A tiles of the slots
                # those rows use, T rows of s; 2·r FLOPs per x element
                used = int(torch.unique(slots).numel())
                bnd, by = bound_ms(t * d_in * esize + used * rank * d_in * 4
                                   + t * rank * 4, 2.0 * t * rank * d_in,
                                   dname)
                # what the kernels walk: every padded row and block
                pad_used = int(torch.unique(bs).numel())
                bnd_pad, _ = bound_ms(
                    xbuf.numel() * esize + pad_used * rank * d_in * 4
                    + nb * 4 + xbuf.shape[0] * rank * 4,
                    2.0 * xbuf.shape[0] * rank * d_in, dname)
                rows.append(dict(
                    kernel="sgmv_shrink", model=model, phase=phase,
                    dtype=dname, T=t, r=rank,
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
            for d_out in spec["expand_d"]:
                _, _, b, slots, blk_t, plan, xbuf = inputs(t, 16, d_out, dtype)
                bs, nu = plan.block_slots, plan.n_used
                s = torch.randn(xbuf.shape[0], rank, generator=gen,
                                device=dev)
                got = sgmv.sgmv_expand(s, b, bs, blk_t=blk_t,
                                       compute_dtype=dtype, n_used=nu)
                want = sgmv.expand_plain(s, b, bs, blk_t=blk_t,
                                         compute_dtype=dtype, n_used=nu)
                torch.cuda.synchronize()
                e = err(got, want, "float32")
                nb = bs.numel()
                sb = s.reshape(nb, blk_t, rank)
                b_t = b[bs.long()].to(dtype).float().transpose(
                    1, 2).contiguous()
                # the function: T real rows of s, the B tiles of the slots
                # those rows use, T f32 rows of y; 2·r FLOPs per y element
                used = int(torch.unique(slots).numel())
                bnd, by = bound_ms(t * rank * 4 + used * d_out * rank * 4
                                   + t * d_out * 4, 2.0 * t * rank * d_out,
                                   "float32")
                pad_used = int(torch.unique(bs).numel())
                bnd_pad, _ = bound_ms(
                    s.numel() * 4 + pad_used * d_out * rank * 4 + nb * 4
                    + s.shape[0] * d_out * 4,
                    2.0 * s.shape[0] * rank * d_out, "float32")
                rows.append(dict(
                    kernel="sgmv_expand", model=model, phase=phase,
                    dtype=dname, T=t, r=rank,
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
            for mod, (d_in, d_out) in spec["modules"].items():
                x, a, b, slots, _, _, _ = inputs(t, d_in, d_out, dtype)
                got = ops.sgmv(x, a, b, slots, 2.0, n_slots=r_pool,
                               blk_t=spec.get("blk_t"))
                want = (2.0 * ref.sgmv_ref(x, a.to(dtype), b.to(dtype),
                                           slots, 1.0)).to(dtype)
                torch.cuda.synchronize()
                e = err(got, want, dname)
                def call():
                    return ops.sgmv(x, a, b, slots, 2.0, n_slots=r_pool,
                                    blk_t=spec.get("blk_t"))
                rows.append(dict(
                    kernel="ops.sgmv", model=model, phase=phase,
                    dtype=dname, T=t,
                    module=mod, d_in=d_in, d_out=d_out, max_abs_err=e,
                    ms=cuda_ms(torch, call, flush), wall_ms=host_ms(
                        torch, call), host_us=enqueue_us(torch, call,
                                                         iters=10)))
            log(f"kernels {model} {phase:7s} T={t:3d} {dname:8s} ok")
    return rows


def gather_phase(torch, dev, spec):
    """``paged_gather_pages`` against its plain version at the paged
    decode step's shape of ``spec``'s model (one attention leaf: its
    layer groups, ``spec['max_ctx']``'s pages; by default bf16 and f32
    pages of K, ``spec['gather_cases']`` otherwise: (label, dtype,
    features per token)); timed beside the plain version,
    ``torch.index_select`` and its bound, with the wrapper's host µs per
    call. Each row records the plan's route (its vector width) and the
    share of the bound the kernel reached."""
    from repro_torch.kernels import paged_gather as pg

    gen = torch.Generator(device=dev).manual_seed(4321)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    _, kh, hd = spec["heads"]
    # one leaf of one attention slot (its groups' layers), the arena at
    # dense-equivalent capacity: ceil((max_ctx + 1) / 16) pages per
    # sequence (17 at max_ctx 256), 8 sequences, + the trash page
    ng, bs = spec.get("groups", spec["layers"]), KV_BLOCK
    b, mb = N_SLOTS, -(-(spec.get("max_ctx", MAX_CTX) + 1) // KV_BLOCK)
    n_pages = N_SLOTS * mb + 1
    # rows 0-5: distinct shuffled pages for lengths of 1..mb pages, -1
    # past each row's length; row 6 repeats pages; row 7 is idle (all -1)
    perm = torch.randperm(n_pages - 1, generator=gen, device=dev).int()
    tables = torch.full((b, mb), -1, dtype=torch.int32, device=dev)
    used = 0
    for row, n in enumerate((mb, mb - 1, mb // 2 + 1, mb, mb // 4, 1)):
        tables[row, :n] = perm[used:used + n]
        used += n
    tables[6, :6] = perm[:3].repeat(2)
    rows = []
    cases = spec.get("gather_cases", (("bfloat16", "bfloat16", kh * hd),
                                      ("float32", "float32", kh * hd)))
    for label, dname, feat in cases:
        dtype = getattr(torch, dname)
        if dtype == torch.int8:
            arena = torch.randint(-127, 128, (ng, n_pages, bs, feat),
                                  generator=gen, device=dev,
                                  dtype=torch.int8)
        else:
            arena = torch.randn(ng, n_pages, bs, feat, generator=gen,
                                device=dev).to(dtype)
        got = pg.paged_gather_pages(arena, tables)
        want = pg.paged_gather_pages_plain(arena, tables)
        torch.cuda.synchronize()
        check(torch.equal(got, want),
              f"paged_gather_pages {dname} differs from its plain version")
        idx = (tables.long() % n_pages).flatten()
        lib = torch.index_select(arena, 1, idx).reshape(got.shape)
        check(torch.equal(lib, want), "index_select yardstick differs")
        # bytes the function must move: every distinct page the tables
        # name read once, the gathered run written once, the table read
        page_bytes = bs * feat * arena.element_size()
        distinct = int(torch.unique(idx).numel())
        nbytes = (ng * distinct * page_bytes + got.numel()
                  * got.element_size() + tables.numel() * 4)
        bnd, by = bound_ms(nbytes, 0.0, "bfloat16")
        plan = pg.gather_plan(page_bytes, ng * b * mb, arena.data_ptr(),
                              got.data_ptr())
        row = dict(
            kernel="paged_gather_pages", model=spec["model"], dtype=dname,
            leaf=label, ng=ng,
            n_pages=n_pages, bs=bs, F=feat, B=b, MB=mb,
            page_bytes=page_bytes, out_pages=ng * b * mb,
            distinct_pages=distinct, out_mb=got.numel()
            * got.element_size() / 1e6, max_abs_err=0.0,
            route=f"vector {plan.vec_bytes} B", grid=plan.grid,
            ms=cuda_ms(torch, lambda: pg.paged_gather_pages(arena, tables),
                       flush),
            plain_ms=cuda_ms(torch, lambda: pg.paged_gather_pages_plain(
                arena, tables), flush),
            library_ms=cuda_ms(torch, lambda: torch.index_select(
                arena, 1, idx), flush),
            host_us=enqueue_us(torch, lambda: pg.paged_gather_pages(
                arena, tables)),
            bound_ms=bnd, bound_by=by,
            # the read-and-write-everything figure (every table entry's
            # page read, repeats and -1 included)
            bound_all_entries_ms=2 * got.numel() * got.element_size()
            / HBM_BYTES_PER_S * 1e3)
        row["bound_frac"] = bnd / row["ms"]
        rows.append(row)
        del arena, got, want, lib
        log(f"paged_gather_pages {label} ok: " + json.dumps(rows[-1]))
    return rows


def attention_phase(torch, dev, spec, full=True):
    """``flash_decode`` and ``flash_prefill`` against their plain versions
    at the shapes of ``spec``'s model (below, Llama-3.1-8B's), each timed beside its plain version, the
    library call (``scaled_dot_product_attention`` with GQA; a yardstick
    only, the port never calls it) and its bound.

    decode: one decode step's layer (q [8, 32, 128], a 256-entry ring
    [8, 256, 8, 128]) with per-row positions (rows at depths 17..256, the
    deepest wrapped, and one idle row whose ring is empty), in bf16, f32,
    and int8 K/V with f32 scales (bf16 q). prefill: a full prefill
    group's layer ([8, 64, 32, 128] causal) in bf16 and f32, and a suffix
    step's (32 queries at positions 64..95 over 64 cached + 32 fresh
    keys) in bf16. Each row also carries the wrapper's host µs per call
    (``enqueue_us``). ``full=False`` runs the bf16 decode and full
    prefill rows only. Bounds count what these inputs need: K and V of
    visible entries (only V of a row with no visible key, whose output
    is the mean of V), positions, q and out; 4·hd operations per visible
    (query head, key) pair."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp

    gen = torch.Generator(device=dev).manual_seed(99)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    (h, kh, hd), b, c = spec["heads"], N_SLOTS, MAX_CTX
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
                          ("bfloat16", "int8"))[:3 if full else 1]:
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
            kernel="flash_decode", model=spec["model"], dtype=dname,
            kv_dtype=kvname,
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
                                 ("prefill", 64, 0, "float32"))[
                                     :3 if full else 1]:
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
            kernel="flash_prefill", model=spec["model"], dtype=dname,
            case=label,
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


def compare_logits(torch, where, kern, other, live, tol, hold=True):
    """Logits of the kernel route against another route's: within
    ``tol`` of max|logit|, and top-1 equal on every live row where the
    other route's top-2 margin exceeds that (there a flip is a fault,
    not a tie broken the other way by rounding; bf16 logits tie exactly
    at times). Returns the figures, agreement over all live rows
    beside. Without ``hold`` the figures are only counted (the logits
    must still be finite)."""
    check(bool(torch.isfinite(kern).all()), f"{where}: non-finite logits")
    d = (kern - other).abs().max().item()
    scale = other.abs().max().item()
    top2 = other.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    agree = kern.argmax(-1) == other.argmax(-1)
    clear = live & (margin > tol * scale)
    res = dict(max_abs=d, max_logit=scale, tol=tol,
               top1_agree_live=int(agree[live].sum()),
               live_rows=int(live.sum()), clear_rows=int(clear.sum()),
               top2_margins_live=margin[live].tolist())
    log(f"{where}: " + json.dumps(res))
    if not hold:
        return res
    check(d <= tol * scale, f"{where}: logits differ by {d:.3e} > {tol} x "
          f"{scale:.3e}")
    check(bool(agree[clear].all()), f"{where}: top-1 differs on a live row "
          f"whose top-2 margin exceeds {tol} x max|logit|")
    return res


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
        res[step] = compare_logits(
            torch, f"attn_kernel on vs off, full-depth bf16 {step}",
            out[(step, True)], out[(step, False)], live[step],
            ATTN_STEP_TOL)
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
    backends = compare_logits(
        torch, "backends on one decode step, sgmv vs einsum", l_sgmv,
        decode_logits("einsum"),
        torch.ones(l_sgmv.shape[0], dtype=torch.bool, device=dev),
        BACKEND_TOL)

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
                  backends=backends, profile=prof)
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


def _check_sgmv_launches(where, launches, step_calls, spec=LLAMA_SPEC):
    """Every LoRA module of every layer of every step call launches each
    SGMV kernel once."""
    layers, n_mod = spec["layers"], len(spec["modules"])
    want = layers * n_mod * step_calls
    got = {k: launches[k] for k in ("sgmv_shrink", "sgmv_expand")}
    check(want > 0 and all(n == want for n in got.values()),
          f"{where}: SGMV launches {got}, want {want} ({layers} layers x "
          f"{n_mod} modules per step call over {step_calls} calls)")


def _check_attention_launches(where, launches, prefill_calls, decode_calls,
                              spec=LLAMA_SPEC):
    """Every layer of every prefill / decode step call launches its
    attention kernel once."""
    layers = spec["layers"]
    want = {"flash_prefill": layers * prefill_calls,
            "flash_decode": layers * decode_calls}
    got = {k: launches[k] for k in want}
    check(got == want and min(want.values()) > 0,
          f"{where}: attention launches {got}, want {want} ({layers} per "
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

    def chunked(bucket, merged, start, width, group, now):
        dt = run_chunk(bucket, merged, start, width, group, now)
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


# ---------------------------------------------------------------------------
# phase 10: the learned router on the card, router-head training, LoRA
# fine-tuning (Llama-3.1-8B full width, phase 4's weights)
# ---------------------------------------------------------------------------

# the router's and the trainer's synthetic data draw token ids from the
# first 4096 of the vocabulary: ``data._task_transition`` builds a vocab x
# vocab matrix, 100+ GB at 128256 (the reference's own limit); the model
# stays at full width
DATA_VOCAB = 4096
# router scores, flash_prefill vs plain attention over 32 bf16 layers:
# features pooled over the row and normalised, then an f32 head and a
# sigmoid; the routes differ by the softmax's bf16 rounding per layer
# (ATTN_STEP_TOL on logits), which the pooled, squashed scores shrink:
# held to 1e-2 of max|plain|
ROUTER_TOL = 1e-2


def _counted_router(router, calls):
    """Record each ``scores_batch`` call's host ms (it ends in a copy to
    the host, a sync) and the kernel launches it made."""
    fn = router.scores_batch

    def run(tokens):
        before = _counts()
        t = time.perf_counter()
        out = fn(tokens)
        calls.append(dict(ms=1e3 * (time.perf_counter() - t),
                          rows=int(tokens.shape[0]),
                          width=int(tokens.shape[1]),
                          launches={k: n - before[k]
                                    for k, n in _counts().items()}))
        return out
    router.scores_batch = run
    return router


def _check_router_calls(where, calls, layers):
    check(len(calls) > 0, f"{where}: the router was never called")
    for c in calls:
        want = dict.fromkeys(c["launches"], 0)
        want["flash_prefill"] = layers
        check(c["launches"] == want, f"{where}: a router call launched "
              f"{c['launches']}, want {layers} flash_prefill and nothing "
              "else")


def learned_router_phase(torch, dev, shared):
    """Phase 10: router head training and its accuracy, router scores with
    flash_prefill against plain attention, learned-router serves (Table
    6's first-token ratio, batched and solo scoring, dense and paged), and
    a LoRA fine-tune with a checkpoint round trip."""
    from repro_torch.core.router import LearnedRouter, trunk_features
    from repro_torch.launch.serve import summary_row
    from repro_torch.models import build_model
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate_trace
    from repro_torch.training.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    from repro_torch.training.data import (DataConfig, lm_batches,
                                           router_dataset)
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    from repro_torch.training.router_train import (router_accuracy,
                                                   train_router)
    from repro_torch.training.train import TrainState, train_loop

    cfg, layers = shared["cfg"], LLAMA_SPEC["layers"]
    n_adapters = cfg.lora.n_adapters
    out = {}
    # the kernel route and the plain one on the same (shared) weights
    model = build_model(cfg, dev, attn_kernel=True)
    params = model.load_params(shared["params"])
    plain_model = build_model(cfg, dev, attn_kernel=False)
    plain_model.load_params(shared["params"])

    # ---- 10.1 router head: Table 12's settings --------------------------
    t0 = time.perf_counter()
    prompts, labels, _ = router_dataset(
        DataConfig(vocab_size=DATA_VOCAB, seq_len=32, batch_size=4,
                   n_tasks=4), n_adapters=n_adapters, n_samples=240)
    data_s = time.perf_counter() - t0
    bces = []
    _reset_counts()
    t0 = time.perf_counter()
    head, _ = train_router(
        model, params, prompts[:192], labels[:192], epochs=6,
        batch_size=16, lr=3e-3,
        generator=torch.Generator(device=dev).manual_seed(0),
        log_fn=lambda s: bces.append(float(s.rsplit(" ", 1)[1])))
    acc = router_accuracy(model, params, head, prompts[192:], labels[192:])
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    train_launches = _counts()
    static = float(labels[192:].mean(0).max())
    chance = float(labels[192:].mean())
    check(len(bces) == 6 and bces[-1] < bces[0],
          f"router BCE did not fall over its epochs: {bces}")
    # 12 feature batches for training, 3 for the accuracy: one
    # flash_prefill launch per layer each
    check(train_launches["flash_prefill"] == 15 * layers,
          f"router training launched {train_launches}")
    out["router_train"] = dict(
        accuracy=acc, best_static=static, chance=chance, bce_by_epoch=bces,
        data_s=data_s, train_s=train_s, launches=train_launches)
    log(f"router head: top-1 accuracy {acc:.3f} on 48 held-out prompts "
        f"(best static adapter {static:.3f}, chance {chance:.3f}); BCE by "
        f"epoch {[round(b, 4) for b in bces]}; data {data_s:.1f}s, "
        f"features + 6 epochs + accuracy {train_s:.1f}s")

    # ---- 10.2 router scores: flash_prefill vs plain attention -----------
    tokens = torch.as_tensor(prompts[192:200], device=dev)
    router = LearnedRouter(model, params, head)
    plain = LearnedRouter(plain_model, plain_model.params, head)
    calls = []
    _counted_router(router, calls).scores_batch(tokens)
    _check_router_calls("scores_batch [8, 32]", calls, layers)
    want = plain.scores_batch(tokens)
    got = router.scores_batch(tokens)
    err = float(abs(got - want).max())
    check(err <= ROUTER_TOL * float(abs(want).max()),
          f"router scores: kernel vs plain max abs err {err}")
    # the pooled features under the scores: a saturated sigmoid would
    # hide a difference there
    with torch.inference_mode():
        feats = {m.attn_kernel: trunk_features(m, m.params, tokens)
                 for m in (model, plain_model)}
    feat_err = float((feats[True] - feats[False]).abs().max()
                     / feats[False].abs().max())
    check(feat_err <= ATTN_STEP_TOL, f"router features: kernel vs plain "
          f"{feat_err:.3e} of max|plain|")
    # a top-1 flip on a near tie inside the tolerance is no fault: counted
    same_top1 = int((got.argmax(-1) == want.argmax(-1)).sum())
    kern_ms = host_ms(torch, lambda: router.scores_batch(tokens), iters=10)
    plain_ms = host_ms(torch, lambda: plain.scores_batch(tokens), iters=10)
    out["scores"] = dict(max_abs_err=err, max_plain=float(abs(want).max()),
                         feature_err=feat_err, same_top1=same_top1,
                         ms=kern_ms, plain_ms=plain_ms,
                         launches=calls[0]["launches"])
    log(f"router scores [8, 32]: kernel vs plain max abs err {err:.2e} "
        f"(max|plain| {float(abs(want).max()):.3f}; pooled features "
        f"{feat_err:.2e} of max|plain|), top-1 equal on "
        f"{same_top1}/8 rows; {kern_ms:.1f} ms per "
        f"call with flash_prefill, {plain_ms:.1f} ms plain; launches per "
        f"call {calls[0]['launches']}")
    del plain, plain_model
    _release(torch)

    # ---- 10.3 learned-router serves ---------------------------------------
    def serve(policy, trace, timer=None, **kw):
        calls = []
        r = (_counted_router(LearnedRouter(model, params, head), calls)
             if policy == "edgelora" else None)
        ecfg = EngineConfig(n_slots=N_SLOTS, top_k=1, policy=policy,
                            max_ctx=MAX_CTX, prompt_buckets=(32, 64),
                            lora_backend="auto", kv_block_size=KV_BLOCK,
                            seed=0, **kw)
        engine = EdgeLoRAEngine(cfg, ecfg, router=r, params=params,
                                device=dev,
                                adapter_source=shared["adapter_source"],
                                timer=timer)
        _reset_counts()
        t0 = time.perf_counter()
        summary = engine.serve(trace)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = _counts()
        where = f"{policy} {kw}"
        check(summary.n_completed == summary.n_requests == len(trace),
              f"{where}: completed {summary.n_completed}/"
              f"{summary.n_requests}")
        if r is not None:
            _check_router_calls(where, calls, layers)
            check(0 < summary.router_steps <= len(trace),
                  f"{where}: {summary.router_steps} router steps for "
                  f"{len(trace)} requests")
        res = dict(
            requests=len(trace), serve_s=serve_s, launches=launches,
            router_steps=summary.router_steps,
            router_calls=len(calls),
            router_ms=[c["ms"] for c in calls],
            router_rows=[c["rows"] for c in calls],
            avg_first_token=summary.avg_first_token,
            row=summary_row(policy, n_adapters, summary),
            streams={q.request_id: list(q.tokens) for q in trace},
            selected={q.request_id: q.selected_adapter for q in trace})
        log(f"  {where}: {res['row']}")
        log(f"    {len(trace)} requests in {serve_s:.1f}s wall; "
            f"{summary.router_steps} router steps ({len(calls)} calls with "
            f"warm-ups), rows {res['router_rows']}; launches {launches}")
        del engine
        _release(torch)
        return res

    wl = dict(n_adapters=n_adapters, input_range=(8, 64),
              vocab_size=cfg.vocab_size)
    t0 = time.perf_counter()
    # Table 6 under the real timer, phase 4's trace, in turns (without,
    # with, with, without): the host's noise between serves is of the
    # router's size
    real = {}
    for i, p in enumerate(("edgelora_no_aas", "edgelora", "edgelora",
                           "edgelora_no_aas")):
        real[f"{p}_{i}"] = serve(p, generate_trace(WorkloadConfig(
            request_rate=4.0, duration=3.0, output_range=(8, 32), seed=0,
            **wl)))
    ttft = {p: _mean([r["avg_first_token"] for k, r in real.items()
                      if k.rsplit("_", 1)[0] == p])
            for p in ("edgelora", "edgelora_no_aas")}
    ratio = ttft["edgelora"] / ttft["edgelora_no_aas"]
    log(f"table6_learned/aas_overhead: first_token_ratio={ratio:.2f}x "
        f"(edgelora + LearnedRouter {1e3 * ttft['edgelora']:.1f} ms vs "
        f"edgelora_no_aas {1e3 * ttft['edgelora_no_aas']:.1f} ms mean "
        "first token, real timer, two serves each in turns: "
        + ", ".join(f"{k} {1e3 * r['avg_first_token']:.1f}"
                    for k, r in real.items()) + ")")
    # phase 5's burst arrivals, shorter outputs (the router acts before
    # the first token)
    burst = {}
    for name, kw in (("batched_dense", dict(router_batching=True)),
                     ("solo_dense", dict(router_batching=False)),
                     ("batched_paged", dict(router_batching=True,
                                            kv_backend="paged"))):
        burst[name] = serve("edgelora", generate_trace(WorkloadConfig(
            request_rate=200.0, duration=0.05, output_range=(4, 12),
            seed=1, **wl)), timer=FakeTime(), **kw)
    check(burst["batched_paged"]["streams"]
          == burst["batched_dense"]["streams"]
          and burst["batched_paged"]["selected"]
          == burst["batched_dense"]["selected"],
          "learned router: paged and dense serves differ under one timer")
    check(max(burst["batched_dense"]["router_rows"]) > 1,
          "router batching formed no group of more than one row")
    same = sum(burst["solo_dense"]["selected"][k] == v
               for k, v in burst["batched_dense"]["selected"].items())
    log(f"learned-router serves {time.perf_counter() - t0:.1f}s; batched "
        f"vs solo scoring select alike for {same}/"
        f"{len(burst['solo_dense']['selected'])} requests (not required: "
        "the scores are computed at other batch shapes)")
    out["serves"] = dict(real=real, burst=burst, first_token_ratio=ratio,
                         avg_first_token=ttft,
                         batched_solo_same_selection=same)

    # ---- 10.4 LoRA fine-tune ---------------------------------------------
    lora = model.init_lora(torch.Generator(device=dev).manual_seed(1))
    state = TrainState(params, lora, adamw_init(lora))
    base = [t.clone() for t in tree_leaves(params)]
    lora0 = [t.clone() for t in tree_leaves(lora)]
    stamps = []

    def log_step(s):
        stamps.append(time.perf_counter())

    _reset_counts()
    t0 = time.perf_counter()
    state, history = train_loop(
        model, lm_batches(DataConfig(vocab_size=DATA_VOCAB, seq_len=64,
                                     batch_size=4)),
        12, state=state, peak_lr=5e-3, warmup=2, log_every=1,
        log_fn=log_step)
    train_s = time.perf_counter() - t0
    launches = _counts()
    losses = [loss for _, loss in history]
    step_ms = [1e3 * (b - a) for a, b in zip(stamps, stamps[1:])]
    check(len(losses) == 12 and (losses[-1] + losses[-2]) / 2 < losses[0],
          f"LoRA fine-tune: loss did not fall: {losses}")
    check(all(torch.equal(a, b) for a, b in zip(base,
                                                tree_leaves(state.params))),
          "LoRA fine-tune changed the base params")
    check(not any(t.requires_grad for t in tree_leaves(state.params)),
          "base params require grad")
    check(all(not torch.equal(a, b) for a, b in zip(
        lora0, tree_leaves(state.lora))), "a LoRA leaf did not change")
    check(set(launches.values()) == {0},
          f"the train steps launched a kernel: {launches}")
    del base, lora0
    path = ROOT / "chiprun_out" / "phase10_adapter.npz"
    t1 = time.perf_counter()
    try:
        save_checkpoint(str(path), state.lora)
        back = load_checkpoint(str(path), state.lora)
        nbytes = path.stat().st_size
    finally:
        path.unlink(missing_ok=True)
    ckpt_s = time.perf_counter() - t1
    check(all(a.dtype == b.dtype and a.device == b.device
              and torch.equal(a, b)
              for a, b in zip(tree_leaves(back), tree_leaves(state.lora))),
          "adapter checkpoint round trip is not exact")
    out["finetune"] = dict(losses=losses, step_ms=step_ms, train_s=train_s,
                           launches=launches, checkpoint_bytes=nbytes,
                           checkpoint_s=ckpt_s)
    log(f"LoRA fine-tune: 12 steps in {train_s:.1f}s, loss "
        f"{[round(x, 3) for x in losses]}; ms per step (after the first) "
        f"mean {_mean(step_ms):.1f}; base params bit-equal, every LoRA "
        f"leaf changed, no kernel launched; checkpoint "
        f"{nbytes / 1e6:.0f} MB saved and loaded exactly in {ckpt_s:.1f}s")
    del state, back, router, model
    _release(torch)
    return out


# ---------------------------------------------------------------------------
# phases 7-9: qwen2-0.5b under every policy, tracing, an overcommitted
# arena; full-width steps of qwen2-0.5b, llama3.2-3b and openelm-1.1b
# ---------------------------------------------------------------------------

# engine step attribute -> (phase, merged): merged steps run no LoRA
STEP_KINDS = {
    "_prefill": ("prefill", False), "_prefill_merged": ("prefill", True),
    "_prefill_suffix": ("prefill", False),
    "_prefill_suffix_merged": ("prefill", True),
    "_prefill_sfx_dense": ("prefill", False),
    "_prefill_sfx_dense_merged": ("prefill", True),
    "_decode": ("decode", False), "_decode_merged": ("decode", True),
    "_decode_paged": ("decode", False),
    "_decode_merged_paged": ("decode", True)}
# QKV bias drawn N(0, BIAS_STD^2) (the reference initialises it to zero,
# which would leave it unexercised): about a tenth of a q, k or v entry
BIAS_STD = 0.1
# QK-norm and post-norm scales drawn N(0, NORM_STD^2) (the reference
# initialises them to zero: a (1 + scale) of exactly one)
NORM_STD = 0.1


def prepare_weights(torch, cfg, params, gen) -> None:
    """In place: stacked weights rescaled from the reference init
    (stddev 1/sqrt(n_groups)) to fan-in scale 1/sqrt(d_in) (an MoE
    block's f32 router [ng, d, E], its expert stacks [ng, E, d_in, d_out]
    and its shared expert included), QKV biases,
    QK-norm and post-norm scales drawn nonzero, and a tied embedding
    rescaled to unit stddev (the reference draws it at 1/sqrt(vocab),
    which through the tied head gives logits of ~0.1 and top-2 ties
    everywhere), or to 1/sqrt(d_model) where the model scales its
    embedding up by sqrt(d_model) (gemma2: its tied logits then stay
    inside the final softcap's range instead of saturating it).
    A Mamba-2 slot's ``in_proj``, ``out_proj`` and ``conv_w`` stacks are
    rescaled the same way (the conv's fan-in is its 4 taps); its gate
    norm is drawn as a norm scale; its f32 ``dt_bias``, ``A_log`` and
    ``D`` (2-D) and ``conv_b`` keep the reference's init. zamba2's
    ``shared_attn`` block is unstacked, so the reference's init
    (stddev 1/sqrt(shape[0]) = 1/sqrt(d_in)) is already at fan-in scale
    and it is left as drawn."""
    with torch.no_grad():
        for slot in params["layers"].values():
            for mod_name, module in slot.items():
                if mod_name in ("post1", "post2"):
                    module["scale"].normal_(0.0, NORM_STD, generator=gen)
                    continue
                for name, w in module.items():
                    if isinstance(w, dict) and "scale" in w:  # q/k_norm
                        w["scale"].normal_(0.0, NORM_STD, generator=gen)
                    elif isinstance(w, dict):   # MoE experts, shared expert
                        for x in w.values():
                            x.mul_((x.shape[0] / x.shape[-2]) ** 0.5)
                    elif w.dim() == 3:
                        w.mul_((w.shape[0] / w.shape[-2]) ** 0.5)
                    elif name in ("bq", "bk", "bv"):
                        w.normal_(0.0, BIAS_STD, generator=gen)
        if cfg.tie_embeddings:
            params["embed"].mul_(cfg.vocab_size ** 0.5 / (
                cfg.d_model ** 0.5 if cfg.scale_embeddings else 1.0))


def _draw_b(tree, gen) -> None:
    """In place: every LoRA pair's B ~ N(0, B_STD^2), the stack's slots
    and zamba2's shared block alike (left at zero, the shared block's
    LoRA would check nothing)."""
    if "B" in tree:
        tree["B"].normal_(0.0, B_STD, generator=gen)
        return
    for sub in tree.values():
        _draw_b(sub, gen)


def make_adapter_source(torch, dev, cfg):
    """Adapters as deterministic functions of their id: A ~ N(0, 1/r) as
    the reference draws it, B ~ N(0, B_STD^2) instead of zeros."""
    from repro_torch.models.transformer import init_lora_stack

    def source(aid: int):
        gen = torch.Generator(device=dev).manual_seed(10_000 + aid)
        tree = init_lora_stack(gen, cfg)
        _draw_b(tree, gen)
        return tree
    return source


def _count_steps(torch, engine):
    """Wrap every step function the engine has: each call appends (name,
    host ms to a device sync, launches by kernel during the call)."""
    calls = []
    for name in STEP_KINDS:
        fn = getattr(engine, name, None)
        if fn is None:
            continue

        def run(*args, _fn=fn, _name=name, **kw):
            before = _counts()
            t = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t)
            after = _counts()
            calls.append((_name, ms, {k: after[k] - before[k]
                                      for k in after}))
            return out
        setattr(engine, name, run)
    return calls


def _step_counts(spec):
    """(LoRA calls, attention calls) of one step of ``spec``'s model: by
    default one per LoRA module and layer and one per layer; an SSM or
    hybrid spec states its own (``lora_calls``, ``attn_calls``)."""
    layers = spec["layers"]
    return (spec.get("lora_calls", layers * len(spec["modules"])),
            spec.get("attn_calls", layers))


def _check_step_launches(where, calls, spec, paged):
    """Per step call: each SGMV kernel once per LoRA call (by default one
    per LoRA module and layer; ``_step_counts``) on an unmerged step and
    never on a merged one; the step's attention kernel once per attention
    call (by default one per layer); the page gather once per arena leaf
    (k, v and, in an int8 cache, their scales; ``spec['gathers']``,
    default 2) of each attention slot per paged decode step."""
    lora, attn = _step_counts(spec)
    for name, _, got in calls:
        phase, merged = STEP_KINDS[name]
        want = {"sgmv_shrink": 0 if merged else lora,
                "sgmv_expand": 0 if merged else lora,
                "flash_prefill": attn if phase == "prefill" else 0,
                "flash_decode": attn if phase == "decode" else 0,
                "paged_gather_pages": (spec.get("gathers", 2)
                                       if phase == "decode" and paged
                                       else 0)}
        check(got == want, f"{where}: {name} launched {got}, want {want}")


def qwen2_serve(torch, dev, where, engine, trace, spec):
    """Serve ``trace``; hold every step call's launches, the outputs and
    the launches outside step calls (none). Returns the record."""
    from repro_torch.launch.serve import summary_row

    calls = _count_steps(torch, engine)
    _reset_counts()
    t0 = time.perf_counter()
    summary = engine.serve(trace)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = _counts()
    vocab = engine.cfg.vocab_size
    check(summary.n_completed == summary.n_requests == len(trace) > 0,
          f"{where}: completed {summary.n_completed}/{summary.n_requests}")
    for r in trace:
        check(len(r.tokens) == r.generated == r.output_len
              and all(0 <= t < vocab for t in r.tokens),
              f"{where}: request {r.request_id}: bad output")
    _check_step_launches(where, calls, spec, engine.paged)
    check(all(launches[k] == sum(d[k] for _, _, d in calls)
              for k in launches), f"{where}: launches outside step calls")
    by = {}
    for name, ms, _ in calls:
        phase, merged = STEP_KINDS[name]
        by.setdefault(f"{phase}{'_merged' if merged else ''}", []).append(ms)
    row = summary_row(engine.ecfg.policy, engine.cfg.lora.n_adapters,
                      summary)
    log(f"{where}: {row}")
    log(f"  {len(trace)} requests in {serve_s:.1f}s wall; step calls "
        + ", ".join(f"{k} {len(v)} ({_mean(v):.1f} ms mean)"
                    for k, v in sorted(by.items()))
        + f"; launches {launches}")
    names = {}
    for name, _, _ in calls:
        names[name] = names.get(name, 0) + 1
    return dict(summary=summary, launches=launches, serve_s=serve_s,
                step_calls={k: len(v) for k, v in by.items()},
                step_names=names,
                step_ms_mean={k: _mean(v) for k, v in by.items()},
                unmerged_calls=sum(not STEP_KINDS[n][1] for n, _, _ in calls),
                merged_calls=sum(STEP_KINDS[n][1] for n, _, _ in calls),
                streams={r.request_id: list(r.tokens) for r in trace},
                row=row)


def _fields(summary, *drop):
    import dataclasses
    d = dataclasses.asdict(summary)
    for k in drop:
        d.pop(k)
    return json.dumps(d, sort_keys=True, default=str)


def _run_tool(args):
    """Run one of the repo's tools in a child process; returns its
    (exit code, stdout)."""
    out = subprocess.run([sys.executable, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode:
        log(out.stdout[-2000:], out.stderr[-2000:])
    return out.returncode, out.stdout + out.stderr


def qwen2_phase(torch, dev):
    """qwen2-0.5b at full width (bf16, 24 layers, d 896, 14/2 heads,
    d_ff 4864, vocab 151936, QKV bias; LoRA rank 16 on all seven
    modules), every serve under its own fake timer (``FakeTime``), so
    two engines that run the same steps see the same step durations:

    * ``edgelora``, ``llamacpp`` and ``dlora`` (a single-adapter trace,
      which must run merged only, and an adapter-diverse one, which must
      unmerge), each dense and paged: paged streams and summaries (but
      for ``kv_stats``) equal the dense ones;
    * ``edgelora`` dense with the tracer on: streams and summary (but
      for the tracing-only latency breakdown) equal the untraced serve's;
      the exported trace passes ``tools/trace_export.py`` (the schema
      check) and reads back through ``tools/trace_report_torch.py``;
    * ``edgelora`` paged on an overcommitted arena (24 pages, a seventh
      of dense capacity) with the prefix cache: deferrals or preemptions
      and copy-on-write pages, streams equal to a dense serve's.

    Every step call's launches are held (``_check_step_launches``)."""
    import dataclasses

    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.trace import EngineTracer
    from repro_torch.serving.workload import WorkloadConfig, generate_trace

    spec = QWEN_SPEC
    cfg = get_config("qwen2-0.5b")
    n_adapters = 2 * cfg.lora.max_resident          # misses force swap-ins
    cfg = dataclasses.replace(
        cfg, lora=dataclasses.replace(cfg.lora, n_adapters=n_adapters))
    check(cfg.n_layers == spec["layers"] and cfg.d_model == 896
          and cfg.dtype == "bfloat16" and cfg.attn.qkv_bias
          and cfg.tie_embeddings and cfg.lora.rank == spec["rank"]
          and set(cfg.lora.target_modules) == set(spec["modules"]),
          "not the full qwen2-0.5b config")
    # llamacpp preloads every adapter: the adapter count is chosen so that
    # they fit the engine's default memory_budget (64 x 17.6 MB = 1.1 GB
    # of 6 GB), so the OOM check passes as it would on the device
    budget = EngineConfig().memory_budget
    adapter_mb = cfg.lora_adapter_bytes() / 1e6
    check(n_adapters * cfg.lora_adapter_bytes() <= budget,
          f"{n_adapters} adapters of {adapter_mb:.1f} MB exceed {budget}")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = build_model(cfg, dev).init(gen)
    prepare_weights(torch, cfg, params, gen)
    source = make_adapter_source(torch, dev, cfg)
    log(f"qwen2-0.5b: {sum(p.numel() for p in _leaves(params)) / 1e9:.3f}"
        f"B params, adapters of {adapter_mb:.1f} MB, {n_adapters} adapters")

    def engine(policy, kv, tracer=None, **kw):
        ecfg = EngineConfig(n_slots=N_SLOTS, top_k=1, policy=policy,
                            max_ctx=MAX_CTX, prompt_buckets=(32, 64),
                            lora_backend="auto", kv_backend=kv,
                            kv_block_size=KV_BLOCK, seed=0, **kw)
        eng = EdgeLoRAEngine(cfg, ecfg, params=params, tracer=tracer,
                             device=dev, adapter_source=source,
                             timer=FakeTime())
        check(eng.lora_backend == "sgmv" and eng.attn_kernel
              and (eng.kv_gather_kernel or kv == "dense"),
              f"{policy}/{kv}: kernels not resolved on CUDA")
        return eng

    # bursts of ~10 requests within 50 ms of virtual time (10 fake steps)
    burst = WorkloadConfig(n_adapters=n_adapters, request_rate=200.0,
                           duration=0.05, input_range=(8, 64),
                           output_range=(4, 16), vocab_size=cfg.vocab_size,
                           seed=3)
    traces = {"mixed": burst,
              "single": dataclasses.replace(burst, n_adapters=1, seed=4),
              "diverse": dataclasses.replace(burst, alpha=0.0, seed=5)}
    out = {"adapter_mb": adapter_mb, "n_adapters": n_adapters}
    for policy, wl in (("edgelora", "mixed"), ("llamacpp", "mixed"),
                       ("dlora", "single"), ("dlora", "diverse")):
        runs = {}
        for kv in ("dense", "paged"):
            where = f"qwen2-0.5b {policy} {wl} {kv}"
            eng = engine(policy, kv)
            runs[kv] = qwen2_serve(torch, dev, where, eng,
                                   generate_trace(traces[wl]), spec)
            del eng
            _release(torch)
        same = sum(runs["dense"]["streams"][k] == v
                   for k, v in runs["paged"]["streams"].items())
        log(f"  {policy} {wl}: dense vs paged streams {same}/"
            f"{len(runs['dense']['streams'])} equal")
        check(runs["dense"]["streams"] == runs["paged"]["streams"],
              f"{policy} {wl}: dense and paged streams differ")
        check(_fields(runs["dense"]["summary"], "kv_stats")
              == _fields(runs["paged"]["summary"], "kv_stats"),
              f"{policy} {wl}: dense and paged summaries differ")
        for kv, r in runs.items():
            s = r["summary"]
            if policy == "llamacpp" or wl == "single":
                check(r["unmerged_calls"] == 0 and r["merged_calls"] > 0
                      and r["launches"]["sgmv_shrink"] == 0,
                      f"{policy} {wl} {kv}: unmerged steps ran")
            else:
                check(r["unmerged_calls"] > 0, f"{policy} {wl} {kv}: no "
                      "unmerged step")
            if wl == "single":
                check(s.adapter_loads <= cfg.lora.max_resident,
                      f"dlora single {kv}: {s.adapter_loads} loads")
            if wl == "diverse":
                check(s.adapter_loads > 0, f"dlora diverse {kv}: no load")
            r["summary"] = dataclasses.asdict(s)
        out[f"{policy}_{wl}"] = runs

    # ---- tracing: on vs off on the same serve -------------------------
    tracer = EngineTracer()
    eng = engine("edgelora", "dense", tracer=tracer)
    traced = qwen2_serve(torch, dev, "qwen2-0.5b edgelora traced", eng,
                         generate_trace(burst), spec)
    del eng
    _release(torch)
    untraced = out["edgelora_mixed"]["dense"]
    check(traced["streams"] == untraced["streams"],
          "tracer on vs off: streams differ")
    check(traced["summary"].latency_breakdown is not None
          and _fields(traced["summary"], "latency_breakdown")
          == json.dumps({k: v for k, v in untraced["summary"].items()
                         if k != "latency_breakdown"}, sort_keys=True,
                        default=str),
          "tracer on vs off: summaries differ")
    check(tracer.watchdog_report["ok"], f"watchdog: {tracer.watchdog_report}")
    path = ROOT / "chiprun_out" / "qwen2_trace.json"
    path.parent.mkdir(exist_ok=True)
    tracer.export(path)
    rc_export, text_export = _run_tool(["tools/trace_export.py", str(path)])
    rc_report, text_report = _run_tool(["tools/trace_report_torch.py",
                                        str(path)])
    check(rc_export == 0, "tools/trace_export.py rejected the trace")
    check(rc_report == 0 and "# trace: policy=edgelora" in text_report
          and "VIOLATION" not in text_report,
          "tools/trace_report_torch.py could not read the trace")
    log(text_export.strip())
    log("\n".join(text_report.strip().splitlines()[:12]))
    traced["summary"] = dataclasses.asdict(traced["summary"])
    traced["summary"].pop("latency_breakdown")
    out["traced"] = dict(traced, events=len(tracer.events),
                         trace_file=str(path.relative_to(ROOT)),
                         trace_report=text_report)

    # ---- overcommitted arena with the prefix cache --------------------
    # 4 tenants' 32-token system prompts; every third request that opens
    # with one sends only it (a block-aligned whole-prompt match: the
    # last prompt token is re-prefilled into a copy-on-write page)
    sys_len = 32
    tight = WorkloadConfig(n_adapters=4, request_rate=200.0, duration=0.08,
                           input_range=(8, 64), output_range=(8, 32),
                           system_prompt_len=sys_len,
                           vocab_size=cfg.vocab_size, seed=6)

    def tight_trace():
        trace = generate_trace(tight)
        opened = [r for r in trace if r.prompt_len > sys_len]
        for r in opened[1::3]:
            r.prompt_tokens = np.asarray(r.prompt_tokens)[:sys_len]
            r.prompt_len = sys_len
        return trace

    runs = {}
    for kv, kw in (("dense", {}),
                   ("paged", dict(kv_arena_blocks=24, prefix_cache=True))):
        eng = engine("edgelora", kv, **kw)
        runs[kv] = qwen2_serve(torch, dev, f"qwen2-0.5b overcommitted {kv}",
                               eng, tight_trace(), spec)
        del eng
        _release(torch)
    kv_stats = runs["paged"]["summary"].kv_stats
    ps = runs["paged"]["summary"].prefix_stats
    log(f"  overcommitted arena: kv {kv_stats}; prefix {ps}")
    check(kv_stats["deferrals"] + kv_stats["preemptions"] > 0,
          f"overcommitted arena neither deferred nor preempted: {kv_stats}")
    check(ps["cow_copies"] > 0 and ps["hit_requests"] > 0,
          f"no copy-on-write or prefix hit: {ps}")
    check(runs["dense"]["streams"] == runs["paged"]["streams"],
          "overcommitted paged vs dense streams differ")
    for r in runs.values():
        r["summary"] = dataclasses.asdict(r["summary"])
    out["overcommitted"] = runs

    # ---- llamacpp and dlora with the prefix cache and chunks ----------
    # 4 tenants' 32-token system prompts, 32-token chunks: a dense serve
    # (chunked: ``_prefill_sfx_dense*``) against a paged one with the
    # prefix cache (``_prefill_suffix*``); llamacpp runs merged only, dlora
    # on adapter-diverse traffic (alpha 0) unmerges
    chunk = 32
    sys_wl = dataclasses.replace(tight, duration=0.05, output_range=(4, 16),
                                 seed=7)
    for policy, alpha in (("llamacpp", 1.0), ("dlora", 0.0)):
        wl = dataclasses.replace(sys_wl, alpha=alpha)
        runs = {}
        for kv, kw in (("dense", {}), ("paged", dict(prefix_cache=True))):
            eng = engine(policy, kv, prefill_chunk=chunk, **kw)
            runs[kv] = qwen2_serve(
                torch, dev, f"qwen2-0.5b {policy} prefix/chunk {kv}", eng,
                generate_trace(wl), spec)
            del eng
            _release(torch)
        dense, paged = runs["dense"], runs["paged"]
        ps = paged["summary"].prefix_stats
        log(f"  {policy} prefix/chunk: step calls dense "
            f"{dense['step_names']}, paged {paged['step_names']}; prefix "
            f"{ps}")
        check(dense["streams"] == paged["streams"],
              f"{policy} prefix/chunk: paged vs dense streams differ")
        check(ps["hit_requests"] > 0, f"{policy}: no prefix hit: {ps}")
        sfx = {"dense": ("_prefill_sfx_dense", "_prefill_sfx_dense_merged"),
               "paged": ("_prefill_suffix", "_prefill_suffix_merged")}
        for kv, r in runs.items():
            unmerged, merged = (r["step_names"].get(n, 0) for n in sfx[kv])
            if policy == "llamacpp":
                check(merged > 0 and unmerged == 0
                      and r["launches"]["sgmv_shrink"] == 0,
                      f"llamacpp {kv}: merged suffix steps {merged}, "
                      f"unmerged {unmerged}")
            else:
                check(unmerged + merged > 0 and r["unmerged_calls"] > 0,
                      f"dlora {kv}: no suffix step or no unmerged step")
            r["summary"] = dataclasses.asdict(r["summary"])
        out[f"{policy}_prefix_chunk"] = runs
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# routes of the full-width step check: (attention kernels, LoRA backend)
ROUTES = {"kernels": (True, "sgmv"), "plain_attention": (False, "sgmv"),
          "einsum_lora": (True, "einsum"), "plain": (False, "einsum")}
# bf16 logits of the kernel route against each other route, as a share of
# max|logit|: attention kernels vs plain attention and sgmv vs einsum each
# within ATTN_STEP_TOL / BACKEND_TOL (both 5e-2, see above); against the
# fully plain route, which differs in both, their sum
ROUTE_TOL = {"plain_attention": ATTN_STEP_TOL, "einsum_lora": BACKEND_TOL,
             "plain": ATTN_STEP_TOL + BACKEND_TOL}


def route_check_phase(torch, dev, arch):
    """One full-width bf16 prefill (8 rows x 64, right-padded lengths,
    8 rows with different adapters from an 8-slot pool, B nonzero) and one
    decode step (from the kernel route's cache, one idle row) of
    ``arch`` on each route of ``ROUTES`` (``route_check``)."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    params = _variant_params(torch, dev, cfg, 11)
    res = route_check(torch, dev, cfg, params, variant_spec(cfg), ROUTES,
                      lengths=(64, 60, 50, 40, 33, 20, 9, 64), s=64,
                      decode_steps=1, idle_row=True,
                      where=f"{arch} full-width bf16")
    del params
    return res


# ---------------------------------------------------------------------------
# phase 17: the kernels' whole domain: LoRA rank 128 at full width and
# depth, a rank off the 16-rank tiles, blk_t 256, head dims 96, 192, 320
# ---------------------------------------------------------------------------

DOMAIN_RANK = 128
# the rank-128 pool: 8 adapters of ~0.9 GB (226 M f32 values) each
DOMAIN_SLOTS = 8
DOMAIN_ADAPTERS = 16      # twice the pool: the serve swaps adapters in
DOMAIN_HEAD_DIMS = (96, 192)
DOMAIN_HD_LAYERS = 4      # the head-dim variants' depth (of 32)
DOMAIN_LENGTHS = (64, 60, 50, 40, 33, 20, 9, 64)


def domain_trace(cfg, seed):
    """8 requests of a burst over ``DOMAIN_ADAPTERS`` adapters: prompts of
    8-64 tokens, outputs of 8-16."""
    from repro_torch.serving.workload import WorkloadConfig, generate_trace
    trace = generate_trace(WorkloadConfig(
        n_adapters=DOMAIN_ADAPTERS, request_rate=200.0, duration=0.1,
        input_range=(8, 64), output_range=(8, 16),
        vocab_size=cfg.vocab_size, seed=seed))[:8]
    check(len(trace) == 8, f"domain trace of {len(trace)} requests")
    return trace


def domain_phase(torch, dev, shared):
    """Phase 17 (see the module docstring). Returns its record by model:
    kernel rows at the new ranks, token block and head dims, route checks
    and serves."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {}
    base = dict(LLAMA_SPEC, r_pool=DOMAIN_SLOTS, dtypes=("bfloat16",))
    kernel_rows = []
    for extra in (
            # rank 128 at the decode step (d 4096) and the full prefill
            # group (512 rows; d 14336 in and out)
            dict(model="llama3.1-8b-r128", rank=DOMAIN_RANK,
                 shrink_d=(4096, 14336), expand_d=(4096, 14336),
                 modules={"up": (4096, 14336)},
                 cases=[("decode", N_SLOTS), ("prefill", 512)]),
            # a rank that is not a multiple of 16 (two chunks, the second
            # ragged), at the decode step
            dict(model="llama3.1-8b-r100", rank=100, shrink_d=(4096,),
                 expand_d=(4096,), modules={"q": (4096, 4096)},
                 cases=[("decode", N_SLOTS)]),
            # blocks of 256 rows (two 128-row slices each), a full group
            dict(model="llama3.1-8b-blk256", rank=RANK, blk_t=256,
                 shrink_d=(4096,), expand_d=(4096,),
                 modules={"q": (4096, 4096)}, cases=[("prefill", 512)])):
        kernel_rows += [r for r in kernel_phase(torch, dev, dict(base,
                                                                 **extra))
                        if r["kernel"] != "event_floor"]
    for r in kernel_rows:
        log("  " + json.dumps(r))
    attention_rows = []
    for hd in (*DOMAIN_HEAD_DIMS, 320):
        attention_rows += attention_phase(torch, dev, dict(
            LLAMA_SPEC, model=f"llama3.1-8b-hd{hd}",
            heads=(N_HEADS, N_KV_HEADS, hd)), full=False)
    log(f"  domain kernel rows {time.perf_counter() - t0:.1f}s")

    # Llama-3.1-8B at full width and depth on phase 4's weights, rank-128
    # adapters: a route check and a serve
    cfg = shared["cfg"]
    cfg = dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, rank=DOMAIN_RANK, max_resident=DOMAIN_SLOTS,
        n_adapters=DOMAIN_ADAPTERS))
    check(cfg.n_layers == 32 and cfg.d_model == 4096, "not llama3-8b")
    spec = variant_spec(cfg)
    check(spec["rank"] == DOMAIN_RANK and len(spec["modules"]) == 5,
          f"rank-128 spec {spec['rank']}, {spec['modules']}")
    values = DOMAIN_RANK * cfg.n_layers * sum(
        a + b for a, b in spec["modules"].values())
    log(f"llama3.1-8b rank {DOMAIN_RANK}: adapters of {values / 1e6:.1f} M "
        f"values ({4 * values / 1e9:.2f} GB in the f32 pool), a pool of "
        f"{DOMAIN_SLOTS}")
    rec = dict(kernel_rows=kernel_rows, attention_rows=attention_rows)
    rec["route_check"] = route_check(
        torch, dev, cfg, shared["params"], spec, ROUTES,
        lengths=DOMAIN_LENGTHS, s=64, decode_steps=2, idle_row=True,
        where="llama3.1-8b rank 128 bf16")
    eng = _variant_engine(torch, dev, cfg, shared["params"],
                          make_adapter_source(torch, dev, cfg), "edgelora",
                          "dense")
    rec["serve_dense"] = _summaries({"run": qwen2_serve(
        torch, dev, "llama3.1-8b rank 128 edgelora dense", eng,
        domain_trace(cfg, 26), spec)})["run"]
    check(rec["serve_dense"]["unmerged_calls"] > 0,
          "rank 128: no unmerged step")
    del eng
    _release(torch)
    out["llama3.1-8b-r128"] = rec

    # head dims 96 and 192 at Llama-3.1-8B's widths, reduced depth
    for hd in DOMAIN_HEAD_DIMS:
        cfg = get_config("llama3-8b")
        cfg = dataclasses.replace(
            cfg, head_dim=hd, n_layers=DOMAIN_HD_LAYERS,
            lora=dataclasses.replace(cfg.lora, n_adapters=DOMAIN_ADAPTERS))
        check(cfg.resolved_head_dim == hd, f"head dim {hd}")
        spec = variant_spec(cfg)
        params = _variant_params(torch, dev, cfg, 30 + hd)
        rec = dict(route_check=route_check(
            torch, dev, cfg, params, spec, ROUTES, lengths=DOMAIN_LENGTHS,
            s=64, decode_steps=2, idle_row=True,
            where=f"llama3.1-8b hd {hd} bf16"))
        eng = _variant_engine(torch, dev, cfg, params,
                              make_adapter_source(torch, dev, cfg),
                              "edgelora", "paged")
        rec["serve_paged"] = _summaries({"run": qwen2_serve(
            torch, dev, f"llama3.1-8b hd {hd} edgelora paged", eng,
            domain_trace(cfg, hd), spec)})["run"]
        del eng, params
        _release(torch)
        out[f"llama3.1-8b-hd{hd}"] = rec
    out["seconds"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# phase 11: the dense attention variants at full width: gemma2-9b,
# starcoder2-7b and chameleon-34b (8 of its 48 layers); the int8 KV cache
# ---------------------------------------------------------------------------

LONG_CTX = 4608          # the long serves' max_ctx: 4400 + 48 tokens fit
LONG_S = 4352            # route check prompts, past the 4096 window
LONG_LENGTHS = (4352, 4200)
LONG_DECODE_STEPS = 4
# gemma2-9b at 12 of its 42 layers (6 local/global pairs): its four
# host-bound long serves took ~80 s of the run at full depth and ~50 s at
# 22 layers, and phases 13 and 16 needed the time
GEMMA2_LAYERS = 12
# chameleon-34b's 68 GB of bf16 weights leave no room for its pool, caches
# and the plain route beside them on one 80 GB card: its full width at
# this depth
CHAMELEON_LAYERS = 8


def variant_spec(cfg, **kw):
    """The kernel and launch spec of ``cfg`` (as ``LLAMA_SPEC``): its
    LoRA modules' widths (no ``gate`` on a plain MLP), heads and layers,
    and the page-gather launches of a paged decode step (one per arena
    leaf of each attention slot: k and v, and their scales in an int8
    cache)."""
    from repro_torch.models.transformer import _LORA_DIMS, n_groups

    modules = {m: _LORA_DIMS[m](cfg) for m in cfg.lora.target_modules
               if cfg.glu or m != "gate"}
    leaves = 4 if cfg.attn.kv_cache_quant else 2
    spec = dict(model=cfg.name, r_pool=cfg.lora.max_resident,
                rank=cfg.lora.rank,
                shrink_d=tuple(sorted({a for a, _ in modules.values()})),
                expand_d=tuple(sorted({b for _, b in modules.values()})),
                modules=modules, cases=[("decode", N_SLOTS)],
                heads=(cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim),
                layers=cfg.n_layers, dtypes=("bfloat16",),
                groups=cfg.n_layers // len(cfg.attn.layer_pattern),
                gathers=leaves * len(cfg.attn.layer_pattern))
    if cfg.ssm is not None:
        # Mamba-2 slots: in_proj and out_proj a layer; zamba2's shared
        # block after each group: its q, k, v, o LoRA, one attention call
        # and one shared ring (k, v pages) stacked over the groups
        ssm_mods = [m for m in modules if m in ("in_proj", "out_proj")]
        ng = n_groups(cfg) if cfg.shared_attn_every else 0
        spec.update(lora_calls=cfg.n_layers * len(ssm_mods)
                    + ng * (len(modules) - len(ssm_mods)),
                    attn_calls=ng, groups=ng, gathers=leaves if ng else 0)
    spec.update(kw)
    return spec


def _variant_params(torch, dev, cfg, seed):
    from repro_torch.models import build_model
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = build_model(cfg, dev).init(gen)
    prepare_weights(torch, cfg, params, gen)
    n = sum(p.numel() for p in _leaves(params))
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, hd {cfg.resolved_head_dim}"
        f", d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: {n / 1e9:.2f}B "
        f"params; adapters of {cfg.lora_adapter_bytes() / 1e6:.1f} MB")
    return params


# leaves the reference keeps in f32 whatever the model dtype
F32_LEAVES = ("dt_bias", "A_log", "D", "router")


def _cast_tree(torch, tree, dtype, name=""):
    if isinstance(tree, dict):
        return {k: _cast_tree(torch, v, dtype, k) for k, v in tree.items()}
    return tree if name in F32_LEAVES else tree.to(dtype)


def _clone_cache(cache):
    """A copy of every ring a step writes; an encoder-decoder's cross K/V
    (tensor leaves, which no step writes) shared."""
    return {k: ({n: v.clone() for n, v in c.items()} if isinstance(c, dict)
                else c) for k, c in cache.items()}


def route_check(torch, dev, cfg, params, spec, routes, *, lengths, s,
                decode_steps, where, idle_row=False, on_route=None,
                tol=None):
    """One bf16 prefill of ``len(lengths)`` right-padded rows of ``s``
    tokens (per-row adapters from an 8-slot pool, B nonzero) and
    ``decode_steps`` decode steps on each route of ``routes`` (name ->
    (attention kernels, LoRA backend)); every route's step starts from the
    kernel route's cache and tokens (``idle_row``: the last row decodes
    idle, token 0 at position 0, as the engine runs an empty slot).
    Logits of the kernel route within ``ROUTE_TOL`` of max|logit| of each
    other route's, top-1 equal on every live row where the margin clears
    it (the agreement over all live rows reported beside); each route
    launches each attention kernel once per layer if it runs them, each
    SGMV kernel once per LoRA module and layer per step if it runs them,
    and nothing else. ``on_route(name)`` is called before each route's
    step. ``tol``: a tolerance for every route in place of ``ROUTE_TOL``
    (held), or "count" to record the logits' figures without holding
    them (launches are held either way)."""
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(11)
    models = {}
    for on in {on for on, _ in routes.values()}:
        models[on] = build_model(cfg, dev, attn_kernel=on)
        models[on].load_params(params)
    pool = models[True].init_lora(gen, n_slots=N_SLOTS)
    _draw_b(pool, gen)
    b = len(lengths)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    sids = torch.arange(b, dtype=torch.int32, device=dev) % N_SLOTS
    n_lora, layers = _step_counts(spec)
    out, launches, cache0 = {}, {}, None

    def run(route, fn):
        on, backend = routes[route]
        mode = LoRAMode("batched", sids, cfg.lora.scale, backend)
        if on_route is not None:
            on_route(route)
        before = _counts()
        with torch.no_grad():
            res = fn(models[on], mode)
        torch.cuda.synchronize()
        launches.setdefault(route, []).append(
            {k: n - before[k] for k, n in _counts().items()})
        return res

    t0 = time.perf_counter()
    for route in routes:
        logits, cache = run(route, lambda m, mode: m.prefill(
            params, {"tokens": tokens}, m.init_cache(b, s + decode_steps),
            pool, mode, lengths=lens))
        out[("prefill", route)] = logits.float()
        if route == "kernels":
            cache0 = cache
        del cache
    nxt, pos = out[("prefill", "kernels")].argmax(-1).int(), lens.clone()
    for i in range(decode_steps):
        if idle_row:
            nxt[-1], pos[-1] = 0, 0
        nxt_cache = None
        for route in routes:
            logits, cache = run(route, lambda m, mode: m.decode_step(
                params, nxt, _clone_cache(cache0), pos, pool, mode))
            out[(f"decode{i}", route)] = logits.float()
            if route == "kernels":
                nxt_cache = cache
            del cache
        cache0 = nxt_cache
        nxt, pos = out[(f"decode{i}", "kernels")].argmax(-1).int(), pos + 1
    seconds = time.perf_counter() - t0
    # the kernel route's launches per step call, none elsewhere
    for route, calls in launches.items():
        for i, got in enumerate(calls):
            phase = "prefill" if i == 0 else "decode"
            want = dict.fromkeys(got, 0)
            if routes[route][0]:            # the attention kernels
                want["flash_prefill" if i == 0 else "flash_decode"] = layers
            if routes[route][1] == "sgmv":
                want["sgmv_shrink"] = want["sgmv_expand"] = n_lora
            check(got == want, f"{where}: {route} {phase} launched {got}, "
                  f"want {want}")
    res = dict(seconds=seconds, launches=launches["kernels"])
    for step in ["prefill"] + [f"decode{i}" for i in range(decode_steps)]:
        live = torch.ones(b, dtype=torch.bool, device=dev)
        if idle_row and step != "prefill":
            live[-1] = False
        for route in routes:
            if route == "kernels":
                continue
            res[f"{step}_vs_{route}"] = compare_logits(
                torch, f"{where} {step}, kernels vs {route}",
                out[(step, "kernels")], out[(step, route)], live,
                ROUTE_TOL[route] if tol in (None, "count") else tol,
                hold=tol != "count")
    del models, pool, cache0, out
    _release(torch)
    return res


def long_trace(cfg, n_adapters, seed, n=8, long_rows=(0, 3, 5),
               lengths=(4100, 4400)):
    """``n`` requests of a burst (prompts 40-200 tokens, outputs 16-32:
    gemma2's unmerged decode step is host-bound at ~0.3 s, and 48-token
    outputs made each of its four serves ~30 s), three of them
    (``long_rows``) extended to ``lengths`` tokens (default 4100-4400,
    past the 4096 window)."""
    import numpy as np

    from repro_torch.serving.workload import WorkloadConfig, generate_trace

    trace = generate_trace(WorkloadConfig(
        n_adapters=n_adapters, request_rate=200.0, duration=0.1,
        input_range=(40, 200), output_range=(16, 32),
        vocab_size=cfg.vocab_size, seed=seed))[:n]
    check(len(trace) == n, f"long trace of {len(trace)} requests")
    rng = np.random.default_rng(seed)
    for i in long_rows:
        r = trace[i]
        old = np.asarray(r.prompt_tokens)
        length = int(rng.integers(lengths[0], lengths[1] + 1))
        r.prompt_tokens = np.concatenate([old, rng.integers(
            0, cfg.vocab_size, length - len(old))]).astype(old.dtype)
        r.prompt_len = length
    return trace


# the variant serves' adapter loads at 10 GB/s: at the default 1 GB/s a
# gemma2 swap-in (108 MB) spans ~20 fake steps, and the requests waiting
# on it more than double each serve's decode steps
VARIANT_DISK_BANDWIDTH = 10e9


def _variant_engine(torch, dev, cfg, params, source, policy, kv, **kw):
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    ecfg = EngineConfig(n_slots=N_SLOTS, top_k=1, policy=policy,
                        lora_backend="auto", kv_backend=kv,
                        kv_block_size=KV_BLOCK, seed=0,
                        disk_bandwidth=VARIANT_DISK_BANDWIDTH, **kw)
    eng = EdgeLoRAEngine(cfg, ecfg, params=params, device=dev,
                         adapter_source=source, timer=FakeTime())
    check(eng.lora_backend == "sgmv" and eng.attn_kernel
          and (eng.kv_gather_kernel or kv == "dense"),
          f"{cfg.name} {policy}/{kv}: kernels not resolved on CUDA")
    return eng


def dense_paged_pair(torch, dev, cfg, params, source, spec, make_trace,
                     where, policy="edgelora", paged_kw=None,
                     same_summary=True, same_streams=True, **kw):
    """The same trace served dense and paged (``paged_kw`` added to the
    paged engine), each under its own fake timer: every step call's
    launches held; equal streams (unless not ``same_streams``: then
    counted) and, with ``same_summary``, summaries (but for the KV
    backend's own ``kv_stats`` and ``prefix_stats``; a paged serve with
    the prefix cache or chunks runs other step calls, so its clock
    differs)."""
    runs = {}
    for kv in ("dense", "paged"):
        extra = dict(kw, **(paged_kw or {})) if kv == "paged" else kw
        eng = _variant_engine(torch, dev, cfg, params, source, policy, kv,
                              **extra)
        runs[kv] = qwen2_serve(torch, dev, f"{where} {kv}", eng,
                               make_trace(), spec)
        del eng
        _release(torch)
    same = sum(runs["dense"]["streams"][k] == v
               for k, v in runs["paged"]["streams"].items())
    log(f"  {where}: dense vs paged streams {same}/"
        f"{len(runs['dense']['streams'])} equal")
    runs["paged"]["streams_equal_to_dense"] = same
    check(not same_streams
          or runs["dense"]["streams"] == runs["paged"]["streams"],
          f"{where}: dense and paged streams differ")
    check(not same_summary
          or _fields(runs["dense"]["summary"], "kv_stats", "prefix_stats")
          == _fields(runs["paged"]["summary"], "kv_stats", "prefix_stats"),
          f"{where}: dense and paged summaries differ")
    return runs


def _summaries(runs):
    import dataclasses
    for r in runs.values():
        r["summary"] = dataclasses.asdict(r["summary"])
    return runs


def variants_phase(torch, dev):
    """Phase 11 (see the module docstring). Returns its record: route
    checks, serves (their launches included) and kernel rows at the new
    shapes."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig

    out = {}
    # ---- gemma2-9b ------------------------------------------------------
    t0 = time.perf_counter()
    cfg = get_config("gemma2-9b")
    cfg = dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, n_adapters=2 * cfg.lora.max_resident))
    check(cfg.n_layers == 42 and cfg.d_model == 3584 and cfg.n_heads == 16
          and cfg.n_kv_heads == 8 and cfg.resolved_head_dim == 256
          and cfg.d_ff == 14336 and cfg.vocab_size == 256000
          and cfg.tie_embeddings and cfg.attn.sliding_window == 4096
          and cfg.attn.layer_pattern == ("local", "global")
          and cfg.attn.attn_logit_softcap == 50.0
          and cfg.final_logit_softcap == 30.0 and cfg.post_norm
          and cfg.scale_embeddings and cfg.lora.rank == 16
          and len(cfg.lora.target_modules) == 7,
          "not the full gemma2-9b config")
    cfg = dataclasses.replace(cfg, n_layers=GEMMA2_LAYERS)
    log(f"gemma2-9b: full width, {GEMMA2_LAYERS} of its 42 layers")
    spec = variant_spec(cfg)
    qcfg = dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, kv_cache_quant=True))
    qspec = variant_spec(qcfg)
    rec = dict(kernel_rows=kernel_phase(torch, dev, spec),
               # the gather needs no weights: all 42 layers' groups
               gather_rows=gather_phase(torch, dev, dict(
                   spec, max_ctx=LONG_CTX,
                   groups=42 // len(cfg.attn.layer_pattern), gather_cases=(
                       ("k bf16", "bfloat16", 8 * 256),
                       ("k int8", "int8", 8 * 256),
                       ("k_scale bf16", "bfloat16", 8)))),
               attention_rows=variant_attention_rows(torch, dev, cfg))
    params = _variant_params(torch, dev, cfg, 21)
    source = make_adapter_source(torch, dev, cfg)
    routes = {"kernels": ROUTES["kernels"], "plain": ROUTES["plain"]}
    rec["route_check"] = route_check(
        torch, dev, cfg, params, spec, routes, lengths=LONG_LENGTHS,
        s=LONG_S, decode_steps=LONG_DECODE_STEPS, where="gemma2-9b bf16")
    # int8: one decode step on the kernel route against the plain
    # (dequantized) attention
    qroutes = {"kernels": ROUTES["kernels"],
               "plain_attention": ROUTES["plain_attention"]}
    rec["route_check_int8"] = route_check(
        torch, dev, qcfg, params, qspec, qroutes, lengths=LONG_LENGTHS,
        s=LONG_S, decode_steps=1, where="gemma2-9b int8")
    long_kw = dict(max_ctx=LONG_CTX, prompt_buckets=(64, 256))
    for name, c, sp in (("bf16", cfg, spec), ("int8", qcfg, qspec)):
        runs = dense_paged_pair(
            torch, dev, c, params, source, sp,
            lambda c=c: long_trace(c, c.lora.n_adapters, 12),
            f"gemma2-9b edgelora {name}", **long_kw)
        for r in runs.values():
            check(r["step_calls"].get("decode", 0) > 0
                  and max(len(v) for v in r["streams"].values()) >= 16,
                  f"gemma2-9b {name}: no long decode")
        rec[f"serve_{name}"] = _summaries(runs)
    refusals = {}
    for feature, kw in (("prefix_cache", dict(kv_backend="paged",
                                              prefix_cache=True)),
                        ("prefill_chunk", dict(prefill_chunk=32))):
        try:
            EdgeLoRAEngine(cfg, EngineConfig(n_slots=N_SLOTS, **long_kw,
                                             **kw),
                           params=params, device=dev,
                           adapter_source=source)
        except ValueError as e:
            refusals[feature] = str(e)
        _release(torch)
        check(feature in refusals
              and "window-local ring" in refusals[feature],
              f"gemma2-9b: {feature} was not refused: {refusals}")
    log(f"  gemma2-9b refusals: {refusals}")
    rec["refusals"] = refusals
    del params, source
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    log(f"gemma2-9b {rec['seconds']:.1f}s")
    out["gemma2-9b"] = rec

    # ---- starcoder2-7b --------------------------------------------------
    t0 = time.perf_counter()
    cfg = get_config("starcoder2-7b")
    cfg = dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, n_adapters=2 * cfg.lora.max_resident))
    check(cfg.n_layers == 32 and cfg.d_model == 4608 and cfg.n_heads == 36
          and cfg.n_kv_heads == 4 and cfg.resolved_head_dim == 128
          and cfg.d_ff == 18432 and cfg.vocab_size == 49152
          and not cfg.glu and cfg.act == "gelu" and cfg.attn.qkv_bias
          and not cfg.tie_embeddings
          and cfg.attn.layer_pattern == ("local",)
          and cfg.attn.sliding_window == 4096,
          "not the full starcoder2-7b config")
    spec = variant_spec(cfg)
    check("gate" not in spec["modules"], "starcoder2-7b: a gate module")
    rec = dict(kernel_rows=kernel_phase(torch, dev, spec),
               attention_rows=variant_attention_rows(torch, dev, cfg))
    params = _variant_params(torch, dev, cfg, 22)
    source = make_adapter_source(torch, dev, cfg)
    rec["route_check"] = route_check(
        torch, dev, cfg, params, spec, routes, lengths=LONG_LENGTHS,
        s=LONG_S, decode_steps=LONG_DECODE_STEPS, where="starcoder2-7b")
    short_kw = dict(max_ctx=MAX_CTX, prompt_buckets=(32, 64))
    burst = dict(n_adapters=cfg.lora.n_adapters, request_rate=200.0,
                 duration=0.05, input_range=(8, 64), output_range=(4, 16),
                 vocab_size=cfg.vocab_size, seed=13)

    def short_trace():
        from repro_torch.serving.workload import (WorkloadConfig,
                                                  generate_trace)
        return generate_trace(WorkloadConfig(**burst))

    rec["serve_edgelora"] = _summaries(dense_paged_pair(
        torch, dev, cfg, params, source, spec, short_trace,
        "starcoder2-7b edgelora", **short_kw))
    eng = _variant_engine(torch, dev, cfg, params, source, "llamacpp",
                          "dense", **short_kw)
    check(set(eng.lora_pool["layers"]["slot0"]) == set(spec["modules"]),
          "starcoder2-7b: the LoRA pool's modules are not q,k,v,o,up,down")
    run = qwen2_serve(torch, dev, "starcoder2-7b llamacpp dense", eng,
                      short_trace(), spec)
    check(run["unmerged_calls"] == 0 and run["merged_calls"] > 0
          and run["launches"]["sgmv_shrink"] == 0,
          "starcoder2-7b llamacpp: unmerged steps ran")
    run["summary"] = dataclasses.asdict(run["summary"])
    rec["serve_llamacpp"] = run
    del eng, params, source
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    log(f"starcoder2-7b {rec['seconds']:.1f}s")
    out["starcoder2-7b"] = rec

    # ---- chameleon-34b, 8 of 48 layers ----------------------------------
    t0 = time.perf_counter()
    full = get_config("chameleon-34b")
    check(full.n_layers == 48 and full.d_model == 8192
          and full.n_heads == 64 and full.n_kv_heads == 8
          and full.d_ff == 22016 and full.vocab_size == 65536
          and full.attn.qk_norm and full.family == "vlm",
          "not the full chameleon-34b config")
    cfg = dataclasses.replace(full, n_layers=CHAMELEON_LAYERS,
                              lora=dataclasses.replace(
                                  full.lora,
                                  n_adapters=2 * full.lora.max_resident))
    log(f"chameleon-34b: full width, {CHAMELEON_LAYERS} of its "
        f"{full.n_layers} layers ({full.param_count() / 1e9:.1f}B params "
        f"at full depth, {2 * full.param_count() / 1e9:.0f} GB of bf16 "
        "weights: more than the card holds beside a pool, caches and the "
        "plain route)")
    spec = variant_spec(cfg)
    rec = dict(layers=CHAMELEON_LAYERS, full_layers=full.n_layers,
               kernel_rows=kernel_phase(torch, dev, spec),
               attention_rows=variant_attention_rows(torch, dev, cfg))
    params = _variant_params(torch, dev, cfg, 23)
    check(all(float(slot["attn"][n]["scale"].abs().max()) > 0
              for slot in params["layers"].values()
              for n in ("q_norm", "k_norm")), "QK-norm scales are zero")
    source = make_adapter_source(torch, dev, cfg)
    rec["route_check"] = route_check(
        torch, dev, cfg, params, spec, ROUTES,
        lengths=(64, 60, 50, 40, 33, 20, 9, 64), s=64, decode_steps=1,
        idle_row=True, where="chameleon-34b")
    sys_len, chunk = 32, 32
    prefix_wl = dict(n_adapters=4, request_rate=200.0, duration=0.08,
                     input_range=(8, 64), output_range=(4, 16),
                     system_prompt_len=sys_len,
                     vocab_size=cfg.vocab_size, seed=14)

    def prefix_trace():
        from repro_torch.serving.workload import (WorkloadConfig,
                                                  generate_trace)
        return generate_trace(WorkloadConfig(**prefix_wl))

    # bf16: the prefix and chunk steps run other shapes than the dense
    # serve's whole-prompt prefills (other GEMM and SGMV splits), and
    # chameleon's random-weight logits sit on bf16 near-ties (top-2
    # margins of 0 in the route check): streams counted, not held. f32
    # (the same weights, widened): streams held equal.
    paged_kw = dict(prefix_cache=True, prefill_chunk=chunk)
    for dname in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dname)
        p = (params if dname == "bfloat16"
             else _cast_tree(torch, params, torch.float32))
        runs = dense_paged_pair(
            torch, dev, c, p, source, spec, prefix_trace,
            f"chameleon-34b edgelora {dname}", paged_kw=paged_kw,
            same_summary=False, same_streams=dname == "float32",
            **short_kw)
        ps = runs["paged"]["summary"].prefix_stats
        check(ps["hit_requests"] > 0 and ps["saved_prefill_tokens"] > 0,
              f"chameleon-34b {dname}: no prefix hits: {ps}")
        check(runs["paged"]["step_names"].get("_prefill_suffix", 0) > 0,
              f"chameleon-34b {dname}: no suffix (prefix or chunk) prefill "
              "step")
        rec[f"serve_prefix_chunk_{dname}"] = _summaries(runs)
        del p
        _release(torch)
    del params, source
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    log(f"chameleon-34b {rec['seconds']:.1f}s")
    out["chameleon-34b"] = rec
    return out


# ---------------------------------------------------------------------------
# phase 12: the MoE family at full width: dbrx-132b (8 of 40 layers) and
# llama4-maverick (4 of 48 layers, 32 of 128 experts)
# ---------------------------------------------------------------------------

# dbrx-132b's 264 GB of bf16 weights: 8 of its 40 layers (6.3 GB of
# experts a layer, ~55 GB with the untied embedding and head) leave room
# for a pool, caches and the plain route
DBRX_LAYERS = 8
DBRX_S, DBRX_LENGTHS = 4096, (4096, 3900)
# llama4-maverick: 128 experts x 3 x 5120 x 8192 are 30 GiB a MoE layer;
# one iRoPE period (4 layers: local, MoE-local, local, MoE-global) with
# 32 of the 128 experts holds ~20 GiB, leaving room for 8.7K-token prompts
LLAMA4_LAYERS, LLAMA4_EXPERTS = 4, 32
LLAMA4_S, LLAMA4_LENGTHS = 8704, (8704, 8450)
LLAMA4_CTX = 8704       # its serves' max_ctx: 8600 + 32 tokens fit
LLAMA4_LONG = (8200, 8600)      # its serves' long prompts, past the chunk
# the decode kernel rows' ring depths (the last row idle)
DBRX_DEPTHS = (4096, 4000, 3000, 2048, 1000, 200, 1, 0)
LLAMA4_DEPTHS = (8704, 8600, 8450, 8193, 8192, 1000, 1, 0)
MOE_DECODE_STEPS = 4
# a token whose experts differ between the kernel and the plain route is a
# near-tie when the plain route's own top-k mass exceeds the kernel
# route's choice by at most this probability: the routes' hidden states
# differ by up to ROUTE_TOL, which moves a router probability by ~1e-2
ROUTE_FLIP_MARGIN = 5e-2


def _moe_params(torch, dev, cfg, seed):
    """``Model.init``'s distributions for ``cfg`` drawn leaf by leaf, a
    stacked leaf one group at a time in f32 (a dbrx expert leaf drawn
    whole would take 34 GB of f32 beside its bf16 copy; qwen1.5-110b's
    MLP leaves 26 GB), then ``prepare_weights``. The router stays f32."""
    import math

    from repro_torch.models import build_model
    gen = torch.Generator(device=dev).manual_seed(seed)

    def draw(node, name):
        if isinstance(node, dict):
            return {k: draw(v, k) for k, v in node.items()}
        out = torch.zeros(node.shape, dtype=node.dtype, device=dev)
        if name == "scale":                    # norms: (1 + 0)
            return out
        std = 1.0 / max(1.0, math.sqrt(node.shape[0]))
        # a stacked leaf ([ng, ...], 3-D and up) one group at a time
        parts = out.unbind(0) if out.dim() >= 3 else (out,)
        tmp = torch.empty(parts[0].shape, dtype=torch.float32, device=dev)
        for part in parts:
            torch.nn.init.trunc_normal_(tmp, 0.0, 1.0, -2.0, 2.0,
                                        generator=gen)
            part.copy_(tmp.mul_(std))
        return out

    params = draw(build_model(cfg, dev)._param_tree(None), "")
    prepare_weights(torch, cfg, params, gen)
    n = sum(p.numel() for p in _leaves(params))
    experts = (f", {cfg.moe.n_experts} experts top-{cfg.moe.top_k}"
               if cfg.moe is not None else "")
    log(f"{cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}{experts}: {n / 1e9:.2f}B params; adapters of "
        f"{cfg.lora_adapter_bytes() / 1e6:.1f} MB")
    return params


class _MoEProbe:
    """Hooks ``moe.route`` for a route check. The kernel route's calls
    record their expert choices; each other route's calls replay them in
    order (gates from its own router probabilities at those experts), so
    that a bf16 near-tie broken the other way in routing, a discrete jump
    in a token's output, cannot stand for a kernel fault: both routes run
    the same dispatch. Each replayed call counts the tokens whose own top-k
    differs and the largest probability margin among them (its own top-k
    mass less the pinned experts'). Every capacity dispatch records its
    choices, capacity and dropped choices (read on the host)."""

    def __init__(self, torch) -> None:
        from repro_torch.models import moe
        self.torch, self.moe, self._route = torch, moe, moe.route
        self.recorded, self.i, self.replay = [], 0, False
        self.flips, self.dispatch = [], []

    def on_route(self, name: str) -> None:
        self.replay, self.i = name != "kernels", 0
        if not self.replay:
            self.recorded = []

    def route(self, params, xf, m):
        torch, moe = self.torch, self.moe
        gates, eids, aux = self._route(params, xf, m)
        if not self.replay:
            self.recorded.append(eids)
        else:
            want = self.recorded[self.i]
            self.i += 1
            probs = torch.softmax(xf.float() @ params["router"].float(), -1)
            margin = (probs.gather(1, eids).sum(-1)
                      - probs.gather(1, want).sum(-1))
            differ = (eids.sort(-1).values != want.sort(-1).values).any(-1)
            self.flips.append(dict(tokens=xf.shape[0],
                                   flipped=int(differ.sum()),
                                   max_margin=float(margin.max())))
            gates, eids = probs.gather(1, want), want
            if m.top_k > 1:
                gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
        t = xf.shape[0]
        if not 0 < t * m.top_k <= m.gather_threshold:
            pos = moe.queue_positions(eids.reshape(-1), m.n_experts)
            cap = moe.capacity(t, m)
            self.dispatch.append(dict(choices=t * m.top_k, capacity=cap,
                                      dropped=int((pos >= cap).sum())))
        return gates, eids, aux

    def __enter__(self):
        self.moe.route = self.route
        return self

    def __exit__(self, *exc):
        self.moe.route = self._route


def expert_rows(torch, dev, cfg, params, prefill_t):
    """One MoE layer's expert FFN (``moe._expert_ffn``: three batched
    GEMMs over all E experts) at a decode step's buffer (8 rows: the
    lossless capacity 8·k a expert) and at the route check's prefill
    (``prefill_t`` tokens: its capacity), bf16, timed beside its bound
    (all E experts' weights read once at the HBM rate, or the GEMMs'
    operations at the bf16 peak); and the whole ``moe_block`` at the
    decode step (routing, dispatch, experts, combine, a shared expert)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import group_view, slot_is_moe

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(41)
    slot = next(p for p in range(len(params["layers"]))
                if slot_is_moe(cfg, p))
    layer = group_view(params["layers"][f"slot{slot}"]["moe"], 0)
    m, d, f = cfg.moe, cfg.d_model, cfg.d_ff
    w_bytes = 3 * m.n_experts * d * f * 2
    rows = []
    for case, t in (("decode", N_SLOTS), ("prefill", prefill_t)):
        cap = moe.capacity(t, m)
        buf = torch.randn(m.n_experts, cap, d, generator=gen,
                          device=dev).bfloat16()
        out = moe._expert_ffn(layer["experts"], buf, act=cfg.act, glu=cfg.glu)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out.float()).all()),
              f"{cfg.name}: non-finite expert FFN")
        bnd, by = bound_ms(w_bytes + 2 * buf.numel() * 2,
                           6.0 * m.n_experts * cap * d * f, "bfloat16")
        row = dict(kernel="expert_ffn", model=cfg.name, case=case, T=t,
                   capacity=cap, experts=m.n_experts,
                   shape=f"[{m.n_experts}, {cap}, {d}] x [{m.n_experts}, "
                         f"{d}, {f}] x3 bf16",
                   weight_bytes=w_bytes, bound_ms=bnd, bound_by=by,
                   ms=cuda_ms(torch, lambda: moe._expert_ffn(
                       layer["experts"], buf, act=cfg.act, glu=cfg.glu),
                       flush, iters=10))
        if case == "decode":
            x = torch.randn(N_SLOTS, 1, d, generator=gen,
                            device=dev).bfloat16()
            row["moe_block_ms"] = cuda_ms(
                torch, lambda: moe.moe_block(layer, x, cfg), flush, iters=10)
            row["moe_block_host_us"] = enqueue_us(
                torch, lambda: moe.moe_block(layer, x, cfg), iters=10)
        rows.append(row)
        log("expert_ffn " + json.dumps(row))
        del buf, out
    return rows


def moe_route_check(torch, dev, cfg, params, spec, *, lengths, s, where):
    """``route_check`` (kernels against plain attention and einsum LoRA)
    over a ``len(lengths)`` x ``s`` prefill and MOE_DECODE_STEPS decode
    steps, the plain route's experts pinned to the kernel route's
    (``_MoEProbe``): routing near-ties it would break the other way are
    counted with their probability margins, each at most
    ``ROUTE_FLIP_MARGIN``; dropped choices recorded per dispatch."""
    routes = {"kernels": ROUTES["kernels"], "plain": ROUTES["plain"]}
    with _MoEProbe(torch) as probe:
        res = route_check(torch, dev, cfg, params, spec, routes,
                          lengths=lengths, s=s,
                          decode_steps=MOE_DECODE_STEPS, where=where,
                          on_route=probe.on_route)
    res["dispatch"], res["routing_flips"] = probe.dispatch, probe.flips
    prefill = [r for r in probe.dispatch
               if r["choices"] == len(lengths) * s * cfg.moe.top_k]
    log(f"  {where}: prefill capacity {prefill[0]['capacity']} an expert "
        f"for {prefill[0]['choices']} choices; dropped per MoE layer "
        f"(both routes): {[r['dropped'] for r in prefill]}; plain-route "
        f"routing flips per call: {[f['flipped'] for f in probe.flips]}, "
        f"largest margin {max(f['max_margin'] for f in probe.flips):.2e}")
    check(all(r["dropped"] == 0 for r in probe.dispatch
              if r["choices"] <= 4096), f"{where}: a lossless step dropped")
    check(all(f["max_margin"] <= ROUTE_FLIP_MARGIN for f in probe.flips),
          f"{where}: the plain route's own experts differ from the kernel "
          f"route's beyond a near-tie: {probe.flips}")
    return res


def moe_phase(torch, dev):
    """Phase 12 (see the module docstring). Returns its record, keyed by
    model as phase 11's: route checks, serves (their launches included),
    kernel rows at the new shapes and the expert FFN's rows."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate_trace

    out = {}
    # ---- dbrx-132b, 8 of 40 layers ----------------------------------------
    t0 = time.perf_counter()
    full = get_config("dbrx-132b")
    check(full.n_layers == 40 and full.d_model == 6144 and full.n_heads == 48
          and full.n_kv_heads == 8 and full.resolved_head_dim == 128
          and full.d_ff == 10752 and full.vocab_size == 100352
          and full.moe.n_experts == 16 and full.moe.top_k == 4
          and full.moe.gather_threshold == 0 and not full.moe.shared_expert
          and full.lora.rank == 16
          and full.lora.target_modules == ("q", "k", "v", "o"),
          "not the full dbrx-132b config")
    cfg = dataclasses.replace(full, n_layers=DBRX_LAYERS,
                              lora=dataclasses.replace(
                                  full.lora,
                                  n_adapters=2 * full.lora.max_resident))
    log(f"dbrx-132b: full width, {DBRX_LAYERS} of its {full.n_layers} "
        f"layers ({full.param_count() / 1e9:.1f}B params at full depth)")
    spec = variant_spec(cfg)
    rec = dict(layers=DBRX_LAYERS, full_layers=full.n_layers,
               kernel_rows=kernel_phase(torch, dev, spec),
               attention_rows=variant_attention_rows(
                   torch, dev, cfg, ctx=DBRX_S, depths=DBRX_DEPTHS,
                   prefill=(len(DBRX_LENGTHS), DBRX_S)))
    params = _moe_params(torch, dev, cfg, 24)
    check(all(slot["moe"]["router"].dtype == torch.float32
              for slot in params["layers"].values()), "router not f32")
    rec["expert_rows"] = expert_rows(torch, dev, cfg, params,
                                     len(DBRX_LENGTHS) * DBRX_S)
    source = make_adapter_source(torch, dev, cfg)
    rec["route_check"] = moe_route_check(
        torch, dev, cfg, params, spec, lengths=DBRX_LENGTHS, s=DBRX_S,
        where="dbrx-132b")
    # serves: 8 requests of 40-200 tokens in buckets of 64 and 256 (a
    # group of 8 x 256 is 8192 choices: a finite capacity of 640 a expert)
    serve_kw = dict(max_ctx=MAX_CTX, prompt_buckets=(64, 256))

    def burst(n=8, **kw):
        wl = dict(n_adapters=cfg.lora.n_adapters, request_rate=200.0,
                  duration=0.1, input_range=(40, 200), output_range=(8, 24),
                  vocab_size=cfg.vocab_size, seed=15)
        wl.update(kw)
        trace = generate_trace(WorkloadConfig(**wl))[:n]
        check(len(trace) == n, f"burst of {len(trace)} requests")
        return trace

    rec["serve_edgelora"] = _summaries(dense_paged_pair(
        torch, dev, cfg, params, source, spec, burst,
        "dbrx-132b edgelora", **serve_kw))
    short_kw = dict(max_ctx=MAX_CTX, prompt_buckets=(32, 64, 128))
    short = dict(n=10, input_range=(8, 64), output_range=(4, 12))
    for policy in ("llamacpp", "dlora"):
        eng = _variant_engine(torch, dev, cfg, params, source, policy,
                              "dense", **short_kw)
        run = qwen2_serve(torch, dev, f"dbrx-132b {policy} dense", eng,
                          burst(**short), spec)
        if policy == "llamacpp":
            check(run["unmerged_calls"] == 0 and run["merged_calls"] > 0
                  and run["launches"]["sgmv_shrink"] == 0,
                  "dbrx-132b llamacpp: unmerged steps ran")
        else:
            check(run["unmerged_calls"] > 0,
                  "dbrx-132b dlora: no unmerged step on a diverse trace")
        run["summary"] = dataclasses.asdict(run["summary"])
        rec[f"serve_{policy}"] = run
        del eng
        _release(torch)
    # the prefix cache and 32-token chunks: groups of at most 8 x 128
    # tokens (4096 choices: lossless), so a chunked prefill drops nothing
    # a whole-prompt one keeps. bf16 at 8 layers counted; f32 held equal
    sys_len, chunk = 32, 32
    prefix = dict(n=12, n_adapters=4, input_range=(8, 64),
                  output_range=(4, 12), system_prompt_len=sys_len,
                  duration=0.2, seed=16)
    paged_kw = dict(prefix_cache=True, prefill_chunk=chunk)
    runs = dense_paged_pair(
        torch, dev, cfg, params, source, spec, lambda: burst(**prefix),
        "dbrx-132b prefix+chunk bfloat16", paged_kw=paged_kw,
        same_summary=False, same_streams=False, **short_kw)
    rec["serve_prefix_chunk_bfloat16"] = _summaries(runs)
    del params, source
    _release(torch)
    c2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = _moe_params(torch, dev, c2, 25)
    spec2 = variant_spec(c2)
    runs = dense_paged_pair(
        torch, dev, c2, params, make_adapter_source(torch, dev, c2), spec2,
        lambda: burst(**prefix), "dbrx-132b (2 layers) prefix+chunk float32",
        paged_kw=paged_kw, same_summary=False, **short_kw)
    for dname, r in (("float32", runs["paged"]),
                     ("bfloat16", rec["serve_prefix_chunk_bfloat16"][
                         "paged"])):
        ps = r["summary"].prefix_stats if dname == "float32" else r[
            "summary"]["prefix_stats"]
        check(ps["hit_requests"] > 0 and ps["saved_prefill_tokens"] > 0,
              f"dbrx-132b {dname}: no prefix hits: {ps}")
        check(r["step_names"].get("_prefill_suffix", 0) > 0,
              f"dbrx-132b {dname}: no suffix (prefix or chunk) prefill")
    rec["serve_prefix_chunk_float32"] = _summaries(runs)
    del params
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    log(f"dbrx-132b {rec['seconds']:.1f}s")
    out["dbrx-132b"] = rec

    # ---- llama4-maverick, 4 of 48 layers, 32 of 128 experts -------------
    t0 = time.perf_counter()
    full = get_config("llama4-maverick-400b-a17b")
    check(full.n_layers == 48 and full.d_model == 5120 and full.n_heads == 40
          and full.n_kv_heads == 8 and full.d_ff == 8192
          and full.vocab_size == 202048 and full.moe.n_experts == 128
          and full.moe.top_k == 1 and full.moe.shared_expert
          and full.moe.moe_layer_period == 2
          and full.attn.layer_pattern == ("local", "local", "local",
                                          "global")
          and full.attn.chunked_local and full.attn.sliding_window == 8192,
          "not the full llama4-maverick config")
    cfg = dataclasses.replace(
        full, n_layers=LLAMA4_LAYERS,
        moe=dataclasses.replace(full.moe, n_experts=LLAMA4_EXPERTS),
        lora=dataclasses.replace(full.lora,
                                 n_adapters=2 * full.lora.max_resident))
    log(f"llama4-maverick: full width, {LLAMA4_LAYERS} of its "
        f"{full.n_layers} layers, {LLAMA4_EXPERTS} of its "
        f"{full.moe.n_experts} experts ({full.param_count() / 1e9:.0f}B "
        "params at full size)")
    spec = variant_spec(cfg)
    rec = dict(layers=LLAMA4_LAYERS, full_layers=full.n_layers,
               experts=LLAMA4_EXPERTS, full_experts=full.moe.n_experts,
               kernel_rows=kernel_phase(torch, dev, spec),
               attention_rows=variant_attention_rows(
                   torch, dev, cfg, ctx=LLAMA4_CTX, depths=LLAMA4_DEPTHS,
                   prefill=(len(LLAMA4_LENGTHS), LLAMA4_S)))
    params = _moe_params(torch, dev, cfg, 26)
    rec["expert_rows"] = expert_rows(torch, dev, cfg, params,
                                     len(LLAMA4_LENGTHS) * LLAMA4_S)
    source = make_adapter_source(torch, dev, cfg)
    rec["route_check"] = moe_route_check(
        torch, dev, cfg, params, spec, lengths=LLAMA4_LENGTHS, s=LLAMA4_S,
        where="llama4-maverick")

    runs = dense_paged_pair(
        torch, dev, cfg, params, source, spec,
        lambda: long_trace(cfg, cfg.lora.n_adapters, 17,
                           lengths=LLAMA4_LONG),
        "llama4-maverick edgelora", max_ctx=LLAMA4_CTX,
        prompt_buckets=(64, 256))
    for r in runs.values():
        check(r["step_calls"].get("decode", 0) > 0
              and max(len(v) for v in r["streams"].values()) >= 16,
              "llama4-maverick: no long decode")
    rec["serve_edgelora"] = _summaries(runs)
    refusals = {}
    for feature, kw in (("prefix_cache", dict(kv_backend="paged",
                                              prefix_cache=True)),
                        ("prefill_chunk", dict(prefill_chunk=32))):
        try:
            EdgeLoRAEngine(cfg, EngineConfig(n_slots=N_SLOTS,
                                             max_ctx=LLAMA4_CTX, **kw),
                           params=params, device=dev,
                           adapter_source=source)
        except ValueError as e:
            refusals[feature] = str(e)
        _release(torch)
        check(feature in refusals
              and "window-local ring" in refusals[feature],
              f"llama4-maverick: {feature} was not refused: {refusals}")
    rec["refusals"] = refusals
    del params, source
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    log(f"llama4-maverick {rec['seconds']:.1f}s")
    out["llama4-maverick-400b-a17b"] = rec
    return out


def variant_attention_rows(torch, dev, cfg, ctx=LONG_CTX,
                           depths=(4400, 4300, 4200, 4097, 1000, 200, 1, 0),
                           prefill=None, causal=True):
    """``flash_decode`` and ``flash_prefill`` at ``cfg``'s layer shapes,
    bf16, against their plain versions, timed beside them, the library
    call (``scaled_dot_product_attention`` with GQA and the mask) and the
    bound: decode over a ring of ``cache_len_for(kind, ctx)`` entries
    (8 rows at ``depths``, the last idle), with the window (or chunk) and
    softcap of the model's first slot (gemma2: also the int8 ring with
    bf16 scales as the cache stores them, through ``ops.decode_attention``,
    the scales' cast timed apart); prefill of ``LONG_LENGTHS``-row prompts
    of ``LONG_S`` tokens past the window (chameleon: 8 rows of 64), or of
    ``prefill`` = (rows, tokens). A chunked-local slot's mask keeps the
    keys of the query's own chunk; SDPA takes it as a boolean mask.
    ``causal=False``: the prefill row is an encoder's (every key visible;
    SDPA without a mask)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_prefill as fp
    from repro_torch.kernels import ops
    from repro_torch.models.attention import _quantize_kv
    from repro_torch.models.transformer import cache_len_for

    gen = torch.Generator(device=dev).manual_seed(31)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    h, kh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    g = h // kh
    kind = cfg.attn.layer_pattern[0]
    window = cfg.attn.sliding_window if kind == "local" else None
    chunked = window is not None and cfg.attn.chunked_local
    softcap = cfg.attn.attn_logit_softcap
    bf = torch.bfloat16
    rows = []

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(bf)

    def err(got, want):
        torch.cuda.synchronize()
        check(bool(torch.isfinite(got.float()).all()), "non-finite output")
        d = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        check(d <= ATTN_TOL["bfloat16"] * scale,
              f"{cfg.name}: max abs err {d:.3e} > "
              f"{ATTN_TOL['bfloat16']:.1e} x {scale:.3e}")
        return d

    # ---- flash_decode ---------------------------------------------------
    b, c = N_SLOTS, cache_len_for(kind, cfg, ctx)
    depth = torch.tensor(depths, dtype=torch.int32, device=dev)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    newest = (depth[:, None] - 1 - idx) // c * c + idx
    kv_pos = torch.where(newest >= 0, newest, -1).to(torch.int32)
    q_pos = (depth - 1).clamp_min(0)
    visible = (kv_pos >= 0) & (kv_pos <= q_pos[:, None])
    if chunked:
        visible &= (q_pos[:, None] // window) == (kv_pos // window)
    elif window is not None:
        visible &= (q_pos[:, None] - kv_pos) < window
    no_key = ~visible.any(1)
    n_vis = int(visible.sum())
    mask = visible[:, None, None, :]
    kw = dict(window=window, chunked=chunked, softcap=softcap)
    q = randn(b, h, hd)
    kinds = [("bfloat16", None)]
    if cfg.name == "gemma2-9b":
        kinds.append(("int8", None))
    for kvname, _ in kinds:
        if kvname == "int8":
            k, ks = _quantize_kv(torch.randn(b, c, kh, hd, generator=gen,
                                             device=dev))
            v, vs = _quantize_kv(torch.randn(b, c, kh, hd, generator=gen,
                                             device=dev))
            scales = dict(k_scale=ks.to(bf), v_scale=vs.to(bf))
            kv_es, extra = 1, 2        # a bf16 scale per (entry, kv head)
        else:
            k, v = randn(b, c, kh, hd), randn(b, c, kh, hd)
            scales, kv_es, extra = {}, 2, 0

        def call():
            return ops.decode_attention(q, k, v, kv_pos, q_pos, **scales,
                                        **kw)

        def plain():
            return ops.decode_attention(q, k, v, kv_pos, q_pos, **scales,
                                        use_kernel=False, **kw)

        e = err(call(), plain())
        per_entry = kh * (hd * kv_es + extra)
        nbytes = (2 * q.numel() * 2 + kv_pos.numel() * 4 + b * 4
                  + n_vis * 2 * per_entry + int(no_key.sum()) * c * per_entry)
        flops = 4.0 * hd * g * n_vis + 2.0 * hd * h * c * int(no_key.sum())
        bnd, by = bound_ms(nbytes, flops, "bfloat16")
        if scales:
            kd = (k.float() * scales["k_scale"].float()[..., None]).to(bf)
            vd = (v.float() * scales["v_scale"].float()[..., None]).to(bf)
        else:
            kd, vd = k, v
        kl, vl = (x.transpose(1, 2).contiguous() for x in (kd, vd))
        qs = q[:, :, None, :]
        row = dict(
            kernel="flash_decode", model=cfg.name, dtype="bfloat16",
            kv_dtype=kvname,
            shape=f"q [{b},{h},{hd}] k,v [{b},{c},{kh},{hd}] {kvname}, "
                  f"{'chunk' if chunked else 'window'} {window}, softcap "
                  f"{softcap}, depths {depth.tolist()}",
            visible_entries=n_vis,
            max_abs_err=e, ms=cuda_ms(torch, call, flush),
            host_us=enqueue_us(torch, call),
            plain_ms=cuda_ms(torch, plain, flush),
            bound_ms=bnd, bound_by=by)
        # SDPA has no softcap: with one it is a yardstick of a different
        # function, kept apart, and the row has no library call
        lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, kl, vl, attn_mask=mask, enable_gqa=True), flush)
        row["library_ms"] = None if softcap else lib
        if softcap:
            row["sdpa_without_softcap_ms"] = lib
        if scales:
            # what the wrapper adds for the cache's bf16 scales: two casts
            row["scale_cast_ms"] = cuda_ms(torch, lambda: (
                scales["k_scale"].float(), scales["v_scale"].float()), flush)
        rows.append(row)
        log("flash_decode " + json.dumps(row))
        del k, v, kl, vl, kd, vd

    # ---- flash_prefill --------------------------------------------------
    # a model with local layers at the long prompts (its local, windowed
    # layer: gemma2's global ones are plain causal), else a prefill group
    pw = window
    b, s = ((len(LONG_LENGTHS), LONG_S) if pw is not None
            else (N_SLOTS, 64))
    if prefill is not None:
        b, s = prefill
    q, k, v = randn(b, s, h, hd), randn(b, s, kh, hd), randn(b, s, kh, hd)
    kw = dict(window=pw, chunked=chunked, softcap=softcap, causal=causal)
    pos = torch.arange(s, device=dev)
    vis = (pos[None, :] <= pos[:, None]) | (not causal)
    if chunked:
        vis &= (pos[:, None] // pw) == (pos[None, :] // pw)
    elif pw is not None:
        vis &= (pos[:, None] - pos[None, :]) < pw
    pairs = int(vis.sum())

    def plain_prefill():
        # row by row past 4352 tokens: the plain version holds the whole
        # f32 score matrix (12 GB a row of llama4's 8704 x 8704 x 40)
        if s <= LONG_S:
            return fp.flash_prefill_plain(q, k, v, **kw)
        return torch.cat([fp.flash_prefill_plain(q[i:i + 1], k[i:i + 1],
                                                 v[i:i + 1], **kw)
                          for i in range(b)])

    e = err(fp.flash_prefill(q, k, v, **kw), plain_prefill())
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    bnd, by = bound_ms(nbytes, 4.0 * b * h * hd * pairs, "bfloat16")
    ql, kl, vl = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    row = dict(
        kernel="flash_prefill", model=cfg.name, dtype="bfloat16",
        case="prefill",
        shape=f"q [{b},{s},{h},{hd}] k,v [{b},{s},{kh},{hd}] bf16 "
              f"{'causal' if causal else 'non-causal'}, "
              f"{'chunk' if chunked else 'window'} {pw}, softcap {softcap}",
        visible_pairs=pairs, max_abs_err=e,
        ms=cuda_ms(torch, lambda: fp.flash_prefill(q, k, v, **kw), flush),
        host_us=enqueue_us(torch, lambda: fp.flash_prefill(q, k, v, **kw)),
        plain_ms=cuda_ms(torch, plain_prefill, flush, iters=5),
        bound_ms=bnd, bound_by=by)
    lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        ql, kl, vl, attn_mask=vis if causal else None, enable_gqa=True),
        flush)
    row["library_ms"] = None if softcap else lib
    if softcap:
        row["sdpa_without_softcap_ms"] = lib
    rows.append(row)
    log("flash_prefill " + json.dumps(row))
    del q, k, v, ql, kl, vl
    _release(torch)
    return rows


# ---------------------------------------------------------------------------
# phase 13: the SSM family (mamba2-130m, zamba2-2.7b) and qwen1.5-110b
# ---------------------------------------------------------------------------

# route check prompts of the SSM models: two chunked-SSD chunks short of
# 16, ragged (dt = 0 on the shorter row's padding)
SSM_S, SSM_LENGTHS = 4096, (4096, 3900)
SSM_DECODE_STEPS = 4
# zamba2's decode kernel rows: ring depths of 8 rows over a 4096 ring
SSM_DEPTHS = (4096, 4000, 3000, 2048, 1000, 200, 1, 0)
# qwen1.5-110b's 220 GB of bf16 weights: 16 of its 80 layers (2.7 GB a
# layer, ~49 GB with the untied embedding and head)
QWEN15_LAYERS = 16
QWEN15_S, QWEN15_LENGTHS = 2048, (2048, 1900)
QWEN15_DEPTHS = (2048, 2000, 1900, 1024, 500, 100, 1, 0)
# the f32 state carry: zamba2 at 12 of its 54 layers (two groups, two
# shared-block applications); mamba2 at full depth
ZAMBA2_CARRY_LAYERS = 12
# a prefill of S tokens + a decode step on token S against the last
# position of a prefill of S + 1, in f32: prompts inside the first SSD
# chunk and past it (chunk 256), at least d_conv - 1 = 3 tokens long
CARRY_S = (5, 300)
CARRY_TOL = 1e-4
# the SSM models' kernel route against the plain one in f32 (held: every
# op of both routes in f32, so what is left is accumulation order); in
# bf16 the two differ by 7-11 % of max|logit| on a random mamba2 (rounding
# amplified through 24 gated SSD blocks; 0 in f32 on the CPU, where both
# routes run the same plain code), so the bf16 check is counted
F32_ROUTE_TOL = 1e-3


def ssd_rows(torch, dev, cfg, params):
    """One ``ssm_block_full`` at [2, SSM_S] (``SSM_LENGTHS``, with
    ``seq_mask``, ``lengths`` and the returned state) and one
    ``ssm_block_decode`` at ``N_SLOTS`` rows, of ``cfg``'s first Mamba-2
    slot in bf16 without LoRA, timed with CUDA events beside their
    bound. Not kernels: plain PyTorch, as the reference computes the SSD
    outside any Pallas call. The bound: the weights, x, the output and
    the state moved once against the larger of that over the HBM rate
    and the GEMMs (bf16) plus the SSD's f32 einsums over their peaks."""
    from repro_torch.models import ssm
    from repro_torch.models.transformer import group_view

    gen = torch.Generator(device=dev).manual_seed(41)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    sp = group_view(params["layers"], 0)["slot0"]["ssm"]
    s, d, di, h, g, n, p = ssm._dims(cfg)
    in_dim, conv_ch = 2 * di + 2 * g * n + h, di + 2 * g * n
    w_bytes = (2 * (d * in_dim + di * d + s.d_conv * conv_ch + conv_ch + di)
               + 4 * 3 * h)
    bf = torch.bfloat16

    def bound(nbytes, gemm, f32):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = 1e3 * (gemm / PEAK_FLOPS["bfloat16"]
                       + f32 / PEAK_FLOPS["float32"])
        return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
                else "operations")

    b, sl = len(SSM_LENGTHS), SSM_S
    x = torch.randn(b, sl, d, generator=gen, device=dev).to(bf)
    lens = torch.tensor(SSM_LENGTHS, dtype=torch.int32, device=dev)
    mask = torch.arange(sl, device=dev)[None] < lens[:, None]

    def full():
        return ssm.ssm_block_full(sp, x, cfg, return_state=True,
                                  seq_mask=mask, lengths=lens)

    with torch.no_grad():
        got = full()
        torch.cuda.synchronize()
        check(all(bool(torch.isfinite(t.float()).all()) for t in got),
              f"{cfg.name}: ssm_block_full not finite")
        del got
        chunk = min(s.chunk_size, sl)
        nc, t = -(-sl // chunk), b * sl
        gemm = 2.0 * t * (d * in_dim + di * d)
        # intra-chunk C.B^T and its product with x, the chunk states and
        # the entering states' contribution
        f32 = (2.0 * b * nc * h * chunk * chunk * (n + p)
               + 4.0 * t * h * p * n)
        nbytes = (w_bytes + 2 * t * d * 2 + b * h * p * n * 4
                  + b * (s.d_conv - 1) * conv_ch * 2)
        bnd, by = bound(nbytes, gemm, f32)
        rows = [dict(
            function="ssm_block_full", model=cfg.name,
            shape=f"x [{b},{sl},{d}] bf16, lengths {list(SSM_LENGTHS)}, "
                  f"chunk {chunk}, {h} heads of {p}, d_state {n}, no LoRA",
            ms=cuda_ms(torch, full, flush, iters=5, warm=1),
            bound_ms=bnd, bound_by=by, gemm_flops=gemm, ssd_f32_flops=f32,
            bytes=nbytes)]
        cache = ssm.init_ssm_cache(N_SLOTS, cfg, bf, device=dev)
        cache["state"].normal_(generator=gen)
        cache["conv"].normal_(generator=gen)
        xd = torch.randn(N_SLOTS, d, generator=gen, device=dev).to(bf)

        def dec():
            return ssm.ssm_block_decode(sp, xd, cache, cfg)

        y, new = dec()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(y.float()).all())
              and bool(torch.isfinite(new["state"]).all()),
              f"{cfg.name}: ssm_block_decode not finite")
        nbytes = (w_bytes + 2 * N_SLOTS * d * 2 + 2 * N_SLOTS * h * p * n * 4
                  + 2 * N_SLOTS * (s.d_conv - 1) * conv_ch * 2)
        bnd, by = bound(nbytes, 2.0 * N_SLOTS * (d * in_dim + di * d),
                        6.0 * N_SLOTS * h * p * n)
        rows.append(dict(
            function="ssm_block_decode", model=cfg.name,
            shape=f"x [{N_SLOTS},{d}] bf16, state [{N_SLOTS},{h},{p},{n}] "
                  "f32, no LoRA",
            ms=cuda_ms(torch, dec, flush), host_us=enqueue_us(torch, dec),
            bound_ms=bnd, bound_by=by, bytes=nbytes))
    for r in rows:
        log(f"{r['function']} " + json.dumps(r))
    del x, cache, xd
    _release(torch)
    return rows


def f32_checks(torch, dev, full, n_layers, seed, where):
    """``full`` at ``n_layers`` in f32: the route check at [2, SSM_S]
    (the kernel route against plain attention and einsum LoRA, held
    within ``F32_ROUTE_TOL``), then the state carry on the kernel route
    (``flash_prefill``/``flash_decode`` in f32, SGMV): a prefill of S
    tokens (2 rows, mixed adapters, B nonzero) then a decode step on
    token S gives the logits of the last position of a prefill of S + 1
    tokens within ``CARRY_TOL`` of max|logit|, for each S of
    ``CARRY_S``: the chunked dual form and the recurrence agree on the
    card, the conv ring and the shared block's ring carried."""
    import dataclasses

    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import build_model

    cfg = dataclasses.replace(full, n_layers=n_layers, dtype="float32")
    params = _variant_params(torch, dev, cfg, seed)
    res = dict(layers=n_layers)
    res["route_check"] = route_check(
        torch, dev, cfg, params, variant_spec(cfg),
        {"kernels": ROUTES["kernels"], "plain": ROUTES["plain"]},
        lengths=SSM_LENGTHS, s=SSM_S, decode_steps=SSM_DECODE_STEPS,
        where=f"{where} f32", tol=F32_ROUTE_TOL)
    model = build_model(cfg, dev, attn_kernel=True)
    model.load_params(params)
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = model.init_lora(gen, n_slots=N_SLOTS)
    _draw_b(pool, gen)
    b = 2
    mode = LoRAMode("batched", torch.tensor([3, 5], dtype=torch.int32,
                                            device=dev),
                    cfg.lora.scale, "sgmv")
    _reset_counts()
    for s in CARRY_S:
        tokens = torch.randint(0, cfg.vocab_size, (b, s + 1), generator=gen,
                               device=dev, dtype=torch.int32)
        pos = torch.full((b,), s, dtype=torch.int32, device=dev)
        with torch.no_grad():
            _, cache = model.prefill(params, {"tokens": tokens[:, :s]},
                                     model.init_cache(b, s + 1), pool, mode)
            got, _ = model.decode_step(params, tokens[:, s], cache, pos,
                                       pool, mode)
            want, _ = model.prefill(params, {"tokens": tokens},
                                    model.init_cache(b, s + 1), pool, mode)
        torch.cuda.synchronize()
        d = (got - want).abs().max().item()
        scale = want.abs().max().item()
        res[f"S{s}"] = dict(max_abs=d, max_logit=scale, tol=CARRY_TOL,
                            top1_equal=bool((got.argmax(-1)
                                             == want.argmax(-1)).all()))
        log(f"{where} f32 state carry S={s}: " + json.dumps(res[f"S{s}"]))
        check(bool(torch.isfinite(got).all()) and d <= CARRY_TOL * scale,
              f"{where}: prefill {s} + decode differs from prefill {s + 1}"
              f" by {d:.3e} > {CARRY_TOL} x {scale:.3e}")
    res["launches"] = _counts()
    check(res["launches"]["sgmv_shrink"] > 0,
          f"{where}: the state carry ran no SGMV kernel")
    del model, params, pool
    _release(torch)
    return res


def ssm_phase(torch, dev):
    """Phase 13 (see the module docstring). Returns its record, keyed by
    model as phases 11-12's: kernel rows at the new shapes (hd 80
    attention included), the SSD block's rows, route checks (the SSM
    models': bf16 counted, f32 held), the state carry, serves (their
    launches included) and the refusals."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig
    from repro_torch.serving.workload import WorkloadConfig, generate_trace

    out = {}
    routes = {"kernels": ROUTES["kernels"], "plain": ROUTES["plain"]}

    def burst(cfg, n=8, **kw):
        wl = dict(n_adapters=cfg.lora.n_adapters, request_rate=200.0,
                  duration=0.1, input_range=(40, 200), output_range=(8, 24),
                  vocab_size=cfg.vocab_size, seed=18)
        wl.update(kw)
        trace = generate_trace(WorkloadConfig(**wl))[:n]
        check(len(trace) == n, f"burst of {len(trace)} requests")
        return trace

    def serves(cfg, params, source, spec, rec):
        """edgelora dense vs paged (8 requests of 40-200 tokens), then
        llamacpp (merged only) and dlora (unmerges) on short prompts."""
        rec["serve_edgelora"] = _summaries(dense_paged_pair(
            torch, dev, cfg, params, source, spec, lambda: burst(cfg),
            f"{cfg.name} edgelora", max_ctx=MAX_CTX,
            prompt_buckets=(64, 256)))
        short = dict(n=10, input_range=(8, 64), output_range=(4, 12))
        for policy in ("llamacpp", "dlora"):
            eng = _variant_engine(torch, dev, cfg, params, source, policy,
                                  "dense", max_ctx=MAX_CTX,
                                  prompt_buckets=(32, 64, 128),
                                  memory_budget=1e12)
            run = qwen2_serve(torch, dev, f"{cfg.name} {policy} dense", eng,
                              burst(cfg, **short), spec)
            if policy == "llamacpp":
                check(run["unmerged_calls"] == 0 and run["merged_calls"] > 0
                      and run["launches"]["sgmv_shrink"] == 0,
                      f"{cfg.name} llamacpp: unmerged steps ran")
            else:
                check(run["unmerged_calls"] > 0,
                      f"{cfg.name} dlora: no unmerged step on a diverse "
                      "trace")
            run["summary"] = dataclasses.asdict(run["summary"])
            rec[f"serve_{policy}"] = run
            del eng
            _release(torch)

    def refusals(cfg, params, source, reason):
        """The prefix cache and chunked prefill refused with the
        reference's ``ValueError`` (its first reason: ``reason``)."""
        got = {}
        for feature, kw in (("prefix_cache", dict(kv_backend="paged",
                                                  prefix_cache=True)),
                            ("prefill_chunk", dict(prefill_chunk=32))):
            try:
                EdgeLoRAEngine(cfg, EngineConfig(n_slots=N_SLOTS,
                                                 max_ctx=MAX_CTX, **kw),
                               params=params, device=dev,
                               adapter_source=source)
            except ValueError as e:
                got[feature] = str(e)
            _release(torch)
            check(got.get(feature, "").startswith(
                f"{feature} unsupported for {cfg.name}: {reason}"),
                f"{cfg.name}: {feature} was not refused: {got}")
        return got

    def f32_leaves(params):
        for slot in params["layers"].values():
            for name in ("dt_bias", "A_log", "D"):
                check(slot["ssm"][name].dtype == torch.float32,
                      f"{name} not f32")

    # ---- mamba2-130m, full depth -----------------------------------------
    t0 = time.perf_counter()
    cfg = get_config("mamba2-130m")
    check(cfg.n_layers == 24 and cfg.d_model == 768 and cfg.d_ff == 0
          and cfg.vocab_size == 50280 and cfg.tie_embeddings
          and cfg.ssm.d_state == 128 and cfg.ssm.head_dim == 64
          and cfg.ssm.expand == 2 and cfg.ssm.chunk_size == 256
          and cfg.lora.rank == 16
          and cfg.lora.target_modules == ("in_proj", "out_proj"),
          "not the full mamba2-130m config")
    cfg = dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, n_adapters=2 * cfg.lora.max_resident))
    spec = variant_spec(cfg, cases=[("decode", N_SLOTS),
                                    ("prefill", len(SSM_LENGTHS) * SSM_S)])
    check(spec["lora_calls"] == 48 and spec["attn_calls"] == 0
          and spec["gathers"] == 0, f"mamba2 launch spec {spec}")
    rec = dict(layers=cfg.n_layers, kernel_rows=kernel_phase(torch, dev,
                                                             spec))
    params = _variant_params(torch, dev, cfg, 51)
    f32_leaves(params)
    rec["ssd_rows"] = ssd_rows(torch, dev, cfg, params)
    source = make_adapter_source(torch, dev, cfg)
    rec["route_check"] = route_check(
        torch, dev, cfg, params, spec, routes, lengths=SSM_LENGTHS, s=SSM_S,
        decode_steps=SSM_DECODE_STEPS, where="mamba2-130m bf16 (counted)",
        tol="count")
    serves(cfg, params, source, spec, rec)
    rec["refusals"] = refusals(cfg, params, source,
                               "per-sequence recurrent state")
    del params, source
    _release(torch)
    rec["f32"] = f32_checks(torch, dev, cfg, cfg.n_layers, 52, "mamba2-130m")
    rec["seconds"] = time.perf_counter() - t0
    log(f"mamba2-130m {rec['seconds']:.1f}s")
    out["mamba2-130m"] = rec

    # ---- zamba2-2.7b, full depth -----------------------------------------
    t0 = time.perf_counter()
    cfg = get_config("zamba2-2.7b")
    check(cfg.n_layers == 54 and cfg.d_model == 2560 and cfg.n_heads == 32
          and cfg.n_kv_heads == 32 and cfg.resolved_head_dim == 80
          and cfg.d_ff == 10240 and cfg.vocab_size == 32000
          and cfg.shared_attn_every == 6 and cfg.ssm.d_state == 64
          and cfg.ssm.head_dim == 64 and cfg.ssm.chunk_size == 256
          and cfg.lora.rank == 16 and cfg.lora.target_modules == (
              "in_proj", "out_proj", "q", "k", "v", "o"),
          "not the full zamba2-2.7b config")
    cfg = dataclasses.replace(cfg, lora=dataclasses.replace(
        cfg.lora, n_adapters=2 * cfg.lora.max_resident))
    spec = variant_spec(cfg, cases=[("decode", N_SLOTS),
                                    ("prefill", len(SSM_LENGTHS) * SSM_S)])
    check(spec["lora_calls"] == 144 and spec["attn_calls"] == 9
          and spec["gathers"] == 2 and spec["groups"] == 9,
          f"zamba2 launch spec {spec}")
    rec = dict(layers=cfg.n_layers,
               kernel_rows=kernel_phase(torch, dev, spec),
               gather_rows=gather_phase(torch, dev, dict(
                   spec, gather_cases=(("k bf16", "bfloat16",
                                        cfg.kv_size),))),
               attention_rows=variant_attention_rows(
                   torch, dev, cfg, ctx=SSM_S, depths=SSM_DEPTHS,
                   prefill=(len(SSM_LENGTHS), SSM_S)))
    params = _variant_params(torch, dev, cfg, 53)
    f32_leaves(params)
    rec["ssd_rows"] = ssd_rows(torch, dev, cfg, params)
    source = make_adapter_source(torch, dev, cfg)
    rec["route_check"] = route_check(
        torch, dev, cfg, params, spec, routes, lengths=SSM_LENGTHS, s=SSM_S,
        decode_steps=SSM_DECODE_STEPS, where="zamba2-2.7b bf16 (counted)",
        tol="count")
    serves(cfg, params, source, spec, rec)
    rec["refusals"] = refusals(cfg, params, source,
                               "weight-tied shared-attention ring")
    del params, source
    _release(torch)
    rec["f32"] = f32_checks(
        torch, dev, cfg, ZAMBA2_CARRY_LAYERS, 54,
        f"zamba2-2.7b ({ZAMBA2_CARRY_LAYERS} of 54 layers)")
    rec["seconds"] = time.perf_counter() - t0
    log(f"zamba2-2.7b {rec['seconds']:.1f}s")
    out["zamba2-2.7b"] = rec

    # ---- qwen1.5-110b, 16 of 80 layers -----------------------------------
    t0 = time.perf_counter()
    full = get_config("qwen1.5-110b")
    check(full.n_layers == 80 and full.d_model == 8192 and full.n_heads == 64
          and full.n_kv_heads == 8 and full.resolved_head_dim == 128
          and full.d_ff == 49152 and full.vocab_size == 152064
          and full.attn.qkv_bias and not full.tie_embeddings
          and full.lora.rank == 16 and len(full.lora.target_modules) == 7,
          "not the full qwen1.5-110b config")
    cfg = dataclasses.replace(full, n_layers=QWEN15_LAYERS,
                              lora=dataclasses.replace(
                                  full.lora,
                                  n_adapters=2 * full.lora.max_resident))
    log(f"qwen1.5-110b: full width, {QWEN15_LAYERS} of its {full.n_layers} "
        f"layers ({full.param_count() / 1e9:.1f}B params at full depth)")
    spec = variant_spec(cfg, cases=[
        ("decode", N_SLOTS), ("prefill", len(QWEN15_LENGTHS) * QWEN15_S)])
    check(_step_counts(spec) == (112, 16), f"qwen1.5 launch spec {spec}")
    rec = dict(layers=QWEN15_LAYERS, full_layers=full.n_layers,
               kernel_rows=kernel_phase(torch, dev, spec),
               gather_rows=gather_phase(torch, dev, dict(
                   spec, gather_cases=(("k bf16", "bfloat16",
                                        cfg.kv_size),))),
               attention_rows=variant_attention_rows(
                   torch, dev, cfg, ctx=QWEN15_S, depths=QWEN15_DEPTHS,
                   prefill=(len(QWEN15_LENGTHS), QWEN15_S)))
    params = _moe_params(torch, dev, cfg, 61)
    source = make_adapter_source(torch, dev, cfg)
    rec["route_check"] = route_check(
        torch, dev, cfg, params, spec, routes, lengths=QWEN15_LENGTHS,
        s=QWEN15_S, decode_steps=SSM_DECODE_STEPS,
        where=f"qwen1.5-110b bf16 ({QWEN15_LAYERS} of 80 layers)")
    serves(cfg, params, source, spec, rec)
    del params, source
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    log(f"qwen1.5-110b {rec['seconds']:.1f}s")
    out["qwen1.5-110b"] = rec
    return out


# ---------------------------------------------------------------------------
# phase 14: whisper-medium, the encoder-decoder family, at full depth
# ---------------------------------------------------------------------------

# route check prompts: 3 right-padded rows of a 64-token bucket, mixed
# adapters, over 1500 frames each; three decode steps
WHISPER_S, WHISPER_LENGTHS = 64, (64, 41, 17)
WHISPER_SLOTS = (3, 0, 5)
WHISPER_DECODE_STEPS = 3
# the decode kernel rows: 8 rows over a ring of whisper's 448-token
# decoder context, the last idle
WHISPER_CTX = 448
WHISPER_DEPTHS = (448, 400, 300, 200, 100, 20, 1, 0)
# the encoder's rows: 2 clips of 1500 frames
WHISPER_ENC_B = 2
# the LoRA train step: one clip, 64 tokens (+ the shifted target)
WHISPER_TRAIN_B, WHISPER_TRAIN_S = 1, 64
# kernel route against the plain one in bf16: attention kernels vs plain
# attention and sgmv vs einsum LoRA, held to 5e-2 of max|logit| (the
# issue's bound for this model; LayerNorm at every sublayer keeps the
# rounding from compounding); in f32, F32_ROUTE_TOL
WHISPER_BF16_TOL = 5e-2


def _whisper_params(torch, dev, cfg, seed):
    """The reference's init from a seeded generator on the card, then in
    place: every stacked weight [n_layers, d_in, d_out] rescaled from
    1/sqrt(n_layers) to fan-in scale 1/sqrt(d_in), LayerNorm scales and
    biases drawn around 1 and 0 (NORM_STD), the untied embedding to unit
    stddev (the reference draws it at 1/sqrt(vocab), next to sinusoidal
    positions of ~0.7: the tokens would hardly matter)."""
    from repro_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(seed)
    params = build_model(cfg, dev).init(gen)

    def walk(node):
        if "bias" in node and "scale" in node:          # a LayerNorm
            node["scale"].normal_(1.0, NORM_STD, generator=gen)
            node["bias"].normal_(0.0, NORM_STD, generator=gen)
            return
        for w in node.values():
            if isinstance(w, dict):
                walk(w)
            elif w.dim() == 3:
                w.mul_((w.shape[0] / w.shape[-2]) ** 0.5)

    with torch.no_grad():
        walk(params["encoder"])
        walk(params["decoder"])
        params["embed"].mul_(cfg.vocab_size ** 0.5)
    n = sum(p.numel() for p in _leaves(params))
    log(f"{cfg.name}: {cfg.encoder.n_layers} + {cfg.n_layers} layers, d "
        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads, hd "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
        f"{cfg.encoder.n_frames} frames: {n / 1e9:.3f}B params, "
        f"{cfg.dtype}")
    return params


def _whisper_calls(cfg):
    """Launches of each SGMV kernel per call (one per LoRA call): a
    prefill or forward runs the encoder's and the decoder's modules and
    the cross block's q and o every layer; a decode step the decoder's
    and the cross block's."""
    targets = set(cfg.lora.target_modules)
    mods = len(targets & {"q", "k", "v", "o", "up", "down"})
    cross = len(targets & {"q", "o"})
    return (cfg.encoder.n_layers * mods + cfg.n_layers * (mods + cross),
            cfg.n_layers * (mods + cross))


class _CausalProbe:
    """Counts ``ops.flash_prefill`` calls by their ``causal`` flag while
    active (each call goes on to the wrapper, which launches the kernel
    or raises): the encoder's non-causal calls apart from the decoder's
    causal ones."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.orig = ops, ops.flash_prefill
        self.calls = {True: 0, False: 0}

    def __enter__(self):
        def probe(*args, causal=True, **kw):
            self.calls[causal] += 1
            return self.orig(*args, causal=causal, **kw)
        self.ops.flash_prefill = probe
        return self

    def __exit__(self, *exc):
        self.ops.flash_prefill = self.orig


def whisper_route_check(torch, dev, cfg, params, *, tol, where):
    """``forward`` and a ``prefill`` of ``WHISPER_LENGTHS`` right-padded
    rows over 1500 frames each (per-row adapters from an 8-slot pool, B
    nonzero), then ``WHISPER_DECODE_STEPS`` decode steps (each route from
    the kernel route's cache and tokens), on the kernel route (attention
    kernels, SGMV) and the plain one (plain attention, einsum LoRA):
    logits within ``tol`` of max|logit|, top-1 equal on every live row
    whose margin clears it (``compare_logits``). Launches per call: on
    the kernel route 2 x 24 ``flash_prefill`` a forward or prefill (the
    encoder's 24 non-causal) and 24 ``flash_decode`` a decode step, each
    SGMV kernel once per LoRA call (``_whisper_calls``); nothing on the
    plain route."""
    from repro_torch.core.lora import LoRAMode
    from repro_torch.models import build_model

    gen = torch.Generator(device=dev).manual_seed(14)
    routes = {"kernels": ROUTES["kernels"], "plain": ROUTES["plain"]}
    models = {on: build_model(cfg, dev, attn_kernel=on)
              for on in {on for on, _ in routes.values()}}
    pool = models[True].init_lora(gen, n_slots=N_SLOTS)
    _draw_b(pool, gen)
    b, s = len(WHISPER_LENGTHS), WHISPER_S
    dt = models[True].dtype
    frames = torch.randn(b, cfg.encoder.n_frames, cfg.d_model,
                         generator=gen, device=dev).to(dt)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                           device=dev, dtype=torch.int32)
    lens = torch.tensor(WHISPER_LENGTHS, dtype=torch.int32, device=dev)
    sids = torch.tensor(WHISPER_SLOTS, dtype=torch.int32, device=dev)
    batch = {"tokens": tokens, "frames": frames}
    out, launches = {}, {}

    def run(route, label, fn):
        on, backend = routes[route]
        mode = LoRAMode("batched", sids, cfg.lora.scale, backend)
        before = _counts()
        with torch.no_grad(), _CausalProbe() as probe:
            res = fn(models[on], mode)
        torch.cuda.synchronize()
        got = {k: n - before[k] for k, n in _counts().items()}
        got["flash_prefill_noncausal"] = probe.calls[False]
        launches.setdefault(route, {})[label] = got
        return res

    t0 = time.perf_counter()
    cache0 = None
    for route in routes:
        logits, _ = run(route, "forward", lambda m, mode: m.forward(
            params, batch, pool, mode, attn_kernel=m.attn_kernel))
        out[("forward", route)] = logits.float().reshape(b * s, -1)
        logits, cache = run(route, "prefill", lambda m, mode: m.prefill(
            params, batch, m.init_cache(b, s + WHISPER_DECODE_STEPS), pool,
            mode, lengths=lens))
        out[("prefill", route)] = logits.float()
        if route == "kernels":
            cache0 = cache
        del cache
    nxt, pos = out[("prefill", "kernels")].argmax(-1).int(), lens.clone()
    for i in range(WHISPER_DECODE_STEPS):
        nxt_cache = None
        for route in routes:
            logits, cache = run(route, f"decode{i}", lambda m, mode:
                                m.decode_step(params, nxt,
                                              _clone_cache(cache0), pos,
                                              pool, mode))
            out[(f"decode{i}", route)] = logits.float()
            if route == "kernels":
                nxt_cache = cache
            del cache
        cache0 = nxt_cache
        nxt, pos = out[(f"decode{i}", "kernels")].argmax(-1).int(), pos + 1
    seconds = time.perf_counter() - t0
    full, step = _whisper_calls(cfg)
    nl = cfg.n_layers
    for route, calls in launches.items():
        for label, got in calls.items():
            want = dict.fromkeys(got, 0)
            if route == "kernels":
                want["sgmv_shrink"] = want["sgmv_expand"] = (
                    step if label.startswith("decode") else full)
                if label.startswith("decode"):
                    want["flash_decode"] = nl
                else:
                    want["flash_prefill"] = cfg.encoder.n_layers + nl
                    want["flash_prefill_noncausal"] = cfg.encoder.n_layers
            check(got == want, f"{where}: {route} {label} launched {got}, "
                  f"want {want}")
    res = dict(seconds=seconds, launches=launches["kernels"])
    live = (torch.arange(s, device=dev)[None, :] < lens[:, None]).reshape(-1)
    for step_name in ["forward", "prefill"] + [
            f"decode{i}" for i in range(WHISPER_DECODE_STEPS)]:
        res[f"{step_name}_vs_plain"] = compare_logits(
            torch, f"{where} {step_name}, kernels vs plain",
            out[(step_name, "kernels")], out[(step_name, "plain")],
            live if step_name == "forward" else
            torch.ones(b, dtype=torch.bool, device=dev), tol)
    del models, pool, cache0, out
    _release(torch)
    return res


def whisper_plain_rows(torch, dev, cfg, params):
    """Whisper's plain-PyTorch work beside its bound, bf16, without LoRA
    (CUDA events, L2 flushed): ``encode`` of ``WHISPER_ENC_B`` clips of
    1500 frames on the kernel route (the encoder's ``flash_prefill``
    non-causal) and the plain one; one decoder layer's
    ``cross_attention`` (q and o projections, scores and softmax over
    1500 frames) at a prefill (the route check's 3 rows x 64 tokens) and
    at a decode step of 8 rows, with SDPA over the same q, K and V (the
    attention core alone) as a yardstick. Bounds: GEMMs and attention
    products at the bf16 peak, or the weights, K/V and activations moved
    once over the HBM rate, the larger."""
    import torch.nn.functional as F

    from repro_torch.models import attention as attn_lib
    from repro_torch.models import encdec
    from repro_torch.models.transformer import group_view

    gen = torch.Generator(device=dev).manual_seed(44)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device=dev)
    bf = torch.bfloat16
    d, q_size, kv = cfg.d_model, cfg.q_size, cfg.kv_size
    h, kh, hd, dff = (cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim,
                      cfg.d_ff)
    ne, t = cfg.encoder.n_layers, cfg.encoder.n_frames
    rows = []
    with torch.no_grad():
        b = WHISPER_ENC_B
        frames = torch.randn(b, t, d, generator=gen, device=dev).to(bf)
        layer_w = d * q_size + 2 * d * kv + q_size * d + 2 * d * dff
        gemm = 2.0 * b * t * layer_w * ne
        attn_ops = 4.0 * b * h * hd * t * t * ne
        nbytes = 2 * (ne * (layer_w + 4 * d) + 2 * b * t * d)
        bnd, by = bound_ms(nbytes, gemm + attn_ops, "bfloat16")
        for on in (True, False):
            def enc(on=on):
                return encdec.encode(params["encoder"], frames, cfg,
                                     attn_kernel=on)
            out = enc()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out.float()).all()),
                  "whisper encode: non-finite states")
            rows.append(dict(
                function="encode", model=cfg.name,
                route="flash_prefill non-causal" if on else "plain",
                shape=f"frames [{b},{t},{d}] bf16, {ne} layers, no LoRA",
                ms=cuda_ms(torch, enc, flush, iters=5, warm=1),
                bound_ms=bnd, bound_by=by, gemm_flops=gemm,
                attention_flops=attn_ops, bytes=nbytes))
        del frames, out
        lp = group_view(params["decoder"]["layers"], 0)
        cross = lp["cross"]
        for label, rb, s in (("prefill", len(WHISPER_LENGTHS), WHISPER_S),
                             ("decode", N_SLOTS, 1)):
            enc_out = torch.randn(rb, t, d, generator=gen, device=dev).to(bf)
            k, v = attn_lib.encode_cross_kv(cross, enc_out, cfg)
            x = torch.randn(rb, s, d, generator=gen, device=dev).to(bf)

            def call():
                return attn_lib.cross_attention(cross, x, (k, v), cfg)

            y = call()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(y.float()).all()),
                  f"whisper cross attention {label}: non-finite")
            flops = (2.0 * rb * s * 2 * d * q_size
                     + 4.0 * rb * h * hd * s * t)
            nbytes = 2 * (2 * d * q_size + 2 * rb * t * kv + 2 * rb * s * d)
            bnd, by = bound_ms(nbytes, flops, "bfloat16")
            qh = torch.randn(rb, h, s, hd, generator=gen, device=dev).to(bf)
            kl, vl = (z.transpose(1, 2).contiguous() for z in (k, v))
            rows.append(dict(
                function="cross_attention", model=cfg.name, case=label,
                shape=f"x [{rb},{s},{d}] over K/V [{rb},{t},{kh},{hd}] bf16,"
                      " one layer, no LoRA",
                ms=cuda_ms(torch, call, flush),
                host_us=enqueue_us(torch, call),
                bound_ms=bnd, bound_by=by, flops=flops, bytes=nbytes,
                step_layers=cfg.n_layers,
                sdpa_core_ms=cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qh, kl, vl, enable_gqa=True), flush)))
            del enc_out, k, v, x, y, qh, kl, vl
    for r in rows:
        log(f"{r['function']} " + json.dumps(r))
    _release(torch)
    return rows


def whisper_train_step(torch, dev, cfg, params):
    """Two LoRA train steps (one adapter, B nonzero; ``WHISPER_TRAIN_B``
    clips of 1500 frames, ``WHISPER_TRAIN_S`` tokens): autograd through
    ``Model.forward(..., attn_kernel=False)``, so no kernel launches.
    Loss and grad norm finite (the norm nonzero), the base untouched;
    host ms of the second step to its loss on the host, peak device
    memory over both."""
    from repro_torch.models import build_model
    from repro_torch.training import optimizer, train

    gen = torch.Generator(device=dev).manual_seed(15)
    model = build_model(cfg, dev)
    lora = model.init_lora(gen)
    _draw_b(lora, gen)
    batch = {"tokens": torch.randint(
        0, cfg.vocab_size, (WHISPER_TRAIN_B, WHISPER_TRAIN_S + 1),
        generator=gen, device=dev, dtype=torch.int32),
        "frames": torch.randn(WHISPER_TRAIN_B, cfg.encoder.n_frames,
                              cfg.d_model, generator=gen,
                              device=dev).to(model.dtype)}
    step = train.make_train_step(model, peak_lr=1e-3, warmup=1,
                                 total_steps=4)
    state = train.TrainState(params, lora, optimizer.adamw_init(lora))
    w0 = params["decoder"]["layers"]["attn"]["wq"][0, 0, :8].clone()
    _release(torch)
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    res = dict(batch=WHISPER_TRAIN_B, tokens=WHISPER_TRAIN_S, steps=[])
    for _ in range(2):
        t0 = time.perf_counter()
        state, met = step(state, batch)
        loss, gnorm = float(met["loss"]), float(met["grad_norm"])
        res["steps"].append(dict(loss=loss, grad_norm=gnorm,
                                 ms=1e3 * (time.perf_counter() - t0)))
        check(loss == loss and abs(loss) < 1e9 and 0 < gnorm < 1e9,
              f"whisper train step: loss {loss}, grad norm {gnorm}")
    res["ms"] = res["steps"][-1]["ms"]
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    res["launches"] = _counts()
    check(not any(res["launches"].values()),
          f"whisper train step launched kernels: {res['launches']}")
    check(torch.equal(w0, params["decoder"]["layers"]["attn"]["wq"][0, 0, :8]),
          "whisper train step moved a base weight")
    log("whisper-medium LoRA train step: " + json.dumps(res))
    del model, state, lora, batch
    _release(torch)
    return res


def whisper_phase(torch, dev):
    """Phase 14 (see the module docstring). Returns its record keyed by
    model, as phases 11-13's: kernel rows at whisper's shapes, route
    checks (bf16 and f32) with their launches, the plain rows, the
    train step, the engine's refusal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving.engine import EdgeLoRAEngine, EngineConfig

    t0 = time.perf_counter()
    cfg = get_config("whisper-medium")
    check(cfg.n_layers == 24 and cfg.encoder.n_layers == 24
          and cfg.encoder.n_frames == 1500 and cfg.d_model == 1024
          and cfg.n_heads == 16 and cfg.n_kv_heads == 16
          and cfg.resolved_head_dim == 64 and cfg.d_ff == 4096
          and not cfg.glu and cfg.act == "gelu" and not cfg.attn.rope
          and cfg.vocab_size == 51865 and cfg.lora.rank == 16
          and cfg.lora.target_modules == ("q", "v", "o", "up", "down"),
          "not the full whisper-medium config")
    check(_whisper_calls(cfg) == (288, 168),
          f"whisper SGMV calls {_whisper_calls(cfg)}")
    spec = variant_spec(cfg, cases=[
        ("decode", N_SLOTS), ("prefill", WHISPER_ENC_B * cfg.encoder.n_frames)])
    rec = dict(layers=(cfg.encoder.n_layers, cfg.n_layers),
               kernel_rows=kernel_phase(torch, dev, spec),
               attention_rows=variant_attention_rows(
                   torch, dev, cfg, ctx=WHISPER_CTX, depths=WHISPER_DEPTHS,
                   prefill=(WHISPER_ENC_B, cfg.encoder.n_frames),
                   causal=False))
    try:
        EdgeLoRAEngine(cfg, EngineConfig(), device=dev)
    except NotImplementedError as e:
        rec["engine_refusal"] = str(e)
    check("also needs 'frames'" in rec.get("engine_refusal", ""),
          f"whisper: the engine did not refuse it: {rec}")
    params = _whisper_params(torch, dev, cfg, 71)
    rec["params"] = sum(p.numel() for p in _leaves(params))
    _reset_counts()
    rec["route_check"] = whisper_route_check(
        torch, dev, cfg, params, tol=WHISPER_BF16_TOL,
        where="whisper-medium bf16")
    f32 = dataclasses.replace(cfg, dtype="float32")
    p32 = _cast_tree(torch, params, torch.float32)
    rec["route_check_f32"] = whisper_route_check(
        torch, dev, f32, p32, tol=F32_ROUTE_TOL,
        where="whisper-medium f32")
    rec["launches"] = _counts()
    for name in ("sgmv_shrink", "sgmv_expand", "flash_prefill",
                 "flash_decode"):
        check(rec["launches"][name] > 0,
              f"whisper: {name} never launched on its path")
    del p32
    _release(torch)
    rec["plain_rows"] = whisper_plain_rows(torch, dev, cfg, params)
    rec["train_step"] = whisper_train_step(torch, dev, cfg, params)
    del params
    _release(torch)
    rec["seconds"] = time.perf_counter() - t0
    log(f"whisper-medium {rec['seconds']:.1f}s")
    return {"whisper-medium": rec}


# ---------------------------------------------------------------------------
# phase 15: the train step's remat at full width and depth, the dry-run's
# counts against the card, and the dry-run at full depth on the fake
# 16x16 mesh
# ---------------------------------------------------------------------------

# llama3-8b LoRA train step, B 1: the longest of these S at which the step
# without remat fits; remat runs at that S and, if it was cut, at 4096
# (the dry-run's train_4k length)
REMAT_SEQS = (4096, 2048, 1024)
# warm steps timed at each S (their median is recorded)
REMAT_TIMED = 3
# remat on vs off, if not bit-equal: relative to max|value|
REMAT_TOL = 1e-6
# qwen2-0.5b steps the dry-run's counts are held at: prefill [B, S] and a
# decode step of B rows over a ring of COUNT_DECODE_CTX
COUNT_PREFILL = (8, 512)
COUNT_DECODE_CTX = 4096
# the fake-mesh arguments' bytes against the card's allocation growth
ARG_BYTES_TOL = 0.01
# decode_32k at full depth on the fake 16x16 mesh: the archs the card
# runs at partial depth (phases 12 and 13)
DRYRUN_ARCHS = ("dbrx_132b", "llama4_maverick_400b_a17b", "qwen1_5_110b")
DRYRUN_SHAPE = "decode_32k"
# phase 15's wall budget: (c) keeps its first arch, and runs the next only
# while the phase stays inside it at the trace time a layer the archs
# before it took
PHASE15_BUDGET_S = 90.0


def dryrun_phase(phase_started):
    """Phase 15(c): each arch's decode_32k combo at full depth on the fake
    16x16 mesh, in this process (CPU only: fake tensors on a fake process
    group), must be ``ok``; per arch its args/dev, dominant term, the
    share of its collective bytes from the replicate fallback, and trace
    seconds. After the first arch, an arch whose trace would take phase
    15 past PHASE15_BUDGET_S (at the seconds a layer the archs before it
    took) is skipped and recorded so."""
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun

    res, skipped, traced_s, traced_layers = {}, [], 0.0, 0
    for arch in DRYRUN_ARCHS:
        spent = time.perf_counter() - phase_started
        layers = get_config(arch).n_layers
        if res and spent + traced_s / traced_layers * layers > (
                PHASE15_BUDGET_S):
            skipped.append(arch)
            continue
        r = dryrun.run_combo(arch, DRYRUN_SHAPE, save=False, verbose=False)
        check(r["status"] == "ok", f"dry-run {arch}: {r}")
        traced_s += r["trace_s"]
        traced_layers += layers
        res[arch] = dict(
            args_per_device_gb=r["arg_bytes_per_device"] / 1e9,
            dominant=r["dominant"],
            dominant_without_fallback=r["dominant_without_fallback"],
            collective_fallback_share=r["collective_fallback_share"],
            trace_s=r["trace_s"], roofline=r["roofline"], flops=r["flops"],
            hbm_bytes=r["hbm_bytes"],
            collective_bytes=r["collectives"]["total"],
            replicated_ops=r["replicated_ops"], torch=r["torch"])
        log(f"dry-run {arch} x {DRYRUN_SHAPE} x 16x16 (full depth, torch "
            f"{r['torch']}): args/dev "
            f"{res[arch]['args_per_device_gb']:.2f} GB, dominant "
            f"{r['dominant']} ({r['dominant_without_fallback']} without "
            f"the fallback's {100 * r['collective_fallback_share']:.1f} % "
            f"of the collective bytes), trace {r['trace_s']:.1f}s")
    if skipped:
        log(f"dry-run: {skipped} skipped, phase 15 at "
            f"{time.perf_counter() - phase_started:.1f}s of its "
            f"{PHASE15_BUDGET_S:.0f}s")
    res["skipped"] = skipped
    return res


def _tree_equal(torch, a, b):
    from repro_torch.training.optimizer import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a),
                                                 tree_leaves(b)))


def _tree_rel_err(torch, a, b):
    from repro_torch.training.optimizer import tree_leaves
    return max(float((x.double() - y.double()).abs().max())
               / max(float(y.double().abs().max()), 1e-30)
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def remat_rows(torch, dev):
    """Phase 15(a): llama3-8b LoRA train steps (all 32 layers, B 1) on the
    same inputs with remat off and on, at the longest of REMAT_SEQS the
    step without remat fits: loss, grad norm, the AdamW moments and the
    updated adapter equal (bit for bit, else within REMAT_TOL, recorded),
    peak memory and the median warm ms of each; one remat step at
    REMAT_SEQS[0] if that S was cut."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import optimizer, train

    cfg = get_config("llama3-8b")
    check(cfg.n_layers == 32 and cfg.d_model == 4096,
          "not the full llama3-8b config")
    gen = torch.Generator(device=dev).manual_seed(15)
    model = build_model(cfg, dev)
    params = model.init(gen)
    prepare_weights(torch, cfg, params, gen)
    lora = model.init_lora(gen)
    _draw_b(lora, gen)
    tokens = torch.randint(0, DATA_VOCAB, (1, REMAT_SEQS[0] + 1),
                           generator=gen, device=dev, dtype=torch.int32)
    def step(s, remat):
        """The step 1 + REMAT_TIMED times on the same state and batch (the
        first call sets up cuBLAS and checkpointing and grows the
        allocator's pool: seconds); the median ms of the timed calls,
        peak memory over all."""
        fn = train.make_train_step(model, remat=remat, peak_lr=1e-3,
                                   warmup=1, total_steps=4)
        state = train.TrainState(params, lora, optimizer.adamw_init(lora))
        batch = {"tokens": tokens[:, :s + 1]}
        _release(torch)
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        fn(state, batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(REMAT_TIMED):
            t0 = time.perf_counter()
            new, met = fn(state, batch)
            loss = float(met["loss"])
            times.append(1e3 * (time.perf_counter() - t0))
        row = dict(seq=s, remat=remat, loss=loss,
                   grad_norm=float(met["grad_norm"]),
                   ms=statistics.median(times), ms_all=times,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   launches=_counts())
        check(loss == loss and 0 < row["grad_norm"] < 1e9,
              f"remat step {row}")
        check(not any(row["launches"].values()),
              f"a train step launched kernels: {row['launches']}")
        return new, met, row

    res = dict(rows=[], oom=[])
    for s in REMAT_SEQS:
        try:
            off = step(s, False)
            break
        except torch.cuda.OutOfMemoryError:
            res["oom"].append(s)
            _release(torch)
    else:
        raise RuntimeError("chip_smoke: no llama3-8b train step without "
                           f"remat fits at S in {REMAT_SEQS}")
    on = step(off[2]["seq"], True)
    res["rows"] += [off[2], on[2]]
    bit = (torch.equal(off[1]["loss"], on[1]["loss"])
           and torch.equal(off[1]["grad_norm"], on[1]["grad_norm"])
           and _tree_equal(torch, off[0].lora, on[0].lora)
           and _tree_equal(torch, off[0].opt.mu, on[0].opt.mu)
           and _tree_equal(torch, off[0].opt.nu, on[0].opt.nu))
    res["bit_equal"] = bit
    if not bit:
        res["rel_err"] = max(
            _tree_rel_err(torch, off[0].lora, on[0].lora),
            _tree_rel_err(torch, off[0].opt.mu, on[0].opt.mu),
            _tree_rel_err(torch, off[0].opt.nu, on[0].opt.nu),
            abs(on[2]["loss"] - off[2]["loss"]) / abs(off[2]["loss"]),
            abs(on[2]["grad_norm"] - off[2]["grad_norm"])
            / off[2]["grad_norm"])
        check(res["rel_err"] <= REMAT_TOL,
              f"remat on vs off: {res['rel_err']} > {REMAT_TOL}")
    del off, on
    if res["rows"][0]["seq"] != REMAT_SEQS[0]:
        res["rows"].append(step(REMAT_SEQS[0], True)[2])
    for r in res["rows"]:
        log(f"llama3-8b LoRA train step S={r['seq']} remat={r['remat']}: "
            f"{r['ms']:.1f} ms, peak {r['peak_gb']:.2f} GB, loss "
            f"{r['loss']:.4f}, grad norm {r['grad_norm']:.4f}")
    log(f"remat on vs off: {'bit-equal' if bit else res.get('rel_err')}; "
        f"without remat out of memory at S {res['oom']}")
    del model, params, lora, tokens
    _release(torch)
    return res


def count_rows(torch, dev):
    """Phase 15(b): qwen2-0.5b (full width and depth, bf16, plain route)
    prefill [8, 512] and a decode step over a 4096 ring. The dry-run's
    arguments on a one-rank fake mesh against the card's allocation
    growth for the same arguments (within ARG_BYTES_TOL); ``step_cost``
    on the card's tensors equal to ``step_cost`` on fake copies; each
    step's device time at least its largest one-GPU roofline term."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map

    from repro_torch.configs import InputShape, get_config
    from repro_torch.core.lora import LoRAMode
    from repro_torch.launch import dryrun, mesh as M
    from repro_torch.launch.analysis import step_cost
    from repro_torch.models import build_model

    cfg = get_config("qwen2-0.5b")
    check(cfg.n_layers == 24 and cfg.d_model == 896,
          "not the full qwen2-0.5b config")
    b, s = COUNT_PREFILL
    shapes = {"prefill": InputShape("prefill", s, b, "prefill"),
              "decode": InputShape("decode", COUNT_DECODE_CTX, b, "decode")}
    mesh = M.make_mesh((1, 1), ("data", "model"))
    try:
        with dryrun.traced(mesh) as rec:
            with rec["fake"]:
                fake = {k: dryrun.input_specs(cfg, sh, mesh)
                        for k, sh in shapes.items()}
            predicted = {k: dryrun._arg_bytes_per_device(kw, mesh)
                         for k, (_, kw) in fake.items()}
    finally:
        M.release_mesh()
    del fake

    gen = torch.Generator(device=dev).manual_seed(151)
    model = build_model(cfg, dev)
    _release(torch)
    base = torch.cuda.memory_allocated()
    params = model.init(gen)
    pool = model.init_lora(gen, n_slots=cfg.lora.max_resident,
                           dtype=torch.bfloat16)
    shared = torch.cuda.memory_allocated() - base
    prepare_weights(torch, cfg, params, gen)
    _draw_b(pool, gen)
    sc = cfg.lora.scale

    def run(*a, kind):
        mode = LoRAMode("batched", a[-1], sc, "einsum")
        if kind == "prefill":
            return model.prefill(a[0], a[2], a[3], a[1], mode)
        return model.decode_step(a[0], a[2], a[3], a[4], a[1], mode)

    res = {}
    for kind, sh in shapes.items():
        before = torch.cuda.memory_allocated()
        cache = model.init_cache(b, sh.seq_len)
        slots = torch.arange(b, device=dev, dtype=torch.int32) % (
            cfg.lora.max_resident)
        if kind == "prefill":
            tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                   device=dev, dtype=torch.int32)
            args = (params, pool, {"tokens": tokens}, cache, slots)
        else:
            tokens = torch.randint(0, cfg.vocab_size, (b,), generator=gen,
                                   device=dev, dtype=torch.int32)
            pos = torch.full((b,), sh.seq_len - 1, device=dev,
                             dtype=torch.int32)
            args = (params, pool, tokens, cache, pos, slots)
        grown = shared + torch.cuda.memory_allocated() - before
        row = dict(kind=kind, shape=[b, sh.seq_len], arg_bytes=grown,
                   predicted_arg_bytes=predicted[kind])
        check(abs(predicted[kind] - grown) <= ARG_BYTES_TOL * grown,
              f"{kind}: the dry-run's {predicted[kind]} argument bytes vs "
              f"{grown} allocated")
        with torch.no_grad():
            real = step_cost(run, *args, kind=kind)
            # the step's own small tensors (positions, masks) are real:
            # let them meet the fake ones
            with FakeTensorMode(allow_non_fake_inputs=True) as fm:
                fargs = tree_map(fm.from_tensor, args)
            fcount = step_cost(run, *fargs, kind=kind)
            for key in ("mxu_flops", "vpu_flops", "bytes"):
                check(real[key] == fcount[key],
                      f"{kind}: step_cost {key} on the card {real[key]} vs "
                      f"fake {fcount[key]}")
            for _ in range(2):
                run(*args, kind=kind)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(5):
                run(*args, kind=kind)
            end.record()
            torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 5
        terms = M.roofline_terms(real["mxu_flops"], real["bytes"], 0.0, 1)
        top = max(terms, key=terms.get)
        row.update(mxu_flops=real["mxu_flops"], vpu_flops=real["vpu_flops"],
                   bytes=real["bytes"], ms=ms, roofline=terms,
                   largest_term=top, largest_term_ms=1e3 * terms[top])
        check(ms >= 1e3 * terms[top],
              f"{kind}: {ms} ms is below its roofline term {terms}")
        log(f"qwen2-0.5b {kind} {row['shape']}: {ms:.2f} ms against its "
            f"{top} {1e3 * terms[top]:.3f} ms; args {grown / 1e9:.3f} GB "
            f"allocated, {predicted[kind] / 1e9:.3f} GB from the dry-run; "
            f"step_cost equal on the card and fake ({real['mxu_flops']:.3e} "
            f"matmul flops, {real['bytes']:.3e} bytes)")
        res[kind] = row
        del args, cache, tokens, fargs
    del model, params, pool
    _release(torch)
    return res


def distributed_phase(torch, dev):
    """Phase 15 (see the module docstring). Returns its record."""
    t0 = time.perf_counter()
    rec = dict(remat=remat_rows(torch, dev), counts=count_rows(torch, dev))
    _release(torch)
    rec["dryrun"] = dryrun_phase(t0)
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 15 {rec['seconds']:.1f}s")
    return rec


# ---------------------------------------------------------------------------
# phase 16: the repo's examples on the card (examples/*_torch.py)
# ---------------------------------------------------------------------------

EXAMPLES = ("quickstart_torch.py", "serve_multitenant_torch.py",
            "serve_ssm_long_context_torch.py", "train_lora_adapter_torch.py")
# an example as written, in a child process on the card; the child's
# launch counts (zero at its start) after the script, on a line of their
# own
_EXAMPLE = """
import json, runpy, sys
sys.path.insert(0, {src!r})
sys.argv = [{script!r}, "--device", "cuda"]
runpy.run_path({script!r}, run_name="__main__")
from repro_torch.kernels import decode_attention, flash_prefill, paged_gather, sgmv
counts = {{}}
for mod in (sgmv, paged_gather, decode_attention, flash_prefill):
    counts.update(mod.launches)
print("LAUNCHES:" + json.dumps(counts))
"""
# batched vs per-request on the kernel route, f32, the example's reduced
# size on fan-in weights: the same sums per row in another order (GEMMs
# of 64 and 16 rows), within 1e-5 of max|logit|
QUICKSTART_F32_TOL = 1e-5


def _example_module(name):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        name[:-3], ROOT / "examples" / name)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example_figures(name, out):
    """The key figures an example prints."""
    import re
    lines = out.splitlines()
    if name == "quickstart_torch.py":
        return dict(max_err=float(re.search(r"max err (\S+)", out)[1]),
                    decoded=next(l for l in lines if l.startswith("decoded")))
    if name == "serve_multitenant_torch.py":
        return dict(rows=[l for l in lines if l.split()[:1] in (
            ["edgelora"], ["edgelora_no_aas"], ["llamacpp"])])
    if name == "serve_ssm_long_context_torch.py":
        return dict(serve=lines[0], state=next(
            l for l in lines if l.startswith("decode state")))
    evals = {(int(t), int(a)): (float(la), float(base)) for t, a, la, base in
             re.findall(r"task (\d): adapter(\d) (\S+) vs base (\S+)", out)}
    # the logged train losses, task 0's then task 1's
    losses = [float(x) for x in re.findall(r"loss (\S+)  gnorm", out)]
    half = len(losses) // 2
    acc, chance = re.search(r"accuracy: (\S+) \(chance (\S+)\)", out).groups()
    return dict(evals={f"task{t}_adapter{a}": v for (t, a), v in
                       evals.items()},
                losses=[losses[:half], losses[half:]],
                router_acc=float(acc), chance=float(chance),
                verified=out.count("and verified"))


def _check_example(name, rc, out, err, launches):
    check(rc == 0, f"examples/{name} exited {rc}: {err[-2000:]}")
    figures = _example_figures(name, out)
    attn = ("flash_prefill", "flash_decode")
    if name == "quickstart_torch.py":
        # reduced: 2 layers x 5 LoRA modules a call; the forward, 4
        # per-request forwards, the prefill and 8 decode steps
        want = dict(sgmv_shrink=140, sgmv_expand=140, flash_prefill=12,
                    flash_decode=16, paged_gather_pages=0)
        check(launches == want, f"{name}: launches {launches} != {want}")
    elif name == "serve_multitenant_torch.py":
        check(all(launches[k] > 0 for k in ("sgmv_shrink", "sgmv_expand",
                                            *attn)),
              f"{name}: a kernel of the serve never launched: {launches}")
        check(len(figures["rows"]) == 3 and "OOM" in figures["rows"][2],
              f"{name}: rows {figures['rows']}")
    elif name == "serve_ssm_long_context_torch.py":
        # attention-free: the LoRA pair on in_proj/out_proj only
        check(launches["sgmv_shrink"] > 0 and launches["sgmv_expand"] > 0
              and not any(launches[k] for k in attn),
              f"{name}: launches {launches}")
        check("72.1 KB" in figures["state"], figures["state"])
    else:
        # the evaluation and the router's trunk run flash_prefill; the
        # train steps the plain route; single-adapter LoRA is einsum
        check(launches["flash_prefill"] > 0 and not any(
            launches[k] for k in ("sgmv_shrink", "sgmv_expand",
                                  "flash_decode")),
              f"{name}: launches {launches}")
        check(figures["verified"] == 2, f"{name}: checkpoints")
        for task in (0, 1):
            own, base = figures["evals"][f"task{task}_adapter{task}"]
            other, _ = figures["evals"][f"task{task}_adapter{1 - task}"]
            check(own < base <= other,
                  f"{name}: task {task}: own adapter {own}, base {base}, "
                  f"other adapter {other}")
    return figures


def quickstart_full(torch, dev, qs):
    """(b) The quickstart's body at Llama-3.1-8B's full width and depth
    (bf16; fan-in weights; rank-32 adapters with nonzero B, one per slot)
    on the kernel route and the plain route; then in f32 at the example's
    reduced size, on its own weights and on fan-in ones."""
    import dataclasses

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.core.lora import load_adapter_into_slot
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_map
    cfg = get_config("llama3-8b")
    model = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(16)
    params = model.init(gen)
    prepare_weights(torch, cfg, params, gen)
    pool = model.init_lora(gen, n_slots=4)
    source = make_adapter_source(torch, dev, cfg)
    for slot in range(4):
        load_adapter_into_slot(tree_map(lambda t: t.movedim(1, 0), pool),
                               source(slot), slot)
    tokens = torch.randint(0, cfg.vocab_size, (4, 16), generator=gen,
                           device=dev, dtype=torch.int32)
    calls = 1 + 4 + 1 + 8           # forward, per-request, prefill, decode
    routes = {}
    for route, kernel, backend in (("kernel", True, "sgmv"),
                                   ("plain", False, "einsum")):
        model.attn_kernel = kernel
        torch.cuda.synchronize()
        _reset_counts()
        t0 = time.perf_counter()
        res = qs.run(model, params, pool, tokens, backend=backend)
        torch.cuda.synchronize()
        launches = _counts()
        peak = float(res["logits"].float().abs().max())
        routes[route] = dict(rel_err=res["max_err"] / peak,
                             max_err=res["max_err"], max_logit=peak,
                             decoded=res["decoded"], launches=launches,
                             seconds=time.perf_counter() - t0)
        want = (dict(sgmv_shrink=160 * calls, sgmv_expand=160 * calls,
                     flash_prefill=32 * 6, flash_decode=32 * 8,
                     paged_gather_pages=0) if kernel
                else {k: 0 for k in launches})
        check(launches == want, f"quickstart full {route}: launches "
              f"{launches} != {want}")
        check(res["logits"].isfinite().all().item(),
              f"quickstart full {route}: non-finite logits")
    same = sum(a == b for ra, rb in zip(routes["kernel"]["decoded"],
                                        routes["plain"]["decoded"])
               for a, b in zip(ra, rb))
    del model, params, pool
    _release(torch)
    # f32 at the reduced size: batched vs per-request on each route, on
    # the example's own weights and on fan-in ones. The example's (the
    # reference's init, stddev 1/sqrt(n_groups), and its shifted
    # adapters at LoRA scale 16) drive attention scores to ~3000: there a
    # relative perturbation of one f32 ulp (2^-24) of the params moves
    # the logits by ~3e-5 of max|logit| (measured here, kernel route), so
    # two summation orders (a GEMM of 64 rows and one of 16) differ by as
    # much; recorded beside it. Held to QUICKSTART_F32_TOL on fan-in
    # weights (prepare_weights) with B ~ N(0, B_STD^2) adapters.
    cfg32 = dataclasses.replace(reduced_config(get_config("llama3-8b")),
                                dtype="float32")
    f32 = {}
    for weights in ("example", "fan_in"):
        for route, kernel in (("kernel", True), ("plain", False)):
            m = build_model(cfg32, dev, attn_kernel=kernel)
            if weights == "example":
                params, pool, tokens = qs.draw(m)
            else:
                gen = torch.Generator(device=dev).manual_seed(18)
                params = m.init(gen)
                prepare_weights(torch, cfg32, params, gen)
                pool = m.init_lora(gen, n_slots=4)
                source = make_adapter_source(torch, dev, cfg32)
                for slot in range(4):
                    load_adapter_into_slot(
                        tree_map(lambda t: t.movedim(1, 0), pool),
                        source(slot), slot)
                tokens = torch.randint(0, cfg32.vocab_size, (4, 16),
                                       generator=gen, device=dev,
                                       dtype=torch.int32)
            backend = "sgmv" if kernel else "einsum"
            res = qs.run(m, params, pool, tokens, backend=backend)
            peak = float(res["logits"].abs().max())
            row = dict(rel_err=res["max_err"] / peak)
            if kernel:
                gen = torch.Generator(device=dev).manual_seed(19)
                moved = tree_map(lambda t: t * (1 + 2.0 ** -24 * torch.randn(
                    t.shape, generator=gen, device=dev)), params)
                again = qs.run(m, moved, pool, tokens, backend=backend)
                row["ulp_sensitivity"] = float(
                    (again["logits"] - res["logits"]).abs().max()) / peak
            f32[f"{weights}_{route}"] = row
    check(f32["fan_in_kernel"]["rel_err"] <= QUICKSTART_F32_TOL,
          f"quickstart f32 kernel route, fan-in weights: batched vs "
          f"per-request {f32['fan_in_kernel']['rel_err']:.3g} of "
          f"max|logit| > {QUICKSTART_F32_TOL}")
    log(f"quickstart full width: batched vs per-request "
        f"{routes['kernel']['rel_err']:.3g} (kernel) / "
        f"{routes['plain']['rel_err']:.3g} (plain) of max|logit|; "
        f"{same}/32 decoded tokens equal across routes; f32 reduced "
        f"{json.dumps(f32)}")
    return dict(routes=routes, decoded_equal=same, f32_rel_err=f32)


def ssm_full(torch, dev, ssm_ex):
    """(c) mamba2-130m at full width and depth: the decode state's bytes
    (equal for a 64 and a 524288-token context) and one decode step at
    each of the example's positions, the state carried."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training.optimizer import tree_leaves
    cfg = get_config("mamba2-130m")
    model = build_model(cfg, dev, attn_kernel=True)
    gen = torch.Generator(device=dev).manual_seed(17)
    params = model.init(gen)
    prepare_weights(torch, cfg, params, gen)

    def nbytes(ctx):
        return sum(t.numel() * t.element_size()
                   for t in tree_leaves(model.init_cache(1, ctx)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, logits = ssm_ex.long_context(model, params)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    check(state == nbytes(64) == nbytes(524288),
          f"mamba2 state {state} B depends on the context")
    for pos, lg in zip(ssm_ex.POSITIONS, logits):
        check(tuple(lg.shape) == (1, cfg.vocab_size)
              and lg.isfinite().all().item(),
              f"mamba2 decode at {pos}: {tuple(lg.shape)}")
    return dict(state_bytes=state, positions=list(ssm_ex.POSITIONS),
                seconds=seconds,
                max_logit=[float(lg.float().abs().max()) for lg in logits])


def examples_phase(torch, dev):
    """Phase 16 (see the module docstring). Returns its record."""
    t0 = time.perf_counter()
    procs = {}
    for name in EXAMPLES:
        procs[name] = (time.perf_counter(), subprocess.Popen(
            [sys.executable, "-c", _EXAMPLE.format(
                src=str(SRC), script=f"examples/{name}")], cwd=ROOT,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    rec = dict(quickstart_full=quickstart_full(
        torch, dev, _example_module("quickstart_torch.py")))
    rec["mamba2_full"] = ssm_full(
        torch, dev, _example_module("serve_ssm_long_context_torch.py"))
    _release(torch)
    runs = {}
    try:
        for name, (start, proc) in procs.items():
            out, err = proc.communicate(timeout=600)
            seconds = time.perf_counter() - start
            lines = out.splitlines()
            launches = (json.loads(lines[-1][len("LAUNCHES:"):])
                        if lines and lines[-1].startswith("LAUNCHES:")
                        else {})
            figures = _check_example(name, proc.returncode, out, err,
                                     launches)
            runs[name] = dict(seconds=seconds, launches=launches,
                              figures=figures)
            log(f"examples/{name} {seconds:.1f}s: {json.dumps(figures)}; "
                f"launches {launches}")
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    rec["runs"] = runs
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 16 {rec['seconds']:.1f}s")
    return rec


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


def cache_counts():
    """Each cache of the compile and cache registry: its entries in this
    process now, the bound its registry entry states (None: not held),
    and whether it is keyed by stream."""
    import importlib
    out = {}
    for site, entry in sorted(json.loads(REGISTRY.read_text())["sites"]
                              .items()):
        if entry["kind"] != "cache":
            continue
        relpath, _, name = site.split("::")
        module = relpath[len("src/"):-len(".py")].replace("/", ".")
        out[site] = dict(
            entries=len(getattr(importlib.import_module(module), name)),
            bound=entry["bound"], held=entry["bound"] is not None,
            stream_keyed=entry["stream_keyed"])
    return out


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
    rows = kernel_phase(torch, dev, LLAMA_SPEC)
    for r in rows:
        log("  " + json.dumps(r))
    gather_rows = gather_phase(torch, dev, LLAMA_SPEC)
    attention = attention_phase(torch, dev, LLAMA_SPEC)
    q_rows = kernel_phase(torch, dev, QWEN_SPEC)
    for r in q_rows:
        log("  " + json.dumps(r))
    q_gather = gather_phase(torch, dev, QWEN_SPEC)
    q_attention = attention_phase(torch, dev, QWEN_SPEC, full=False)
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
    _release(torch)

    # ---- 10. learned router, router training, LoRA fine-tune ------------
    t0 = time.perf_counter()
    learned = learned_router_phase(torch, dev, shared)
    log(f"learned-router phase {time.perf_counter() - t0:.1f}s")
    _release(torch)

    # ---- 17. the kernels' whole domain (on phase 4's weights) ------------
    domain = domain_phase(torch, dev, shared)
    log(f"domain phase {domain['seconds']:.1f}s")
    del shared
    _release(torch)

    # ---- 7-9. qwen2-0.5b policies and tracing; full-width steps ---------
    t0 = time.perf_counter()
    qwen2 = qwen2_phase(torch, dev)
    _release(torch)
    log(f"qwen2-0.5b serves {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    routes = {}
    for arch in ("qwen2-0.5b", "llama3.2-3b", "openelm-1.1b"):
        routes[arch] = route_check_phase(torch, dev, arch)
        _release(torch)
    log(f"full-width route checks {time.perf_counter() - t0:.1f}s")

    # ---- 11. gemma2-9b, starcoder2-7b, chameleon-34b; int8 KV -----------
    t0 = time.perf_counter()
    variants = variants_phase(torch, dev)
    _release(torch)
    log(f"variants phase {time.perf_counter() - t0:.1f}s")

    # ---- 12. dbrx-132b, llama4-maverick: the MoE family -----------------
    t0 = time.perf_counter()
    moe = moe_phase(torch, dev)
    _release(torch)
    log(f"MoE phase {time.perf_counter() - t0:.1f}s")

    # ---- 13. mamba2-130m, zamba2-2.7b, qwen1.5-110b ---------------------
    t0 = time.perf_counter()
    ssm = ssm_phase(torch, dev)
    _release(torch)
    log(f"SSM phase {time.perf_counter() - t0:.1f}s")

    # ---- 14. whisper-medium: the encoder-decoder family -----------------
    t0 = time.perf_counter()
    whisper = whisper_phase(torch, dev)
    _release(torch)
    log(f"whisper phase {time.perf_counter() - t0:.1f}s")

    # ---- 15. remat; the dry-run's counts; the dry-run at full depth -----
    distributed = distributed_phase(torch, dev)
    _release(torch)

    # ---- 16. the examples -------------------------------------------------
    examples = examples_phase(torch, dev)
    _release(torch)
    caches = cache_counts()

    # launches over every serve, the main path's and each later one's
    serves = {"dense": serve["launches"],
              "paged_compare_dense": paged["dense"]["launches"],
              "paged_compare_paged": paged["paged"]["launches"],
              "prefix_chunk": prefix["launches"],
              "qwen2_traced": qwen2["traced"]["launches"]}
    for key, run in learned["serves"]["real"].items():
        serves[f"learned_{key}"] = run["launches"]
    for key, run in learned["serves"]["burst"].items():
        serves[f"learned_edgelora_{key}"] = run["launches"]
    for key, runs in qwen2.items():
        if isinstance(runs, dict) and "dense" in runs:
            for kv, run in runs.items():
                serves[f"qwen2_{key}_{kv}"] = run["launches"]
    domain_recs = {k: v for k, v in domain.items() if k != "seconds"}
    for arch, rec in {**variants, **moe, **ssm, **domain_recs}.items():
        for key, runs in rec.items():
            if not key.startswith("serve_"):
                continue
            if "launches" in runs:
                serves[f"{arch}_{key}"] = runs["launches"]
            else:
                for kv, run in runs.items():
                    serves[f"{arch}_{key}_{kv}"] = run["launches"]
    # whisper's path has no serve (the engine refuses it): its model calls
    for arch, rec in whisper.items():
        serves[f"{arch}_model_calls"] = rec["launches"]
    # the examples: each script's run, and the quickstart at full width
    for name, run in examples["runs"].items():
        serves[f"example_{name[:-len('_torch.py')]}"] = run["launches"]
    serves["example_quickstart_full"] = (
        examples["quickstart_full"]["routes"]["kernel"]["launches"])

    def pick(kernel, table, d):
        """A model's decode shape: 8 bf16 rows, ``d`` wide."""
        return next(r for r in table if r["kernel"] == kernel
                    and r["phase"] == "decode" and r["dtype"] == "bfloat16"
                    and r["d"] == d)

    def timing(r, shape):
        extra = {k: r[k] for k in ("scale_cast_ms", "sdpa_without_softcap_ms")
                 if k in r}
        return dict(ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r["library_ms"], host_us=r.get("host_us"),
                    shape=shape, **extra)

    def variant_rows(name):
        """Every row of kernel ``name`` at phases 11-14's and 17's
        shapes."""
        out, table = [], {"sgmv_shrink": "kernel_rows",
                          "sgmv_expand": "kernel_rows",
                          "paged_gather_pages": "gather_rows",
                          "flash_decode": "attention_rows",
                          "flash_prefill": "attention_rows"}[name]
        for rec in (*variants.values(), *moe.values(), *ssm.values(),
                    *whisper.values(), *domain_recs.values()):
            out += [r for r in rec.get(table, []) if r["kernel"] == name]
        return out

    def variant_timings(name):
        by_model = {}
        for r in variant_rows(name):
            if name.startswith("sgmv"):
                shape = (f"{r['model']} {r['phase']} T={r['T']} "
                         f"(T_pad={r['T_pad']}) d={r['d']} r={r['r']} "
                         f"{r['dtype']} x, f32 pool")
            elif name == "paged_gather_pages":
                shape = (f"{r['model']} {r['leaf']} ng={r['ng']} "
                         f"n_pages={r['n_pages']} bs={r['bs']} F={r['F']} "
                         f"B={r['B']} MB={r['MB']}")
            else:
                shape = r["shape"]
            key = r["model"].replace("-", "_").replace(".", "_")
            by_model.setdefault(key, []).append(timing(r, shape))
        return by_model

    def sgmv_shape(r, spec):
        return (f"{spec['model']} decode T={r['T']} (T_pad={r['T_pad']}) "
                f"d={r['d']} r={spec['rank']} R={spec['r_pool']} "
                f"{r['dtype']} x, f32 pool")

    sources = {"sgmv_shrink": ("src/repro/kernels/sgmv.py:62", 4096, 896),
               "sgmv_expand": ("src/repro/kernels/sgmv.py:98", 4096, 896)}
    kernels = []
    for name, (replaces, d, qd) in sources.items():
        r = pick(name, rows, d)
        qr = pick(name, q_rows, qd)
        by_serve = {k: v[name] for k, v in serves.items()}
        kernels.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/sgmv.cu", replaces=replaces,
            launches=sum(by_serve.values()), launches_by_serve=by_serve,
            launches_prefill=serve["path_launches"]["prefill"][name],
            launches_decode=serve["path_launches"]["decode"][name],
            max_abs_err=max(x["max_abs_err"] for x in rows + q_rows
                            + variant_rows(name) if x["kernel"] == name),
            **timing(r, sgmv_shape(r, LLAMA_SPEC)),
            bound_padded_ms=r["bound_padded_ms"],
            qwen2_0_5b=timing(qr, sgmv_shape(qr, QWEN_SPEC)),
            **variant_timings(name)))
    g = next(r for r in gather_rows if r["dtype"] == "bfloat16")
    qg = next(r for r in q_gather if r["dtype"] == "bfloat16")

    def gather_shape(g):
        return (f"{g['model']} ng={g['ng']} n_pages={g['n_pages']} "
                f"bs={g['bs']} F={g['F']} B={g['B']} MB={g['MB']} bf16")

    by_serve = {k: v["paged_gather_pages"] for k, v in serves.items()}
    kernels.append(dict(
        name="paged_gather_pages", route="cuda",
        source="src/repro_torch/kernels/csrc/paged_gather.cu",
        replaces="src/repro/kernels/paged_gather.py:31",
        launches=sum(by_serve.values()), launches_by_serve=by_serve,
        max_abs_err=max(r["max_abs_err"] for r in gather_rows + q_gather
                        + variant_rows("paged_gather_pages")),
        **timing(g, gather_shape(g)), plan_route=g["route"],
        bound_frac=g["bound_frac"], qwen2_0_5b=timing(qg, gather_shape(qg)),
        **variant_timings("paged_gather_pages")))
    # the attention kernels: times at each model's bf16 shape (decode
    # step; full prefill group)
    for name, src, replaces, pick_row in (
            ("flash_decode", "decode_attention.cu",
             "src/repro/kernels/decode_attention.py:85",
             lambda r: r["kv_dtype"] == "bfloat16"),
            ("flash_prefill", "flash_prefill.cu",
             "src/repro/kernels/flash_prefill.py:82",
             lambda r: r["case"] == "prefill"
             and r["dtype"] == "bfloat16")):
        mine = [r for r in attention + q_attention if r["kernel"] == name]
        r = next(x for x in mine if pick_row(x)
                 and x["model"] == "llama3.1-8b")
        qr = next(x for x in mine if pick_row(x)
                  and x["model"] == "qwen2-0.5b")
        by_serve = {k: v[name] for k, v in serves.items()}
        kernels.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{src}", replaces=replaces,
            launches=sum(by_serve.values()), launches_by_serve=by_serve,
            max_abs_err=max(x["max_abs_err"] for x in mine
                            + variant_rows(name)),
            **timing(r, r["shape"]), qwen2_0_5b=timing(qr, qr["shape"]),
            **variant_timings(name)))
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(
        dict(card=smi, torch=torch.__version__, build_s=build_s,
             kernels=kernels, kernel_rows=rows, gather_rows=gather_rows,
             attention_rows=attention, step_check=step_check,
             serve=serve,
             paged_compare=paged, prefix_chunk=prefix,
             qwen2_kernel_rows=q_rows, qwen2_gather_rows=q_gather,
             qwen2_attention_rows=q_attention, qwen2=qwen2,
             route_checks=routes, learned_router=learned,
             variants=variants, moe=moe, ssm=ssm, whisper=whisper,
             domain=domain,
             distributed=distributed, examples=examples, caches=caches,
             seconds=time.perf_counter() - t_start), indent=1, default=str))
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"caches": caches}))
    for site, c in caches.items():
        check(not c["held"] or c["entries"] <= c["bound"],
              f"{site}: {c['entries']} entries, over its registered bound "
              f"{c['bound']}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
