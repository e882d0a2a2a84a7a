"""Training launcher of the PyTorch port: LoRA fine-tune an adapter on
the synthetic task pipeline (``repro.launch.train`` with ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch qwen2-0.5b --steps 200 --task 1 --out adapters/task1.npz

Runs on ``cuda`` unless ``--device cpu`` is given (no CUDA: it raises).
``--reduced`` (the default) is the tiny same-family variant. ``--full``
is accepted as in the reference, but its data pipeline draws a
vocab × vocab transition matrix (``training/data.py``), which at a
published vocabulary (128256 or 151936) is 100+ GB: neither package can
run it. The adapter saves in the reference's ``.npz`` format, so either
package loads it. An encoder-decoder arch (whisper-medium) is refused:
the task pipeline has no ``frames`` for its encoder.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.models import build_model
from repro_torch.models.model import require_token_batches
from repro_torch.training.checkpoint import save_checkpoint
from repro_torch.training.data import DataConfig, lm_batches
from repro_torch.training.train import train_loop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--task", type=int, default=0)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="save adapter .npz here")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    require_token_batches(
        cfg, "launch/train.py",
        "src/repro/launch/train.py trains on lm_batches, whose batches "
        "hold tokens only")
    model = build_model(cfg, args.device)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                    batch_size=args.batch_size, seed=args.seed)
    state, history = train_loop(
        model, lm_batches(dc, task=args.task), args.steps,
        generator=torch.Generator(device=model.device).manual_seed(
            args.seed), peak_lr=args.lr, log_every=10)
    if args.out:
        save_checkpoint(args.out, state.lora)
        print(f"adapter saved to {args.out}")
    print(f"final loss {history[-1][1]:.4f} "
          f"(start {history[0][1]:.4f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
