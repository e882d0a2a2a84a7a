"""PyTorch + CUDA port of the EdgeLoRA serving system.

Mirrors ``src/repro/`` module for module (same file and function names).
It imports ``torch`` and numpy only: nothing of JAX and nothing of the
``repro`` package. Entry points run on ``cuda`` unless the caller asks for
the CPU (see ``repro_torch.device``). Hand-written CUDA kernels live under
``repro_torch/kernels/csrc`` and are built with ``nvcc`` at first use.
"""
