"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
(one nvcc per source, started together) into
``_build/lib<name>_<hash>.so``, where the hash covers the source, the
shared headers (``csrc/*.cuh``) and the compiler flags: a library is
built at first use and rebuilt whenever its source changes. Nothing is
built or loaded at import time (the CPU tests import every module; this
machine-independent module only touches nvcc when a kernel is first
launched on a CUDA tensor, or when ``build()`` is called).

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
        -Xcompiler -fPIC -o _build/lib<name>_<hash>.so csrc/<name>.cu

``sm_90a`` keeps Hopper's arch-specific instructions available to later
kernels (wgmma, setmaxnreg).
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LIBS: Dict[str, ctypes.CDLL] = {}


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise if autograd would need a kernel's backward. The kernels fill
    their outputs through ctypes, out of autograd's sight: an output
    would carry no ``grad_fn`` and its inputs' gradients would be
    silently zero. (The plain versions, which CPU tensors take, stay
    differentiable.)"""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, but the CUDA kernel has no "
            "backward; run it under torch.no_grad() / inference_mode(), "
            "or take the plain PyTorch route to differentiate")


def on_device(device: torch.device):
    """``torch.cuda.device(device)`` when ``device`` is not the current
    card, else a null context. A kernel launches on the current device
    with the stream it is given, so each wrapper launches inside this: on
    the card of its tensors, paying for a device switch only when they are
    not on the current one."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def nvcc() -> str:
    """Path of nvcc: $PATH first, then $CUDA_HOME/bin (default
    /usr/local/cuda). Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (searched $PATH and $CUDA_HOME/bin); "
                       "the CUDA kernels are built on a machine with the "
                       "CUDA toolkit")


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    # every shared header counts: a source may include any of them
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu",
                                            *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, float]:
    """Compile every source in ``names`` (default: all) that is not built
    yet: one nvcc per source, all started together. Returns the seconds
    each source took to build (0.0 where the library was already built).
    Raises with the compiler's output if a build fails, after every
    compiler it started has exited."""
    seconds: Dict[str, float] = {}
    running = {}
    for name in names or sources():
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = tmp.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, log, out, time.perf_counter())
    failures = []
    while running:
        for name, (proc, tmp, log, out, t0) in list(running.items()):
            if proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            del running[name]
            text = log.read_text()
            log.unlink(missing_ok=True)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                failures.append(f"nvcc failed for {name}.cu (exit "
                                f"{proc.returncode}):\n{text}")
            else:
                os.replace(tmp, out)
        if running:
            time.sleep(0.05)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed. Loaded once per process."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        _LIBS[name] = lib
    return lib
