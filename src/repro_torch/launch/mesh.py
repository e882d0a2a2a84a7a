"""Production mesh construction (``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks. Multi-pod adds a leading
'pod' axis (2 × 256 = 512 ranks); the 'pod' axis carries only
data-parallel traffic (batch/gradient). The shapes and axis names are the
reference's, so specs compare one for one.

The mesh is a ``DeviceMesh`` over a process group. Where none is
initialised, ``make_production_mesh`` initialises torch's fake one
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once and moves nothing) at the mesh's world size, with this
process as rank 0, so a full mesh can be traced in one process with no
device. ``release_mesh`` destroys that group, so the next mesh may have
another size. Nothing here touches a process group at import.

The roofline constants are one NVIDIA H100 SXM 80GB's (NVIDIA's data
sheet, dense, at the 700 W limit), not the reference's TPU figures. As
in the reference, every collective is charged at one link rate: NVLink 4
per direction per GPU. A 16-wide ``model`` axis spans two 8-GPU nodes,
whose links between nodes are slower, so there the collective term is a
lower bound.
"""
from __future__ import annotations

import math
from typing import Any, Sequence

# H100 SXM 80GB, per GPU (NVIDIA data sheet; the same figures as
# chip_smoke.py's bounds)
PEAK_FLOPS_BF16 = 989e12      # FLOP/s, dense bf16 tensor cores
HBM_BW = 3.35e12              # B/s, HBM3
LINK_BW = 450e9               # B/s, NVLink 4 (900 GB/s bidirectional)
L2_BYTES = 50e6               # B, the L2 cache: the fusion cutoff


def make_production_mesh(*, multi_pod: bool = False) -> Any:
    """The 16×16 (or 2×16×16) mesh, on the fake process group unless one
    is initialised already (its world size must then match)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh(shape: Sequence[int], axes: Sequence[str]) -> Any:
    """A CPU ``DeviceMesh`` of ``shape`` named ``axes`` (the dry-run's
    fake tensors live on the CPU), on the fake process group unless one
    is initialised already."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    world = math.prod(shape)
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", rank=0, world_size=world,
                                store=FakeStore())
    if dist.get_world_size() != world:
        raise ValueError(f"a process group of {dist.get_world_size()} ranks "
                         f"is initialised; a {shape} mesh needs {world} "
                         "(release_mesh() first)")
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=tuple(axes))


def release_mesh() -> None:
    """Destroy the process group a mesh was built on, if any."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def roofline_terms(hlo_flops: float, hlo_bytes: float,
                   collective_bytes: float, n_chips: int) -> dict:
    return {
        "compute_s": hlo_flops / (n_chips * PEAK_FLOPS_BF16),
        "memory_s": hlo_bytes / (n_chips * HBM_BW),
        "collective_s": collective_bytes / (n_chips * LINK_BW),
    }
