"""Production mesh construction (counterpart of ``repro/launch/mesh.py``).

Functions (not module-level constants), so importing this module never
touches a process group.  Single pod: 16x16 = 256 ranks over ``(data,
model)``.  Multi-pod: 2x16x16 = 512 ranks with a leading ``pod`` axis.  The
meshes are the reference's; on H100s a 16-wide model axis spans two 8-GPU
NVLink nodes (see ``launch/roofline.py``).

:func:`fake_world` stands for the reference's dry-run flag
``--xla_force_host_platform_device_count=512``: it starts torch's ``fake``
process-group backend at a world of ``n`` ranks, so a mesh of that many
ranks can be built and traced on one host with no device, and tears it down
on exit so that nothing leaks into other code.
"""
from __future__ import annotations

import contextlib
import math

import torch


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current process
    group's ranks, in row-major order: on ``cuda`` under the NCCL backend,
    else on ``cpu``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = math.prod(shape)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"a mesh of {shape} needs a process group of {n} ranks"
                           + ("" if not dist.is_initialized()
                              else f", not {dist.get_world_size()}"))
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def production_shape(multi_pod: bool) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """(shape, axes) of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False):
    return make_mesh(*production_shape(multi_pod))


@contextlib.contextmanager
def fake_world(n: int):
    """A process group of ``n`` ranks on torch's ``fake`` backend, this
    process rank 0, for as long as the context lasts.  Collectives on it
    return at once and move nothing: it serves tracing only."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()
