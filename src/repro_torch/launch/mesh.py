"""Production meshes, as `torch.distributed.device_mesh.DeviceMesh`es with
the JAX package's shapes and axis names; the port of
`repro/launch/mesh.py`. Functions, not module constants, so importing this
module touches no process group.

The mesh spans the ranks of the default process group, which the caller
initializes with its address, world size and rank
(`torch.distributed.init_process_group`): NCCL on the cards, or the fake
backend the dry-run uses to lay out a mesh no host has. A group with fewer
ranks than the mesh needs raises; the mesh is never shrunk to fit.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _device_type() -> str:
    import torch.distributed as dist
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(shape: tuple, axes: tuple, device_type: str | None):
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs an initialized process group of {n} ranks "
            "(torch.distributed.init_process_group)")
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(f"need {n} ranks for mesh {shape}, have {have}")
    return DeviceMesh(device_type or _device_type(),
                      torch.arange(n).reshape(shape), mesh_dim_names=axes)


def production_mesh_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh: (16, 16) over
    ("data", "model"), or (2, 16, 16) over ("pod", "data", "model").
    REPRO_MESH="4,2" replaces the (data, model) part (the mini dry-run)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    env = os.environ.get("REPRO_MESH")
    if env:
        base = tuple(int(x) for x in env.split(","))
        shape = ((2,) + base) if multi_pod else base
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return shape, axes


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str | None = None):
    return _mesh(*production_mesh_shape(multi_pod), device_type)


def make_debug_mesh(data: int = 2, model: int = 2, pod: int = 0,
                    device_type: str | None = None):
    """Small mesh for tests."""
    shape = (pod, data, model) if pod else (data, model)
    axes = ("pod", "data", "model") if pod else ("data", "model")
    return _mesh(shape, axes, device_type)
