"""Device meshes over ``torch.distributed`` ranks (counterpart of
``repro.launch.mesh``), and the collectives the chain engine and the
server run over one mesh axis.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with axes
("data", "model"), or ("pod", "data", "model") across pods: 'data'
carries the chains (and a served ensemble's draws), 'model' the client
axis of the surrogate refresh, 'pod' replicates. Functions, not module
constants: importing this module touches no process group.

The reference's production shapes are fixed TPU pods, (16, 16) and (2,
16, 16). Here the production mesh is taken from the launched world
(``torchrun``'s WORLD_SIZE): (W, 1), or (2, W / 2, 1) across two pods,
which needs an even world. Every rank is one device; ``torchrun
--nproc-per-node N`` launches N of them.
"""
from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def _device_type(device_type: Optional[str]) -> str:
    """None -> 'cuda', which must be available (no quiet CPU world)."""
    if device_type is not None:
        return device_type
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device_type='cpu' "
                           "to run on the CPU")
    return "cuda"


def backend_for(device_type: str) -> str:
    """NCCL for CUDA ranks, gloo for CPU ranks."""
    return "nccl" if device_type == "cuda" else "gloo"


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_world(device_type: Optional[str] = None, *,
               rank: Optional[int] = None, world_size: Optional[int] = None,
               port: Optional[int] = None) -> None:
    """Initialise the default process group once. Under ``torchrun`` (its
    RANK / WORLD_SIZE / MASTER_ADDR / MASTER_PORT in the environment) from
    the environment; otherwise on tcp://localhost:``port`` (a free one
    when None) with ``rank`` and ``world_size`` (0 and 1: one process).
    On CUDA each rank takes the device of its LOCAL_RANK."""
    dt = _device_type(device_type)
    if dist.is_initialized():
        return
    if dt == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if rank is None and "RANK" in os.environ:
        dist.init_process_group(backend_for(dt))
        return
    dist.init_process_group(
        backend_for(dt),
        init_method=f"tcp://localhost:{port or free_port()}",
        rank=rank or 0, world_size=world_size or 1)


def _mesh(device_type: str, shape: tuple, axes: tuple):
    from torch.distributed.device_mesh import init_device_mesh
    world = dist.get_world_size()
    n = 1
    for s in shape:
        n *= s
    if n != world:
        raise ValueError(f"a {dict(zip(axes, shape))} mesh needs {n} ranks, "
                         f"the world has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: Optional[str] = None):
    """1 x 1 ('data', 'model') mesh over this one process's device (a
    one-rank world is started when none is): the same mesh code path on
    one device."""
    dt = _device_type(device_type)
    init_world(dt)
    return _mesh(dt, (1, 1), AXES)


def make_sim_mesh(data: int = 1, model: int = 1,
                  device_type: Optional[str] = None):
    """(data, model) mesh over the world's ranks (data * model of them):
    data = chain groups, model = the refresh's client groups."""
    dt = _device_type(device_type)
    init_world(dt)
    return _mesh(dt, (data, model), AXES)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """The launched world as one mesh: (W, 1) ('data', 'model'), or
    (2, W / 2, 1) ('pod', 'data', 'model') with ``multi_pod``, which
    refuses an odd world."""
    dt = _device_type(device_type)
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", 1)))
    if multi_pod and world % 2:
        raise ValueError(f"multi_pod needs an even world (two pods of "
                         f"equal size), got {world} ranks")
    init_world(dt)
    if not multi_pod:
        return _mesh(dt, (world, 1), AXES)
    return _mesh(dt, (2, world // 2, 1), POD_AXES)


# ---------------------------------------------------------------------------
# one mesh axis
# ---------------------------------------------------------------------------

def axis_size(mesh, name: str) -> int:
    """Ranks along ``name`` (1 without a mesh or without that axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return int(mesh.mesh.shape[mesh.mesh_dim_names.index(name)])


def axis_rank(mesh, name: str) -> int:
    """This rank's coordinate along ``name`` (0 without a mesh or without
    that axis)."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return 0
    return int(mesh.get_local_rank(name))


def all_gather_rows(t: torch.Tensor, mesh, name: str) -> torch.Tensor:
    """Every rank's ``t`` along ``name``, concatenated on dim 0 in axis
    order (``t`` itself without a mesh). Each rank passes the same shape.
    Bits travel as they are: bool as uint8, bf16 on gloo as its bytes."""
    if mesh is None or name not in mesh.mesh_dim_names:
        return t
    size = axis_size(mesh, name)
    wire = t.contiguous()
    if wire.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    elif wire.dtype == torch.bfloat16 and wire.device.type != "cuda":
        wire = wire.reshape(-1).view(torch.uint8)
    parts = [torch.empty_like(wire) for _ in range(size)]
    dist.all_gather(parts, wire, group=mesh.get_group(name))
    if t.dtype == torch.bool:
        return torch.cat(parts).to(torch.bool)
    if wire.dtype != t.dtype:
        parts = [p.view(t.dtype).reshape(t.shape) for p in parts]
    return torch.cat(parts)


def is_writer(mesh) -> bool:
    """True on the one rank that writes files for the mesh (global rank
    0; always without a mesh)."""
    return mesh is None or dist.get_rank() == 0


def barrier(mesh) -> None:
    """Wait for every rank of the mesh (nothing without one)."""
    if mesh is not None:
        dist.barrier()
