"""Device meshes (counterpart of ``repro/launch/mesh.py``).

Defined as FUNCTIONS (not module constants), so importing this module never
touches a process group. Each builds a named
``torch.distributed.device_mesh.DeviceMesh`` over the ranks of the default
process group, which the caller (or ``torchrun``) has initialised: one rank
a device, as JAX has one device a mesh position. ``device_type`` is the
mesh's (``cuda`` when a card is present, else ``cpu``); several gloo ranks
may share one card.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.device_mesh import init_device_mesh

from repro_torch.parallel.sharding import data_axes_of, mesh_shape


def _device_type(device_type: Optional[str]) -> str:
    if device_type is not None:
        return device_type
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False, device_type: Optional[str] = None):
    """16x16 devices a pod; 2 pods in multi-pod mode (the JAX package's TPU
    v5e target): ``(16, 16)`` over ``("data", "model")``, or ``(2, 16, 16)``
    over ``("pod", "data", "model")``. The world must hold 256 (512)
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(device_type), shape, mesh_dim_names=axes)


def data_axes(mesh) -> tuple:
    """The data-parallel axes of a production mesh (includes 'pod')."""
    return data_axes_of(mesh)


def make_host_mesh(n_devices: int = 0, axes=("data",), *, device_type: Optional[str] = None):
    """A one-axis mesh over the first ``n_devices`` ranks (default: the
    whole world) — on one card, one rank: a ``(1,)`` ``data`` mesh."""
    import torch.distributed as dist

    n = n_devices or dist.get_world_size()
    return init_device_mesh(_device_type(device_type), (n,), mesh_dim_names=tuple(axes))


def launch_mesh(device):
    """The launchers' mesh, whether this call started the process group
    (the caller then ends it), and the rank's device. With no default group,
    one is started: from ``torchrun``'s environment when ``WORLD_SIZE`` is
    set, else one rank on a store of its own — nccl for a card, gloo for the
    host. Under ``torchrun`` a card device with no index is bound to the
    rank's ``LOCAL_RANK`` first (``torch.cuda.set_device``), so each rank of
    a node allocates on its own card and nccl sees distinct devices. A world
    of 256 (512) ranks takes the production mesh, as the JAX launchers do;
    any other world the host mesh over all its ranks (one card: a ``(1,)``
    ``data`` mesh of one rank)."""
    import os

    import torch.distributed as dist

    device = torch.device(device)
    if device.type == "cuda" and device.index is None and "LOCAL_RANK" in os.environ:
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(device)
    started = not dist.is_initialized()
    if started:
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    world = dist.get_world_size()
    if world in (256, 512):
        mesh = make_production_mesh(multi_pod=world == 512, device_type=device.type)
    else:
        mesh = make_host_mesh(device_type=device.type)
    return mesh, started, device


def expert_parallel(cfg, mesh):
    """``cfg`` with the ``multisplit`` MoE dispatch taken as
    ``multisplit_ep`` where ``mesh`` has a ``model`` axis wider than 1: the
    port lays out a non-expert-parallel dispatch under a mesh on whole
    tensors (every rank gathers every expert's weights), so a served MoE
    model keeps its experts sharded only through ``multisplit_ep``. That
    dispatch counts capacity per data shard; where it cannot split the
    experts or the tokens it falls back to ``multisplit``, as JAX's does.
    Any other config is returned as it is."""
    import dataclasses

    wide = mesh_shape(mesh).get("model", 1) > 1
    if not cfg.moe.num_experts or cfg.moe.dispatch != "multisplit" or not wide:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, dispatch="multisplit_ep"))


def describe(mesh) -> str:
    """``{axis: size}`` of ``mesh``, its ranks and its group's backend: the
    launchers' first line."""
    import torch.distributed as dist

    shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
    return f"mesh {shape} over {mesh.size()} rank(s), {dist.get_backend()} on {mesh.device_type}"
