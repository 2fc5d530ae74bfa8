"""Device meshes over ``torch.distributed``, mirroring ``repro.launch.mesh``.

A JAX mesh names the devices one process sees; a ``DeviceMesh`` names the
ranks of a process group, one device a rank.  So:

* :func:`make_production_mesh` gives the reference's (16, 16)
  ``("data", "model")`` mesh, or (2, 16, 16) ``("pod", "data", "model")``,
  over a world of exactly that many ranks, and raises otherwise, as
  ``jax.make_mesh`` raises where the devices do not fill the shape;
* :func:`make_debug_mesh` gives a ``(world, 1)`` ``("data", "model")`` mesh
  over the ranks that exist.

Both join the process group that is running, or start one: from
torchrun's variables (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, ...) where
they are set, else a one-process group on a free local port.  The backend
is NCCL on ``cuda`` and gloo on ``cpu``; asking for ``cuda`` without a card
raises, and nothing falls back to the CPU.

The hardware constants are one H100 SXM's: the peak bf16 rate and the
memory rate from NVIDIA's data sheet, the NVLink rate a direction, the
card's memory and the cards a node from
:data:`repro_torch.core.netmodel.H100_CLUSTER`, and the NIC a card from
the DGX H100 data sheet (the roofline's denominators).
"""

from __future__ import annotations

import math
import os
import socket
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.core.netmodel import H100_CLUSTER
from repro_torch.device import Device, resolve_device

#: H100 SXM, dense bf16 on the tensor cores (data sheet), per card.
PEAK_FLOPS_BF16 = 989e12
#: H100 SXM HBM3 (data sheet), bytes/s per card.
HBM_BW = 3.35e12
#: NVLink 4, bytes/s a direction per card (``H100_CLUSTER``'s network).
NVLINK_BW = H100_CLUSTER.network.bandwidth_bytes_per_s
#: Device memory per card, bytes (``H100_CLUSTER``).
HBM_PER_CHIP = H100_CLUSTER.gpu_capacity_bytes
#: Cards an NVLink domain holds: one HGX H100 node (``H100_CLUSTER``).
#: Ranks are laid out node by node, as torchrun numbers them, so rank r is
#: on node r // CARDS_PER_NODE.
CARDS_PER_NODE = H100_CLUSTER.n_workers
#: Between nodes: one 400 Gb/s NIC a card (DGX H100 data sheet: eight
#: ConnectX-7 400 Gb/s ports for eight cards), bytes/s a direction.
NIC_BW = 400e9 / 8


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _init_group(device: Device = "cuda") -> torch.device:
    """Join or start the default process group for ``device`` ("cuda":
    NCCL, "cpu": gloo) and return this rank's device.  Under torchrun each
    rank takes the card ``LOCAL_RANK``; with no group and no torchrun
    variables, a one-process group starts on a free local port."""
    dev = resolve_device(device)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{_free_port()}",
                                    world_size=1, rank=0)
    return dev


def make_mesh(shape: Sequence[int], names: Sequence[str], device: Device = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over every rank of the group (started
    by :func:`_init_group` where none runs), its dims named ``names`` (the
    counterpart of ``jax.make_mesh``).  Raises ``ValueError`` where the
    world is not ``prod(shape)`` ranks."""
    dev = _init_group(device)
    need = math.prod(shape)
    world = dist.get_world_size()
    if world != need:
        raise ValueError(
            f"a {tuple(shape)} mesh {tuple(names)} needs {need} ranks, one device each; "
            f"the process group has {world}"
        )
    return init_device_mesh(dev.type, tuple(int(n) for n in shape), mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: Device = "cuda") -> DeviceMesh:
    """Single pod: (data=16, model=16) = 256 ranks.  Multi-pod: (pod=2,
    data=16, model=16) = 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device)


def make_debug_mesh(n_devices: Optional[int] = None, device: Device = "cuda") -> DeviceMesh:
    """Every rank that exists as a ``(world, 1)`` ``("data", "model")``
    mesh; a plain ``python -m ...`` runs at world size 1.  The reference
    takes ``min(n_devices, devices)``; a ``DeviceMesh`` spans the whole
    group, so ``n_devices``, where given, must be the world size."""
    _init_group(device)
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"a debug mesh spans every rank: n_devices={n_devices}, world {world}")
    return make_mesh((world, 1), ("data", "model"), device)
