"""Device selection shared by the port's entry points."""

from __future__ import annotations

from typing import Union

import torch

Device = Union[str, torch.device]


def resolve_device(device: Device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is no
    card: the port never carries on silently on the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} asked for, but no CUDA device is available; "
            "pass device='cpu' to run on the host"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_device(mesh) -> torch.device:
    """This rank's device on a ``DeviceMesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)
