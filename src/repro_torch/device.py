"""Device resolution shared by every entry point of the port."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """The device an entry point runs on.

    CUDA is the default everywhere.  When CUDA is asked for and absent this
    raises: the port never carries on on the CPU unless the caller said
    ``device="cpu"``.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this machine; pass device='cpu' "
            "(--device cpu on the launcher) to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def check_on_device(model: torch.nn.Module, device: torch.device,
                    name: str = "model") -> None:
    """Raise unless ``model``'s parameters lie on ``device`` (the engine
    never moves a caller's module behind its back)."""
    check_tensor_on_device(next(model.parameters()), device, name)


def check_tensor_on_device(t: torch.Tensor, device: torch.device,
                           name: str = "tensor") -> None:
    """Raise unless tensor ``t`` lies on ``device``."""
    got = t.device
    if got.type != device.type or (device.index is not None
                                   and got.index != device.index):
        raise ValueError(f"{name} is on {got}, engine runs on {device}; "
                         f"move it with .to({str(device)!r})")
