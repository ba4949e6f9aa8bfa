"""Where the port puts new tensors when the caller names no device.

The port's entry points run on the card: a constructor that is given no
`device` (and no tensor to take one from) puts its data on CUDA, and
raises where there is none rather than quietly running on the CPU. CPU use
passes `device="cpu"`, or tensors that already lie on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None, like=None) -> torch.device:
    """`device` when given; else the device of `like` when it is a tensor;
    else the card. Raises when it would pick the card and there is none."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: fbstab_tpu_torch puts its data on the card "
            "unless told otherwise; pass device=\"cpu\" to run on the CPU")
    return torch.device("cuda")
