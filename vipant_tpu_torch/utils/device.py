"""Device choice of the entry points."""

from __future__ import annotations

from typing import Union


def require_device(device: Union[str, "torch.device"], who: str) -> "torch.device":
    """``device`` as a ``torch.device``; raises when it names a CUDA device
    and there is none, instead of carrying on on the CPU. (torch is imported
    here, not with the package, so that the data loader's worker processes
    start without it.)"""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the GPU (device={str(device)!r}) but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch versions on the CPU")
    return device
