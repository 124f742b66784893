"""Where the package's entry points run: on the CUDA card, unless the
caller asks for another device."""

from __future__ import annotations

import torch


def resolve(device, what: str) -> torch.device:
    """The entry point's device: ``None`` is the card ("cuda"),
    ``device="cpu"`` the explicit request for the CPU, where every kernel
    runs its plain PyTorch version.  Raises ``RuntimeError`` when the
    card is asked for and there is none: an entry point never carries on
    silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} runs on the CUDA card unless called with "
            f"device='cpu', and no card is available")
    return dev


def place(a, device, what: str) -> torch.Tensor:
    """``a`` as a tensor on the entry point's device (:func:`resolve`);
    an input on another device is moved."""
    return torch.as_tensor(a).to(resolve(device, what))
