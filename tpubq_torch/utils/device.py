"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, checked: the port's entry points run on a
    CUDA card by default, and raise where there is none instead of carrying
    on elsewhere. The CPU is used only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"tpubq_torch runs on a CUDA device by default (asked for {str(dev)!r}) and "
            'torch.cuda.is_available() is False; pass device="cpu" to run on the CPU'
        )
    return dev
