"""The device of an entry point that takes host data (numpy arrays, paths)
and so cannot follow its inputs' device."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """None -> the card, and an error without one (never a silent CPU run);
    anything else -> torch.device(device). "cpu" asks for the plain PyTorch
    path, as the tests do."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hgmm_torch runs on the card by default and CUDA is not available; "
                'pass device="cpu" to run the plain PyTorch path')
        return torch.device("cuda")
    return torch.device(device)
