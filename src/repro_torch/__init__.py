"""PyTorch/CUDA port of the `repro` model stack.

Mirrors `repro`'s module paths. Imports torch, never jax, and nothing of
`repro`. Entry points run on CUDA unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: CUDA unless `device` names another.

    Raises when CUDA is wanted and absent; there is no silent CPU fallback.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
