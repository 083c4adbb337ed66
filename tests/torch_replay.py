"""What the port's CUDA kernels read, replayed on the CPU from their launch arguments.

Shared by the CPU tests that check the Python around each kernel (layouts,
strides, TMA boxes) without a card: `tests/test_torch_kernels.py` and
`tests/test_torch_bwd_plan.py`.
"""

import torch


def gather(t: torch.Tensor, shape, strides) -> torch.Tensor:
    """What a kernel reads from `t`'s storage at base + sum(i * stride), unit stride last."""
    return torch.as_strided(t, shape, (*strides, 1), t.storage_offset())


def tma_box(t: torch.Tensor, dims, byte_strides, box, coord) -> torch.Tensor:
    """What a TMA load puts in shared memory: the `box` (innermost first) of the
    map (`dims`, outer `byte_strides`) over `t`'s storage at `coord`, with zeros
    for every element past `dims`. Returned outermost first: (box[3], .., box[0])."""
    flat = torch.as_strided(t, (t.untyped_storage().nbytes() // t.element_size(),), (1,), 0)
    steps = (1, *(s // t.element_size() for s in byte_strides))
    off = torch.full((), t.storage_offset(), dtype=torch.long)
    inside = torch.ones((), dtype=torch.bool)
    for axis in range(4):  # broadcast (box[3], box[2], box[1], box[0])
        c = (coord[axis] + torch.arange(box[axis])).view([-1 if a == axis else 1 for a in (3, 2, 1, 0)])
        off, inside = off + c * steps[axis], inside & (c < dims[axis])
    return torch.where(inside, flat[torch.where(inside, off, 0)], torch.zeros((), dtype=t.dtype))
