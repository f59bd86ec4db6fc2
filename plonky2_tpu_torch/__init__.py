"""plonky2_tpu_torch — the PyTorch/CUDA port of plonky2_tpu for NVIDIA Hopper.

The JAX package ``plonky2_tpu`` is the reference; this package imports
nothing of it (and never imports ``jax``).  Field elements are stored in one
format throughout: ``torch.int64`` tensors carrying the canonical u64 bit
pattern of each Goldilocks element.  The hand-written CUDA kernels
(``csrc/``) read the same buffers as ``uint64_t*``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.  A
CUDA tensor always goes through its kernel (or the call raises); a CPU tensor
goes through the kernel's plain PyTorch version, which is what the CPU tests
hold against the JAX package.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless one is given."""
    return torch.device("cuda" if device is None else device)


def lies_on(t: torch.Tensor, device: torch.device) -> bool:
    """Whether tensor `t` lies on `device`; a cuda device without an index
    is the current one."""
    if t.device.type != device.type:
        return False
    if device.index is None:
        return (device.type != "cuda"
                or t.device.index == torch.cuda.current_device())
    return t.device.index == device.index
