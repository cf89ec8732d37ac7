"""Shared kernel plumbing: device resolution, D padding, the build directory.

The JAX package picks interpret mode off a TPU; the port has no such
switch.  A wrapper runs its CUDA kernel on a CUDA tensor and its plain
PyTorch version on a CPU tensor, decided by the tensor's device alone,
and the entry points default to the card and raise without one.
"""
from __future__ import annotations

import pathlib
from typing import Optional, Union

import torch
import torch.nn.functional as F

# where kernels are compiled at first use (listed in .gitignore)
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """None means the card.  Without one, raise: there is no silent CPU
    fallback; callers that want the CPU (the tests) say so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    return dev


def pad_d(x: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad the trailing (D) axis up to a multiple of ``multiple`` and
    promote to f32.  Zero padding is exact for every kernel here: a zero
    column has median 0 and adds nothing to any accumulated statistic,
    distance, dot product or weighted combine."""
    x = x.to(torch.float32)
    pad = (-x.shape[-1]) % multiple
    return F.pad(x, (0, pad)) if pad else x
