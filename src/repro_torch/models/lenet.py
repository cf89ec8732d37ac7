"""The paper's local models (port of ``repro.models.lenet``): a
LeNet-5-style CNN for 28x28 images and a small MLP, as functions of a
flat parameter dict.

Parameters keep the reference's layout so that weights carry across
element for element: keys ``"conv1.w"``, ``"conv1.b"``, ... ; conv
weights HWIO ``(kh, kw, cin, cout)``, dense weights ``(in, out)``, images
NHWC.  ``ravel``/``unravel`` give the same flat vector as the
reference's ``ravel_pytree``: keys in sorted order, each leaf row-major.
Every function also takes a leading node axis on every leaf.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def init_lenet(n: int, generator: torch.Generator, num_classes: int = 10) -> Params:
    """He-normal LeNet-5 weights for ``n`` nodes (leading axis n), zero
    biases, drawn on the generator's device."""
    def normal(shape, fan_in):
        return torch.randn((n, *shape), generator=generator,
                           device=generator.device) * math.sqrt(2.0 / fan_in)
    dev = generator.device
    zeros = lambda m: torch.zeros((n, m), device=dev)  # noqa: E731
    return {
        "conv1.w": normal((5, 5, 1, 6), 25), "conv1.b": zeros(6),
        "conv2.w": normal((5, 5, 6, 16), 150), "conv2.b": zeros(16),
        "fc1.w": normal((256, 120), 256), "fc1.b": zeros(120),
        "fc2.w": normal((120, 84), 120), "fc2.b": zeros(84),
        "fc3.w": normal((84, num_classes), 84), "fc3.b": zeros(num_classes),
    }


def init_mlp_classifier(n: int, generator: torch.Generator, d_in: int = 784,
                        width: int = 64, num_classes: int = 10) -> Params:
    """Smaller alternative local model, ``n`` nodes."""
    dev = generator.device
    def normal(shape):
        return torch.randn((n, *shape), generator=generator,
                           device=dev) * math.sqrt(2.0 / shape[0])
    return {
        "fc1.w": normal((d_in, width)), "fc1.b": torch.zeros((n, width), device=dev),
        "fc2.w": normal((width, num_classes)),
        "fc2.b": torch.zeros((n, num_classes), device=dev),
    }


def _conv(x: Tensor, w_hwio: Tensor, b: Tensor) -> Tensor:
    """VALID stride-1 convolution of NCHW ``x`` with an HWIO weight."""
    return F.conv2d(x, w_hwio.permute(3, 2, 0, 1), b)


def lenet_fwd(params: Mapping[str, Tensor], images: Tensor) -> Tensor:
    """images (B, 28, 28, 1) NHWC -> logits (B, C)."""
    h = images.permute(0, 3, 1, 2)                                        # NCHW
    h = F.max_pool2d(F.relu(_conv(h, params["conv1.w"], params["conv1.b"])), 2)
    h = F.max_pool2d(F.relu(_conv(h, params["conv2.w"], params["conv2.b"])), 2)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)       # HWC flatten order
    h = F.relu(h @ params["fc1.w"] + params["fc1.b"])
    h = F.relu(h @ params["fc2.w"] + params["fc2.b"])
    return h @ params["fc3.w"] + params["fc3.b"]


def mlp_classifier_fwd(params: Mapping[str, Tensor], images: Tensor) -> Tensor:
    """images (B, 28, 28, 1) or (B, 784) -> logits."""
    h = images.reshape(images.shape[0], -1)
    h = F.relu(h @ params["fc1.w"] + params["fc1.b"])
    return h @ params["fc2.w"] + params["fc2.b"]


MODELS: Dict[str, Tuple[Callable, Callable]] = {
    "lenet": (init_lenet, lenet_fwd),
    "mlp": (init_mlp_classifier, mlp_classifier_fwd),
}


def params_from_jax(tree: Mapping, device=None) -> Params:
    """Nested ``{"conv1": {"w": array, "b": array}, ...}`` (the reference's
    pytree, numpy leaves, with or without a leading node axis) -> the flat
    parameter dict, same layout and values."""
    out: Params = {}
    for layer, leaves in tree.items():
        for name, leaf in leaves.items():
            out[f"{layer}.{name}"] = torch.tensor(
                np.asarray(leaf, dtype=np.float32), device=device)
    return out


def ravel(params: Mapping[str, Tensor], batch_dims: int = 1) -> Tensor:
    """Flatten to ``(N, d)`` (``batch_dims=1``) or ``(d,)`` (0): sorted
    keys, each leaf row-major, as ``ravel_pytree`` orders them."""
    lead = next(iter(params.values())).shape[:batch_dims]
    return torch.cat([params[k].reshape(*lead, -1) for k in sorted(params)], dim=-1)


def unravel(flat: Tensor, like: Mapping[str, Tensor], batch_dims: int = 1) -> Params:
    """Inverse of ``ravel``: split ``flat`` into leaves shaped like ``like``."""
    out: Params = {}
    lead = flat.shape[:batch_dims]
    off = 0
    for k in sorted(like):
        shape = like[k].shape[batch_dims:]
        size = int(np.prod(shape, dtype=np.int64))
        out[k] = flat[..., off:off + size].reshape(*lead, *shape)
        off += size
    if off != flat.shape[-1]:
        raise ValueError(f"flat vector has {flat.shape[-1]} entries, params {off}")
    return out


def param_count(params: Mapping[str, Tensor], batch_dims: int = 1) -> int:
    return sum(int(np.prod(v.shape[batch_dims:], dtype=np.int64))
               for v in params.values())

