"""Deterministic synthetic MNIST stand-in (port of
``repro.data.synthetic.SyntheticImages``).

10 fixed class templates (seeded 28x28 Gaussian images smoothed with a
3x3 box filter) plus Gaussian pixel noise: linearly separable enough that
LeNet/MLP reach high accuracy within a round or two.  Draws come from
``torch.Generator``s seeded from (seed, round, batch), so data is a pure
function of those and needs no host state.  It does not reproduce the
reference's ``jax.random`` bits; the parity tests feed both packages the
reference's batches instead.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor


@functools.lru_cache(maxsize=8)
def _templates(n_classes: int, seed: int, device: str) -> Tensor:
    # read-only: every batch indexes it, nothing writes to it
    g = torch.Generator().manual_seed(seed + 17)
    t = torch.randn((n_classes, 1, 28, 28), generator=g)
    box = torch.full((1, 1, 3, 3), 1.0 / 9.0)
    t = F.conv2d(t, box, padding=1)     # 'same' smoothing, zero border
    return t.permute(0, 2, 3, 1).contiguous().to(device)


@dataclasses.dataclass(frozen=True)
class SyntheticImages:
    """MNIST-shaped 10-class task: template + noise."""

    n_classes: int = 10
    noise: float = 0.35
    seed: int = 0

    def templates(self, device=None) -> Tensor:
        """(C, 28, 28, 1) class templates, drawn on the CPU (identical on
        every device) and kept on ``device``."""
        return _templates(self.n_classes, self.seed, str(torch.device(device or "cpu")))

    def _draw(self, g: torch.Generator, shape, device) -> Tuple[Tensor, Tensor]:
        labels = torch.randint(0, self.n_classes, shape, generator=g, device=device)
        noise = torch.randn((*shape, 28, 28, 1), generator=g, device=device)
        return self.templates(device)[labels] + self.noise * noise, labels

    def node_batches(self, n_nodes: int, rnd: int, b: int, batch_size: int,
                     device) -> Tuple[Tensor, Tensor]:
        """Every node's IID batch ``b`` of round ``rnd``: images
        (N, B, 28, 28, 1), labels (N, B), drawn on ``device``."""
        g = torch.Generator(device=device)
        g.manual_seed((self.seed * 1_000_003 + rnd * 1000 + b) % (2 ** 63))
        return self._draw(g, (n_nodes, batch_size), device)

    def test_set(self, n: int = 1000, device=None) -> Tuple[Tensor, Tensor]:
        """A fixed held-out set of ``n`` images, identical on every device."""
        g = torch.Generator().manual_seed(self.seed + 999)
        imgs, labels = self._draw(g, (n,), "cpu")
        return imgs.to(device), labels.to(device)
