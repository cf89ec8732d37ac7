"""Model-poisoning and data-poisoning attacks (paper Section V-B); port of
the oblivious and omniscient attacks of ``repro.core.attacks``.

Model-poisoning attacks replace the Byzantine rows of the flat (N, d)
model matrix; Label-Flipping is data poisoning, applied to the batch
labels inside local training.  The defense-aware adaptive attacks
(``band_rider``, ``min_max``) are not ported yet (ROADMAP queue 1,
item 7).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

Tensor = torch.Tensor

ADAPTIVE_ATTACKS = ("band_rider", "min_max")
# every attack-choice surface derives from this tuple (same as the reference)
ATTACK_NAMES = ("none", "noise", "sign_flip", "label_flip",
                "ipm_0.5", "ipm_100", "ipm", "alie") + ADAPTIVE_ATTACKS


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    name: str = "none"
    noise_mu: float = 0.1       # Noise attack mean (paper: 0.1)
    noise_sigma: float = 0.1    # Noise attack std  (paper: 0.1)
    alie_zmax: float = 0.5      # ALIE z_max (paper: 0.5)
    ipm_eps: float = 0.5        # IPM epsilon (paper evaluates 0.5 and 100)


def flip_labels(labels: Tensor, num_classes: int) -> Tensor:
    """Label-Flipping data poisoning: l -> C-1-l."""
    return (num_classes - 1) - labels


def _ipm_eps(name: str, cfg: AttackConfig) -> float:
    if name == "ipm_0.5":
        return 0.5
    if name == "ipm_100":
        return 100.0
    return cfg.ipm_eps


def apply_matrix_attack(
    name: str,
    models: Tensor,              # (N, ...) candidate stack
    malicious: Tensor,           # (N,) bool
    generator: Optional[torch.Generator] = None,   # the noise attack's draws
    cfg: Optional[AttackConfig] = None,
) -> Tensor:
    """Replace the malicious rows of a stacked candidate tensor.

    Benign-cohort statistics are masked sums over the rows, so the
    Byzantine set may be any (N,) mask; only Byzantine rows change.
    """
    cfg = cfg or AttackConfig(name=name)
    if name in ("none", "label_flip"):
        return models
    if name in ADAPTIVE_ATTACKS:
        raise NotImplementedError(
            f"the adaptive attack {name!r} reads the defense's state and is "
            "not ported yet: ROADMAP queue 1, item 7")
    K = models.shape[0]
    mal = malicious.to(torch.bool).reshape((K,) + (1,) * (models.ndim - 1))
    if name == "noise":
        noise = torch.randn(models.shape, generator=generator,
                            dtype=models.dtype, device=models.device)
        return torch.where(mal, models + cfg.noise_mu + cfg.noise_sigma * noise,
                           models)
    if name == "sign_flip":
        return torch.where(mal, -models, models)
    benign_w = (~mal).to(torch.float32)
    n_benign = torch.clamp(K - malicious.to(torch.int64).sum(), min=1).to(torch.float32)
    mf = models.to(torch.float32)
    mu = (mf * benign_w).sum(0, keepdim=True) / n_benign
    if name.startswith("ipm"):
        attacked = -_ipm_eps(name, cfg) * mu
    elif name == "alie":
        var = (benign_w * (mf - mu) ** 2).sum(0, keepdim=True) / n_benign
        attacked = mu - cfg.alie_zmax * torch.sqrt(var)
    else:
        raise ValueError(f"unknown attack {name!r}")
    return torch.where(mal, attacked.expand_as(mf).to(models.dtype), models)
