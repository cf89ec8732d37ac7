"""Model-poisoning and data-poisoning attacks (paper Section V-B) plus
defense-aware adaptive adversaries (port of ``repro.core.attacks``).

Three adversary classes, by what the attacker can observe:

  oblivious   noise / sign_flip / label_flip: no knowledge of anyone.
  omniscient  alie / ipm: computed from the benign cohort's updates.
  adaptive    band_rider / min_max: also observe the defense.  A
              ``DefenseView`` carries the per-victim WFAgg-T EWMA
              acceptance bands (``core.trust.temporal_bands``), the
              previous-round model matrix the temporal metrics are
              measured against, and the gossip neighbour table; the
              attacks solve for the largest deviation the filters still
              accept.

Model-poisoning attacks replace the Byzantine rows of the flat (N, d)
model matrix; Label-Flipping is data poisoning, applied to the batch
labels inside local training.

Every function is closed form on tensors: benign-cohort statistics are
masked sums over the rows (the Byzantine set may be any (N,) mask), and
no value is read back to the host, so an attack on the card never waits
for it.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch

Tensor = torch.Tensor

_EPS = 1e-12

# Adaptive (defense-aware) attacks: consume the DefenseView.
ADAPTIVE_ATTACKS = ("band_rider", "min_max")
# THE attack registry: every attack-choice surface derives its choices
# from this tuple (as in the reference).
ATTACK_NAMES = ("none", "noise", "sign_flip", "label_flip",
                "ipm_0.5", "ipm_100", "ipm", "alie") + ADAPTIVE_ATTACKS


@dataclasses.dataclass(frozen=True)
class AttackConfig:
    name: str = "none"
    noise_mu: float = 0.1       # Noise attack mean (paper: 0.1)
    noise_sigma: float = 0.1    # Noise attack std  (paper: 0.1)
    alie_zmax: float = 0.5      # ALIE z_max (paper: 0.5)
    ipm_eps: float = 0.5        # IPM epsilon (paper evaluates 0.5 and 100)
    # Adaptive-attack safety margin: band_rider targets deviations this
    # relative fraction inside the acceptance interval (never exactly on
    # the edge, where rounding could tip the filter); min_max scales its
    # deviation to (1 - margin) of the feasible radius.
    adaptive_margin: float = 0.05


class DefenseView(NamedTuple):
    """What an adaptive adversary sees of WFAgg's filter state this round
    (each field a tensor of the round, or None where that defense state
    does not exist).

      neighbor_idx  (N, K) gossip table: who receives whose model
      valid         (N, K) real-edge mask of padded slates (None = all)
      prev          (N, d) previous-round sent models, the reference
                    point of the WFAgg-T metrics
      tbands        (N, 4K) flat per-victim WFAgg-T acceptance bands
                    ``[lo_d | hi_d | lo_c | hi_c]`` exactly as
                    ``core.trust.temporal_bands`` gives them to the round
                    kernel (None: no temporal defense is active)
      f             the defense's assumed Byzantine count
    """

    neighbor_idx: Optional[Tensor] = None
    valid: Optional[Tensor] = None
    prev: Optional[Tensor] = None
    tbands: Optional[Tensor] = None
    f: int = 2


def noise_attack(update: Tensor, generator: Optional[torch.Generator] = None,
                 mu: float = 0.1, sigma: float = 0.1) -> Tensor:
    """theta <- theta + N(mu, sigma^2 I), drawn from ``generator``."""
    noise = torch.randn(update.shape, generator=generator, dtype=update.dtype,
                        device=update.device)
    return update + mu + sigma * noise


def sign_flip_attack(update: Tensor) -> Tensor:
    """theta <- -theta."""
    return -update


def flip_labels(labels: Tensor, num_classes: int) -> Tensor:
    """Label-Flipping data poisoning: l -> C-1-l."""
    return (num_classes - 1) - labels


def alie_attack(benign: Tensor, zmax: float = 0.5) -> Tensor:
    """A-Little-Is-Enough: mu_j - z_max * sigma_j per coordinate over the
    (K_b, d) stack of benign updates (population std)."""
    return benign.mean(0) - zmax * benign.std(0, correction=0)


def ipm_attack(benign: Tensor, eps: float = 0.5) -> Tensor:
    """Inner-Product Manipulation: -eps * the benign mean."""
    return -eps * benign.mean(0)


# ---------------------------------------------------------------------------
# adaptive (defense-aware) attacks
# ---------------------------------------------------------------------------

def _masked_moments(mf: Tensor, benign_w: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """(mu, sd, n_benign) of the benign rows of a flat (K, P) stack."""
    n_benign = torch.clamp(benign_w.sum(), min=1.0)
    mu = (mf * benign_w[:, None]).sum(0) / n_benign
    var = (benign_w[:, None] * (mf - mu[None, :]) ** 2).sum(0) / n_benign
    return mu, torch.sqrt(torch.clamp(var, min=0.0)), n_benign


def _masked_coordinate_median(mf: Tensor, benign: Tensor) -> Tensor:
    """Coordinate-wise median of the benign rows: other rows sort to +inf
    and the two middle elements are read at the positions the benign
    count gives, through ``index_select`` (no host read)."""
    K = mf.shape[0]
    srt = torch.sort(torch.where(benign[:, None], mf, torch.inf), dim=0).values
    v = benign.to(torch.int64).sum()
    lo = torch.clamp(torch.div(v - 1, 2, rounding_mode="floor"), 0, K - 1)
    hi = torch.clamp(torch.div(v, 2, rounding_mode="floor"), 0, K - 1)
    med = 0.5 * (srt.index_select(0, lo.reshape(1))[0]
                 + srt.index_select(0, hi.reshape(1))[0])
    return torch.where(v > 0, med, torch.zeros_like(med))


def _sender_band_limits(view: DefenseView, malicious: Tensor, K: int):
    """Fold the per-(victim, slot) WFAgg-T bands into per-SENDER limits.

    A Byzantine node sends one model to every neighbour, so to stay inside
    every benign victim's band it must satisfy the tightest of them: the
    upper edges scatter by min, the lower edges by max, over the valid
    edges whose receiver is benign (``scatter_reduce_`` with ``amin`` /
    ``amax``: exact and independent of order).  Returns four (K,) tensors
    ``(lo_d, hi_d, lo_c, hi_c)``; a sender with no constrained edge comes
    back ``(-inf, +inf)`` (unconstrained), one facing an inactive band
    (transient rounds encode ``(+inf, -inf)``) comes back infeasible, and
    the attack falls back to mimicry for it.
    """
    idx = view.neighbor_idx
    N, Knb = idx.shape
    valid = (torch.ones((N, Knb), dtype=torch.bool, device=idx.device)
             if view.valid is None else view.valid.to(torch.bool))
    tb = view.tbands.reshape(N, 4, Knb)
    # only benign receivers constrain the attacker (fooling a fellow
    # attacker buys nothing)
    em = valid & ~malicious.to(torch.bool)[:, None]
    flat_idx = idx.reshape(-1).to(torch.int64)

    def scatter(vals, reduce, fill):
        v = torch.where(em, vals, fill).reshape(-1)
        out = torch.full((K,), fill, dtype=vals.dtype, device=vals.device)
        return out.scatter_reduce_(0, flat_idx, v, reduce, include_self=True)

    lo_d = scatter(tb[:, 0], "amax", -torch.inf)
    hi_d = scatter(tb[:, 1], "amin", torch.inf)
    lo_c = scatter(tb[:, 2], "amax", -torch.inf)
    hi_c = scatter(tb[:, 3], "amin", torch.inf)
    return lo_d, hi_d, lo_c, hi_c


def band_rider_attack(
    models: Tensor,             # (K, P) flat candidate stack
    malicious: Tensor,          # (K,) bool
    view: Optional[DefenseView],
    cfg: AttackConfig,
) -> Tensor:
    """Temporal mimicry: the largest deviation strictly inside the WFAgg-T
    acceptance bands of every benign victim.

    WFAgg-T admits a candidate iff its round-over-round squared distance
    ``s_t = ||c - prev||^2`` and cosine distance ``b_t = 1 - cos(c, prev)``
    both land inside the victim's EWMA bands.  The attacker picks targets
    ``s*``/``b*`` at ``(1 - margin)`` of the tightest band (folded over
    its victims by ``_sender_band_limits``) and builds, in the plane of
    its own previous model ``p`` and a harmful direction, the vector
    realizing both:

        c = a p_hat + a tan(theta) q_hat,   cos(theta) = 1 - b*,
        a = (|p| + sqrt(|p|^2 - (1+tan^2)(|p|^2 - s*))) / (1 + tan^2)

    (the + root maximizes magnitude; the cap ``b* <= 1 - sqrt(1 -
    s*/|p|^2)`` keeps the discriminant >= 0).  ``q_hat`` is the
    drift-escape direction ``p - mu_benign`` orthogonalized against ``p``.
    Where bands are inactive or infeasible (transient rounds, zero prev,
    no temporal defense in the view) the attack is ALIE-style mimicry.
    """
    mf = models.to(torch.float32)
    K = mf.shape[0]
    malicious = malicious.to(torch.bool)
    benign_w = (~malicious).to(torch.float32)
    mu, sd, _ = _masked_moments(mf, benign_w)
    fallback = (mu - cfg.alie_zmax * sd).expand(mf.shape)
    if (view is None or view.prev is None or view.tbands is None
            or view.neighbor_idx is None):
        return fallback

    m = cfg.adaptive_margin
    lo_d, hi_d, lo_c, hi_c = _sender_band_limits(view, malicious, K)
    p = view.prev.reshape(K, -1).to(torch.float32)
    P2 = (p * p).sum(-1)
    Pn = torch.sqrt(P2)
    feasible = (torch.isfinite(hi_d) & torch.isfinite(hi_c)
                & (hi_d > 0.0) & (lo_d <= hi_d) & (Pn > 1e-6))

    # distance target: (1 - margin) of the way up the band
    lo_s = torch.clamp(lo_d, min=0.0)
    s_tgt = lo_s + (1.0 - m) * torch.clamp(hi_d - lo_s, min=0.0)
    # cosine target: as much angle as the band and the geometry allow
    ratio = torch.clamp(s_tgt / torch.clamp(P2, min=_EPS), 0.0, 1.0)
    b_geom = 1.0 - torch.sqrt(torch.clamp(1.0 - ratio, min=0.0))
    lo_b = torch.clamp(lo_c, 0.0, 0.999)
    hi_b = torch.clamp(torch.minimum(hi_c, b_geom), 0.0, 0.999)
    b_tgt = torch.clamp(lo_b + (1.0 - m) * (hi_b - lo_b), 0.0, 0.999)

    cos_t = 1.0 - b_tgt
    tan2 = torch.clamp(1.0 / torch.clamp(cos_t * cos_t, min=_EPS) - 1.0, min=0.0)
    disc = torch.clamp(P2 - (1.0 + tan2) * (P2 - s_tgt), min=0.0)
    a = (Pn + torch.sqrt(disc)) / (1.0 + tan2)

    phat = p / torch.clamp(Pn, min=_EPS)[:, None]
    h = p - mu[None, :]                       # drift-escape direction
    q = h - (h * phat).sum(-1, keepdim=True) * phat
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    # degenerate h || p: any orthogonal direction serves; derive one
    # deterministically from a rolled copy of p
    e = torch.roll(phat, 1, dims=-1)
    q2 = e - (e * phat).sum(-1, keepdim=True) * phat
    q2n = torch.linalg.vector_norm(q2, dim=-1, keepdim=True)
    qhat = torch.where(qn > 1e-6, q / torch.clamp(qn, min=_EPS),
                       torch.where(q2n > 1e-6, q2 / torch.clamp(q2n, min=_EPS),
                                   torch.zeros_like(q)))

    ride = a[:, None] * phat + (a * torch.sqrt(tan2))[:, None] * qhat
    return torch.where(feasible[:, None], ride, fallback)


def min_max_attack(
    models: Tensor,             # (K, P) flat candidate stack
    malicious: Tensor,          # (K,) bool
    cfg: AttackConfig,
    reduce: Optional[Callable[[Tensor], Tensor]] = None,
) -> Tensor:
    """Min-max deviation (Shejwalkar & Houmansadr 2021, adapted to the
    WFAgg filter radii): ``c = mu + gamma * u`` with the largest gamma
    keeping the attacker inside both distance-filter acceptance regions:

      * ``||c - x_b|| <= max pairwise benign distance`` for every benign
        ``x_b`` (the classic min-max constraint, which keeps Krum /
        Multi-Krum scores in the benign range), and
      * ``||c - med|| <= max benign distance to the coordinate median``
        (WFAgg-D's radius around the median model),

    each a quadratic in gamma with a closed-form positive root; gamma is
    the masked min over benign nodes of both caps, scaled by ``1 -
    margin``.  The direction is ``-sd/||sd||``.  The pairwise distances
    come from the (K, K) Gram ``mf @ mf.T`` (``torch.mm``, float32 with
    TF32 off as the package sets it); with fewer than two benign rows or a
    non-finite gamma the attack sends the benign mean.

    Three steps, so that a stack split over ranks by coordinates runs it:
    per-coordinate moments and two rounds of partial sums over the
    coordinates (``min_max_direction``: ||sd||^2 and ||mu||^2, which fix
    ``u``; ``min_max_partials``: the row norms, the Gram, ``(mu - x_b).u``,
    ``||mu - x_b||^2``, the distances to the coordinate median and
    ``(med - mu)``'s terms), each passed through ``reduce`` (the sum over
    the ranks that hold the other coordinates; None: this stack is whole),
    the closed form on the summed scalars (``min_max_gamma``), and the
    per-coordinate ``mu + gamma u``.
    """
    mf = models.to(torch.float32)
    benign = ~malicious.to(torch.bool)
    red = reduce if reduce is not None else (lambda x: x)
    mu, u = min_max_direction(mf, benign, red)
    gamma = min_max_gamma(red(min_max_partials(mf, benign, mu, u)), benign, cfg)
    return (mu + gamma * u).expand(mf.shape)


def min_max_direction(mf: Tensor, benign: Tensor,
                      reduce: Callable[[Tensor], Tensor]) -> Tuple[Tensor, Tensor]:
    """(mu, u) of ``min_max_attack``: the benign mean and the unit
    direction ``-sd / ||sd||`` (``-mu / ||mu||`` where sd vanishes), the
    norms from the reduced ||sd||^2 and ||mu||^2."""
    mu, sd, _ = _masked_moments(mf, benign.to(torch.float32))
    sums = reduce(torch.stack([(sd * sd).sum(), (mu * mu).sum()]))
    sdn, mun = torch.sqrt(sums[0]), torch.sqrt(sums[1])
    u = torch.where(sdn > 1e-6, -sd / torch.clamp(sdn, min=_EPS),
                    -mu / torch.clamp(mun, min=_EPS))
    return mu, u


def min_max_partials(mf: Tensor, benign: Tensor, mu: Tensor, u: Tensor) -> Tensor:
    """The coordinate sums ``min_max_gamma`` reads, as one vector: per row
    its squared norm (K), the Gram (K x K), ``(mu - x_b).u`` (K),
    ``||mu - x_b||^2`` (K) and ``||x_b - med||^2`` (K), then ``(mu -
    med).u`` and ``||mu - med||^2``."""
    sq = (mf * mf).sum(-1)
    gram = torch.mm(mf, mf.t())
    delta = mu[None, :] - mf                  # (K, P)
    A = torch.mv(delta, u)                    # (K,)
    n2 = (delta * delta).sum(-1)
    del delta
    med = _masked_coordinate_median(mf, benign)
    rmed = ((mf - med[None, :]) ** 2).sum(-1)
    dm = mu - med
    return torch.cat([sq, gram.reshape(-1), A, n2, rmed, torch.dot(dm, u).reshape(1),
                      (dm * dm).sum().reshape(1)])


def min_max_gamma(sums: Tensor, benign: Tensor, cfg: AttackConfig) -> Tensor:
    """``min_max_attack``'s step along ``u`` from the summed
    ``min_max_partials``: the smaller of the two caps, times ``1 -
    margin``; 0 when it is not finite or fewer than two rows are benign."""
    K = benign.shape[0]
    sq, gram, A, n2, rmed, Am, dm2 = sums.split([K, K * K, K, K, K, 1, 1])
    gram = gram.view(K, K)
    # max pairwise benign squared distance via the Gram expansion
    d2 = torch.clamp(sq[:, None] + sq[None, :] - 2.0 * gram, min=0.0)
    bpair = benign[:, None] & benign[None, :]
    dmax2 = torch.where(bpair, d2, -torch.inf).max()
    # cap 1: ||mu + g u - x_b||^2 <= dmax^2 for every benign b
    g_pair = -A + torch.sqrt(torch.clamp(A * A + dmax2 - n2, min=0.0))
    g_pair = torch.where(benign, g_pair, torch.inf).min()
    # cap 2: ||mu + g u - med||^2 <= max_b ||x_b - med||^2 (WFAgg-D radius)
    rmed2 = torch.where(benign, rmed, -torch.inf).max()
    Am, dm2 = Am[0], dm2[0]
    g_med = -Am + torch.sqrt(torch.clamp(Am * Am + rmed2 - dm2, min=0.0))
    gamma = (1.0 - cfg.adaptive_margin) * torch.clamp(torch.minimum(g_pair, g_med),
                                                      min=0.0)
    ok = torch.isfinite(gamma) & (benign.to(torch.float32).sum() >= 2)
    return torch.where(ok, gamma, torch.zeros_like(gamma))


def apply_model_attack(
    name: str,
    update: Tensor,
    benign: Tensor,
    generator: Optional[torch.Generator] = None,
    cfg: Optional[AttackConfig] = None,
) -> Tensor:
    """A model-poisoning attack on a single flat update.

    ``benign`` is the (K_b, d) stack of benign updates (for the omniscient
    attacks); label_flip is a no-op here (it poisons the data).  The
    adaptive attacks run in their form without a ``DefenseView``
    (band_rider degrades to ALIE mimicry; min_max keeps its benign-radius
    caps); the view-fed forms live on ``apply_matrix_attack``.
    """
    cfg = cfg or AttackConfig(name=name)
    if name in ("none", "label_flip"):
        return update
    if name == "noise":
        return noise_attack(update, generator, cfg.noise_mu, cfg.noise_sigma)
    if name == "sign_flip":
        return sign_flip_attack(update)
    if name == "alie":
        return alie_attack(benign, cfg.alie_zmax)
    if name.startswith("ipm"):
        return ipm_attack(benign, _ipm_eps(name, cfg))
    if name in ADAPTIVE_ATTACKS:
        stack = torch.cat([update[None], benign], dim=0)
        mal = torch.zeros((stack.shape[0],), dtype=torch.bool, device=stack.device)
        mal[0] = True
        if name == "band_rider":
            return band_rider_attack(stack, mal, None, cfg)[0].to(update.dtype)
        return min_max_attack(stack, mal, cfg)[0].to(update.dtype)
    raise ValueError(f"unknown attack {name!r}")


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
    view: Optional[DefenseView] = None,
) -> Tensor:
    """Replace the malicious rows of a stacked candidate tensor.

    Benign-cohort statistics are masked sums over the rows, so the
    Byzantine set may be any (N,) mask; only Byzantine rows change.
    ``view`` feeds the adaptive attacks (``ADAPTIVE_ATTACKS``) the defense
    state they ride; the other attacks ignore it.
    """
    cfg = cfg or AttackConfig(name=name)
    if name in ("none", "label_flip"):
        return models
    K = models.shape[0]
    mal = malicious.to(torch.bool).reshape((K,) + (1,) * (models.ndim - 1))
    if name == "noise":
        attacked = noise_attack(models, generator, cfg.noise_mu, cfg.noise_sigma)
        return torch.where(mal, attacked, models)
    if name == "sign_flip":
        return torch.where(mal, -models, models)
    if name in ADAPTIVE_ATTACKS:
        flat = models.reshape(K, -1)
        if name == "band_rider":
            attacked = band_rider_attack(flat, malicious, view, cfg)
        else:
            attacked = min_max_attack(flat, malicious, cfg)
        return torch.where(mal, attacked.reshape(models.shape).to(models.dtype), models)
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
