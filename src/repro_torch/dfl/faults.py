"""Chaos transport: fault-injected gossip delivery for the DFL engine (port
of ``repro.dfl.faults``).

The dynamics engine (``repro_torch.dfl.dynamics``) varies WHO talks to
whom; this module varies HOW WELL the talking goes.  Every message that
the topology schedule says is delivered can independently be

  dropped        the packet never arrives (lossy link),
  stale          a straggler delivers the sender's model from ``lag``
                 rounds ago instead of the fresh one,
  duplicated     the network re-delivers last round's packet,
  corrupted      the payload arrives bit-damaged — NaN / +-Inf rows or
                 finite garbage, drawn per round on the device,
  crashed        the sender is down for the round: it neither trains nor
                 transmits, and everything it would have received is lost
                 (crash-restart: when the node comes back it resumes from
                 its frozen state).

Fault schedules are precomputed on the host by deterministic numpy
generators into ``(R, N, K)`` / ``(R, N)`` stacks (``FaultSchedule``),
bit-equal with the reference's for every name and seed.

The delivery mechanics are the stacked-ring-matrix trick: the round loop
carries an L-deep ring of past post-attack model matrices
(``TransportState``), and ``apply_transport`` builds one 2-D
``((L+1)*M + C, d)`` stacked matrix

    [ flat (M rows) | ring (L*M rows) | corrupt bank (C rows) ]

then re-keys the neighbour table instead of building per-edge payloads:
a fresh delivery reads row ``idx``, a lag-l delivery reads row
``l*M + idx``, a corrupted delivery reads a bank row.  The gossip kernels
read rows of a 2-D matrix exactly as on a clean round, and the
(N, K, d) tensor never exists.

Graceful degradation, in order:
  * sanitizer — non-finite rows of the stacked matrix are zeroed and the
    edges that read them demoted to invalid before any filter statistic;
  * retry-as-redundancy — a dropped/duplicated delivery falls back to
    re-serving the last delivered payload, aged one round
    (``served_lag + 1``), valid while within ``staleness_budget``;
  * staleness pricing — the per-edge ``prev_idx`` table points at the
    payload the edge ACTUALLY served last round, so WFAgg-T's
    round-over-round metrics price the lag.

Everything per round is tensor work on the round's device: no host
read, so a round never waits on the card.  The corrupt bank's finite
garbage comes from a ``torch.Generator`` on that device, seeded from
(``FaultConfig.seed``, round); it is not the reference's ``jax.random``
draw (the parity tests pass the reference's bank through ``bank=``), but
the NaN / +Inf / -Inf / garbage row cycle is the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.topology import TopologySchedule

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Static transport parameters.

    ``ring_depth`` L bounds how old a served payload can be (the loop
    carries L past model matrices); ``staleness_budget`` is the oldest
    lag a receiver ACCEPTS — a delivery older than the budget is demoted
    to invalid and the node's slate shrinks.  ``bank_size`` C is the
    number of corrupt-payload rows appended to the stacked matrix;
    ``garbage_scale`` sizes the finite-garbage corruption rows (those
    survive the sanitizer and must be caught by the filters instead).
    """

    ring_depth: int = 3
    staleness_budget: int = 2
    bank_size: int = 4
    max_lag: int = 2          # largest scheduled straggler lag
    garbage_scale: float = 1e3
    seed: int = 0             # seeds the corrupt bank's generator

    def __post_init__(self):
        if self.ring_depth < 1:
            raise ValueError("ring_depth must be >= 1")
        if self.max_lag > self.ring_depth:
            raise ValueError(
                f"max_lag={self.max_lag} exceeds ring_depth={self.ring_depth}"
                " — the ring cannot serve a payload that old")
        if self.bank_size < 1:
            raise ValueError("bank_size must be >= 1")


class FaultRound(NamedTuple):
    """One round's fault surface (row r of a ``FaultSchedule``)."""

    drop: Tensor      # (N, K) bool  packet lost on this edge
    lag: Tensor       # (N, K) int32 scheduled straggler lag (0 = fresh)
    dup: Tensor       # (N, K) bool  re-delivery of last round's packet
    corrupt: Tensor   # (N, K) bool  payload bit-damaged on the wire
    down: Tensor      # (N,)   bool  node crashed for this round


class TransportState(NamedTuple):
    """Delivery state carried from round to round.

    ``ring[l]`` is the post-attack model matrix from ``l + 1`` rounds ago
    (``ring[0]`` = last round), so the stacked matrix serves lag ``l``
    from row block ``l * M``.  ``served_lag[n, k]`` is the age of the
    payload edge (n, k) actually delivered last round — the anchor for
    both the retry fallback and the WFAgg-T prev re-keying.
    """

    ring: Tensor        # (L, M, d) f32
    served_lag: Tensor  # (N, K) int32


class TransportOut(NamedTuple):
    """What ``apply_transport`` hands the aggregation stage."""

    full: Tensor        # ((L+1)*M + C, d) sanitized stacked matrix
    eff_idx: Tensor     # (N, K) int64 re-keyed neighbour table into ``full``
    eff_valid: Tensor   # (N, K) bool  surviving edges after faults + budget
    prev_idx: Tensor    # (N, K) int64 last round's delivery, aged, in ``full``
    served_lag: Tensor  # (N, K) int32 next round's served_lag carry
    dropped: Tensor     # (N, K) bool  telemetry: delivery was dropped
    stale: Tensor       # (N, K) bool  telemetry: delivered but lag > 0
    corrupt: Tensor     # (N, K) bool  telemetry: corruption hit the edge


def init_transport_state(cfg: FaultConfig, n_nodes: int, width: int, d: int,
                         device=None) -> TransportState:
    return TransportState(
        ring=torch.zeros((cfg.ring_depth, n_nodes, d), device=device),
        served_lag=torch.zeros((n_nodes, width), dtype=torch.int32, device=device),
    )


def corrupt_bank(cfg: FaultConfig, d: int, rnd: int, device=None) -> Tensor:
    """(C, d) corrupted-payload rows for round ``rnd``, drawn on ``device``.

    Rows cycle NaN / +Inf / -Inf / finite garbage with the round (row c
    is of kind ``(c + rnd) % 4``), so every corruption flavour is
    exercised; the generator is seeded from (``cfg.seed``, ``rnd``), so a
    resumed run draws the identical bank from the carried round counter.
    """
    g = torch.Generator(device=device)
    g.manual_seed((cfg.seed + 9173) * 1_000_003 + int(rnd))
    noise = cfg.garbage_scale * torch.randn((cfg.bank_size, d), generator=g,
                                            device=device)
    kind = ((torch.arange(cfg.bank_size, device=device) + int(rnd)) % 4)[:, None]
    bank = torch.where(kind == 0, torch.nan, noise)
    bank = torch.where(kind == 1, torch.inf, bank)
    return torch.where(kind == 2, -torch.inf, bank)


def apply_transport(flat: Tensor, ts: TransportState, neighbor_idx: Tensor,
                    valid: Tensor, fr: FaultRound, cfg: FaultConfig, rnd: int,
                    bank: Optional[Tensor] = None) -> TransportOut:
    """Re-key one round's gossip through the fault surface.

    ``flat (M, d)`` is this round's post-attack model matrix, ``rnd`` the
    round counter (a host int).  ``bank`` replaces the drawn corrupt bank
    (the parity tests pass the reference's).  Tensor work on ``flat``'s
    device only, and no (N, K, d) tensor: everything d-sized stays 2-D.
    """
    M, d = flat.shape
    N, K = neighbor_idx.shape
    L, C = cfg.ring_depth, cfg.bank_size
    dev = flat.device
    idx = neighbor_idx.long()
    valid_b = valid.to(torch.bool)
    drop_f, dup_f, corrupt_f = (x.to(torch.bool) for x in (fr.drop, fr.dup, fr.corrupt))
    down = fr.down.to(torch.bool)

    if bank is None:
        bank = corrupt_bank(cfg, d, rnd, dev)
    bank = torch.as_tensor(bank, dtype=flat.dtype, device=dev)
    full = torch.cat([flat, ts.ring.reshape(L * M, d), bank], dim=0)

    # --- which payload age does each edge get? ---------------------------
    # re-serving last round's delivery makes it one round older, capped at
    # the ring depth (the oldest representable payload)
    relag = torch.clamp(ts.served_lag.long() + 1, max=L)
    sender_down = down[idx]
    drop = (drop_f | sender_down) & valid_b
    lag = torch.clamp(fr.lag.long(), 0, L)
    lag = torch.where(dup_f & valid_b, relag, lag)
    lag = torch.where(drop, relag, lag)         # retry-as-redundancy fallback
    # a payload older than the round count does not exist (the ring is
    # zero-initialized), and one older than the budget is not accepted
    ok = (lag <= cfg.staleness_budget) & (lag <= rnd)
    eff_valid = valid_b & ok & ~down[:, None]

    eff_idx = lag * M + idx
    corrupt = corrupt_f & eff_valid
    slot = ((torch.arange(N, device=dev)[:, None] * K
             + torch.arange(K, device=dev)[None, :] + rnd) % C)
    eff_idx = torch.where(corrupt, (L + 1) * M + slot, eff_idx)

    # --- sanitizer: the kernels must never see a non-finite row ----------
    finite = torch.isfinite(full).all(dim=1)
    full = torch.where(finite[:, None], full, torch.zeros_like(full))
    eff_valid = eff_valid & finite[eff_idx]

    # --- staleness pricing: where was last round's delivery? -------------
    # the payload edge (n, k) served last round is one round older now;
    # WFAgg-T compares against what the receiver ACTUALLY saw
    prev_idx = relag * M + idx

    # an edge that delivered records its lag; an edge that did not keeps
    # (re-ages) its last delivery — consecutive drops walk down the ring
    # until the budget demotes them
    served_lag = torch.where(eff_valid, lag, relag).to(torch.int32)

    return TransportOut(
        full=full, eff_idx=eff_idx, eff_valid=eff_valid, prev_idx=prev_idx,
        served_lag=served_lag,
        dropped=drop | (valid_b & ~ok),
        stale=eff_valid & (lag > 0) & ~corrupt,
        corrupt=corrupt_f & valid_b,
    )


def advance_ring(ts: TransportState, flat: Tensor,
                 served_lag: Tensor) -> TransportState:
    """Post-round carry: push this round's (post-attack, post-freeze)
    model matrix into ring slot 0 and adopt the new served-lag table."""
    return TransportState(
        ring=torch.cat([flat[None], ts.ring[:-1]], dim=0),
        served_lag=served_lag,
    )


def realign_served_lag(served: Tensor, prev_idx: Tensor, prev_valid: Tensor,
                       idx: Tensor, valid: Tensor) -> Tensor:
    """Re-key the slot-positional served-lag table to a new slate.

    Same identity-match contraction as ``wfagg.realign_temporal_history``:
    column k_new inherits the served lag of the k_old with matching
    neighbour id (both slots valid); a neighbour unseen last round starts
    at lag 0.  The contraction is a float32 einsum over 0/1 weights, exact
    for these small integers, so a neighbour seen twice or never behaves
    as in the reference.
    """
    match = ((idx[:, :, None] == prev_idx[:, None, :])
             & valid.to(torch.bool)[:, :, None]
             & prev_valid.to(torch.bool)[:, None, :])   # (N, K_new, K_old)
    m = match.to(torch.float32)
    return torch.einsum("nkj,nj->nk", m, served.to(torch.float32)).to(torch.int32)


# ---------------------------------------------------------------------------
# schedules: deterministic host-side generators (mirrors dynamics.SCENARIOS)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """Precomputed per-round fault surface for a whole experiment.

    Array stacks match ``FaultRound`` with a leading R axis; the static
    ``FaultConfig`` travels with them so a checkpoint can reconstruct the
    exact transport semantics on resume.
    """

    drop: np.ndarray     # (R, N, K) bool
    lag: np.ndarray      # (R, N, K) int32
    dup: np.ndarray      # (R, N, K) bool
    corrupt: np.ndarray  # (R, N, K) bool
    down: np.ndarray     # (R, N) bool
    config: FaultConfig = FaultConfig()

    @property
    def rounds(self) -> int:
        return self.drop.shape[0]

    def xs(self, device=None):
        """The per-round stacks as tensors on ``device``, in ``FaultRound``
        field order (uploaded once, before the round loop)."""
        return tuple(torch.as_tensor(np.asarray(a), device=device)
                     for a in (self.drop, self.lag, self.dup, self.corrupt,
                               self.down))

    def summary(self) -> Dict[str, float]:
        return {
            "drop_rate": float(self.drop.mean()),
            "stale_rate": float((self.lag > 0).mean()),
            "dup_rate": float(self.dup.mean()),
            "corrupt_rate": float(self.corrupt.mean()),
            "down_rate": float(self.down.mean()),
        }


def _zeros(rounds: int, n: int, k: int):
    return (np.zeros((rounds, n, k), bool), np.zeros((rounds, n, k), np.int32),
            np.zeros((rounds, n, k), bool), np.zeros((rounds, n, k), bool),
            np.zeros((rounds, n), bool))


def _gen_none(rng, rounds, n, k, intensity, cfg, **_):
    return _zeros(rounds, n, k)


def _gen_drop(rng, rounds, n, k, intensity, cfg, **_):
    drop, lag, dup, corrupt, down = _zeros(rounds, n, k)
    drop[:] = rng.random((rounds, n, k)) < intensity
    return drop, lag, dup, corrupt, down


def _gen_stale(rng, rounds, n, k, intensity, cfg, max_lag=None, **_):
    drop, lag, dup, corrupt, down = _zeros(rounds, n, k)
    ml = int(max_lag if max_lag is not None else cfg.max_lag)
    hit = rng.random((rounds, n, k)) < intensity
    lag[:] = np.where(hit, rng.integers(1, ml + 1, (rounds, n, k)), 0)
    return drop, lag, dup, corrupt, down


def _gen_duplicate(rng, rounds, n, k, intensity, cfg, **_):
    drop, lag, dup, corrupt, down = _zeros(rounds, n, k)
    dup[:] = rng.random((rounds, n, k)) < intensity
    return drop, lag, dup, corrupt, down


def _gen_corrupt(rng, rounds, n, k, intensity, cfg, **_):
    drop, lag, dup, corrupt, down = _zeros(rounds, n, k)
    corrupt[:] = rng.random((rounds, n, k)) < intensity
    return drop, lag, dup, corrupt, down


def _gen_crash_restart(rng, rounds, n, k, intensity, cfg,
                       p_restart=0.5, **_):
    """Markov crash/restart per node: up -> down with p = intensity per
    round, down -> up with ``p_restart`` — nodes freeze while down and
    resume from their stored state when back."""
    drop, lag, dup, corrupt, down = _zeros(rounds, n, k)
    state = np.zeros((n,), bool)
    for r in range(rounds):
        crash = rng.random(n) < intensity
        restart = rng.random(n) < p_restart
        state = np.where(state, ~restart, crash)
        down[r] = state
    return drop, lag, dup, corrupt, down


def _gen_chaos(rng, rounds, n, k, intensity, cfg, **params):
    """Everything at once, scaled so total disruption tracks intensity:
    drop + stale at intensity/2, duplicate/corrupt/crash at intensity/4."""
    drop, lag, dup, corrupt, down = _gen_drop(
        rng, rounds, n, k, intensity / 2, cfg)
    _, lag, _, _, _ = _gen_stale(rng, rounds, n, k, intensity / 2, cfg,
                                 **params)
    dup[:] = rng.random((rounds, n, k)) < intensity / 4
    corrupt[:] = rng.random((rounds, n, k)) < intensity / 4
    _, _, _, _, down = _gen_crash_restart(rng, rounds, n, k, intensity / 4,
                                          cfg)
    return drop, lag, dup, corrupt, down


FAULTS = {
    "none": _gen_none,
    "drop": _gen_drop,
    "stale": _gen_stale,
    "duplicate": _gen_duplicate,
    "corrupt": _gen_corrupt,
    "crash_restart": _gen_crash_restart,
    "chaos": _gen_chaos,
}

FAULT_NAMES = tuple(FAULTS)


def make_fault_schedule(name: str, schedule: TopologySchedule,
                        intensity: float, seed: int = 0,
                        config: Optional[FaultConfig] = None,
                        **params) -> FaultSchedule:
    """Build a named fault schedule shaped to a topology schedule.

    Deterministic in (name, shape, intensity, seed, params): the same
    arguments always give the identical schedule, which is what makes
    kill-and-resume exact.
    """
    if name not in FAULTS:
        raise ValueError(f"unknown fault scenario {name!r}; "
                         f"choose from {sorted(FAULTS)}")
    cfg = config or FaultConfig()
    rng = np.random.default_rng(seed)
    drop, lag, dup, corrupt, down = FAULTS[name](
        rng, schedule.rounds, schedule.n_nodes, schedule.width,
        float(intensity), cfg, **params)
    return FaultSchedule(drop=drop, lag=np.clip(lag, 0, cfg.ring_depth),
                         dup=dup, corrupt=corrupt, down=down, config=cfg)
