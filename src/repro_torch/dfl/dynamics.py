"""Topology-dynamics scenario engine: round-varying gossip graphs (port
of ``repro.dfl.dynamics``, numpy only and bit-equal with it for every
scenario name and seed).

The paper motivates WFAgg with "the adverse conditions ... of dynamic
decentralized topologies".  Each scenario generator precomputes a
``TopologySchedule``: an (R, N, K) neighbor-table + valid-mask stack
padded to ONE width across all rounds, plus an (R, N) per-round
Byzantine mask, which the engine uploads once and threads through
``round_fn(state, neighbor_idx, valid, mal_mask)`` round by round.

Scenarios (``SCENARIOS``):

  churn         nodes leave/rejoin via a 2-state Markov chain; a down
                node loses every incident edge (degree may hit 0 — the
                padded row goes all-invalid and the node keeps its local
                model until it rejoins)
  link_failure  every base-graph edge fails independently per round
  partition     the graph splits into two halves for a window of rounds,
                then heals (all cross-partition edges cut while split)
  mobility      periodic rewiring: the graph is resampled Erdos-Renyi
                every ``every`` rounds
  sleeper       static graph, time-varying Byzantine set: attackers
                behave benignly until their wake round

Topology ATTACKS (the adversary rewires the graph):

  eclipse       Byzantine nodes monopolize one victim's slate
  dos           a chosen node's edges are dropped for a window of rounds
  collusion     attackers rewire onto a shared set of high-degree victims

All generators are deterministic in (topology, rounds, seed) and
composable through ``schedule_from_adjacencies``.  The transport faults
(drop, stale delivery, duplication, corruption, crash-restart) live in
``repro_torch.dfl.faults``; ``make_faulty_schedule`` pairs the two.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.core.topology import (
    Topology,
    TopologySchedule,
    erdos_renyi,
    schedule_from_adjacencies,
    static_schedule,
)

__all__ = [
    "SCENARIOS", "SCENARIO_NAMES", "make_schedule", "make_faulty_schedule",
    "churn_schedule", "link_failure_schedule", "partition_schedule",
    "mobility_schedule", "sleeper_schedule", "static_schedule",
    "eclipse_schedule", "dos_schedule", "collusion_schedule",
]


def _cut_node(adj: np.ndarray, down: np.ndarray) -> np.ndarray:
    """Remove every edge incident to a down node (symmetric)."""
    up = ~down
    return adj & up[:, None] & up[None, :]


def churn_schedule(topo: Topology, rounds: int, seed: int = 0,
                   p_leave: float = 0.15, p_join: float = 0.5,
                   ) -> TopologySchedule:
    """Node churn: each round an up node leaves w.p. ``p_leave`` and a
    down node rejoins w.p. ``p_join`` (2-state Markov chain per node).
    A down node exchanges with nobody — all its edges vanish in both
    directions, so neighbors see a shrunken slate and the node itself
    gets an all-invalid row (self-fallback aggregate).  Malicious nodes
    churn like everyone else: a down attacker is also marked benign for
    the round (it sends nothing to poison)."""
    rng = np.random.default_rng(seed)
    n = topo.n_nodes
    down = np.zeros(n, dtype=bool)
    adjs, mals = [], []
    for _ in range(rounds):
        u = rng.random(n)
        down = np.where(down, u >= p_join, u < p_leave)
        adjs.append(_cut_node(topo.adjacency, down))
        mals.append(topo.malicious & ~down)
    return schedule_from_adjacencies(np.stack(adjs), np.stack(mals))


def link_failure_schedule(topo: Topology, rounds: int, seed: int = 0,
                          p_fail: float = 0.2) -> TopologySchedule:
    """Random link failure: every base edge drops independently w.p.
    ``p_fail`` each round (symmetric — a failed link is failed for both
    endpoints, as a lossy radio link would be)."""
    rng = np.random.default_rng(seed)
    n = topo.n_nodes
    adjs = []
    for _ in range(rounds):
        keep = rng.random((n, n)) >= p_fail
        keep = np.triu(keep, 1)
        keep = keep | keep.T
        adjs.append(topo.adjacency & keep)
    return schedule_from_adjacencies(np.stack(adjs), topo.malicious)


def partition_schedule(topo: Topology, rounds: int, seed: int = 0,
                       split_at: int = None, heal_at: int = None,
                       ) -> TopologySchedule:
    """Partition-and-heal: from round ``split_at`` (default R//3) to
    ``heal_at`` (default 2R//3) the network splits into two halves and
    every cross-partition edge is cut; outside that window the base
    graph is intact.  The halves are a random balanced bisection."""
    rng = np.random.default_rng(seed)
    n = topo.n_nodes
    split_at = rounds // 3 if split_at is None else split_at
    heal_at = (2 * rounds) // 3 if heal_at is None else heal_at
    side = np.zeros(n, dtype=bool)
    side[rng.permutation(n)[: n // 2]] = True
    same_side = side[:, None] == side[None, :]
    adjs = []
    for r in range(rounds):
        partitioned = split_at <= r < heal_at
        adjs.append(topo.adjacency & same_side if partitioned
                    else topo.adjacency)
    return schedule_from_adjacencies(np.stack(adjs), topo.malicious)


def mobility_schedule(topo: Topology, rounds: int, seed: int = 0,
                      every: int = 2, min_degree: int = 0,
                      ) -> TopologySchedule:
    """Mobility as periodic rewiring: every ``every`` rounds the graph is
    resampled Erdos-Renyi at the base topology's mean degree (nodes move,
    whole neighborhoods change).  ``min_degree=0`` allows transiently
    isolated nodes — the realistic mobile case the padded degree-0 path
    exists for."""
    n = topo.n_nodes
    p = float(topo.degrees.mean()) / max(n - 1, 1)
    adjs, cur = [], None
    for r in range(rounds):
        if cur is None or r % max(every, 1) == 0:
            cur = erdos_renyi(n, p, seed=seed + r, min_degree=min_degree)
        adjs.append(cur)
    return schedule_from_adjacencies(np.stack(adjs), topo.malicious)


def sleeper_schedule(topo: Topology, rounds: int, seed: int = 0,
                     wake_at: int = None) -> TopologySchedule:
    """Sleeper attackers on a static graph: the Byzantine set is empty
    until round ``wake_at`` (default R//2), when the topology's malicious
    nodes switch on — the late-joining adversary that defeats purely
    temporal trust (a sleeper builds perfect history first)."""
    wake_at = rounds // 2 if wake_at is None else wake_at
    n = topo.n_nodes
    mal = np.zeros((rounds, n), dtype=bool)
    mal[wake_at:] = topo.malicious
    adjs = np.broadcast_to(topo.adjacency, (rounds, n, n))
    return schedule_from_adjacencies(adjs, mal)


# ---------------------------------------------------------------------------
# topology attacks (adversarial graphs as scenarios)
# ---------------------------------------------------------------------------

def _default_victim(topo: Topology, prefer_malicious_neighbors: bool) -> int:
    """Deterministic victim choice: the benign node with the most
    malicious base-graph neighbors (eclipse — the cheapest node to
    surround) or the highest-degree benign node (dos — the most
    connective node to silence).  Ties break to the lowest id."""
    mal = topo.malicious
    if prefer_malicious_neighbors:
        score = (topo.adjacency & mal[None, :]).sum(axis=1)
    else:
        score = topo.degrees.copy()
    score = np.where(mal, -1, score)
    return int(np.argmax(score))


def eclipse_schedule(topo: Topology, rounds: int, seed: int = 0,
                     victim: int = None, start: int = 0,
                     ) -> TopologySchedule:
    """Eclipse attack: from round ``start`` on, every benign edge of the
    victim is cut and EVERY Byzantine node connects to it — the victim's
    whole padded slate is malicious senders, the strongest per-node
    poisoning ratio any aggregation rule can face (an f-out-of-f slate
    defeats every f-robust rule; what the grid measures is the collateral
    on the REST of the network and how fast the victim re-converges once
    schedules compose).  ``victim`` defaults to the benign node the base
    placement already surrounds most."""
    mal = topo.malicious
    if not mal.any():
        return static_schedule(topo, rounds)
    if victim is None:
        victim = _default_victim(topo, prefer_malicious_neighbors=True)
    n = topo.n_nodes
    adj_e = topo.adjacency.copy()
    adj_e[victim, :] = False
    adj_e[:, victim] = False
    attackers = mal & (np.arange(n) != victim)
    adj_e[victim, attackers] = True
    adj_e[attackers, victim] = True
    adjs = np.stack([topo.adjacency if r < start else adj_e
                     for r in range(rounds)])
    return schedule_from_adjacencies(adjs, mal)


def dos_schedule(topo: Topology, rounds: int, seed: int = 0,
                 victim: int = None, start: int = None, length: int = None,
                 ) -> TopologySchedule:
    """Denial of service: the victim's edges all drop for the window
    ``[start, start + length)`` (default: the middle third of the run) —
    jamming, not poisoning.  The victim rides the degree-0 self-fallback
    path (all-invalid padded row) and its neighbors lose a benign voice
    exactly while the poisoning attacks continue elsewhere."""
    start = rounds // 3 if start is None else start
    length = max(1, rounds // 3) if length is None else length
    if victim is None:
        victim = _default_victim(topo, prefer_malicious_neighbors=False)
    n = topo.n_nodes
    down = np.zeros(n, dtype=bool)
    down[victim] = True
    adj_d = _cut_node(topo.adjacency, down)
    adjs = np.stack([adj_d if start <= r < start + length else topo.adjacency
                     for r in range(rounds)])
    return schedule_from_adjacencies(adjs, topo.malicious)


def collusion_schedule(topo: Topology, rounds: int, seed: int = 0,
                       shared: int = None) -> TopologySchedule:
    """Collusion placement: the attackers abandon their base-graph
    positions (all their edges drop, including attacker-attacker edges —
    colluders don't waste links on each other) and ALL connect to the
    same ``shared`` victims, chosen as the highest-degree benign nodes
    (ties to the lowest id).  Each victim then sees every attacker at
    once — the worst-case placement a "spaced" deployment assumes away,
    static across rounds so its effect is attributable to placement
    alone.  ``shared`` defaults to the max attacker base degree, so the
    attackers spend exactly the edge budget they had."""
    mal = topo.malicious
    if not mal.any():
        return static_schedule(topo, rounds)
    n = topo.n_nodes
    benign_ids = np.flatnonzero(~mal)
    if shared is None:
        shared = int(topo.degrees[mal].max())
    shared = max(1, min(shared, benign_ids.size))
    # highest-degree benign victims, ties to the lowest id
    order = benign_ids[np.lexsort((benign_ids, -topo.degrees[benign_ids]))]
    victims = order[:shared]
    adj_c = topo.adjacency.copy()
    adj_c[mal, :] = False
    adj_c[:, mal] = False
    att_ids = np.flatnonzero(mal)
    adj_c[np.ix_(att_ids, victims)] = True
    adj_c[np.ix_(victims, att_ids)] = True
    adjs = np.broadcast_to(adj_c, (rounds, n, n))
    return schedule_from_adjacencies(adjs, mal)


ScenarioFn = Callable[..., TopologySchedule]

SCENARIOS: Dict[str, ScenarioFn] = {
    "static": static_schedule,
    "churn": churn_schedule,
    "link_failure": link_failure_schedule,
    "partition": partition_schedule,
    "mobility": mobility_schedule,
    "sleeper": sleeper_schedule,
    "eclipse": eclipse_schedule,
    "dos": dos_schedule,
    "collusion": collusion_schedule,
}

SCENARIO_NAMES = tuple(SCENARIOS)


def make_schedule(name: str, topo: Topology, rounds: int,
                  seed: int = 0, **params) -> TopologySchedule:
    """Build a named scenario's schedule (the registry entry point)."""
    if name not in SCENARIOS:
        raise ValueError(f"unknown scenario {name!r}; "
                         f"choose from {SCENARIO_NAMES}")
    if name == "static":
        return static_schedule(topo, rounds, **params)
    return SCENARIOS[name](topo, rounds, seed=seed, **params)


def make_faulty_schedule(scenario: str, topo: Topology, rounds: int,
                         fault: str = "chaos", intensity: float = 0.3,
                         seed: int = 0, fault_seed: int = 0,
                         fault_config=None, **params):
    """One-call chaos pairing: ``(TopologySchedule, FaultSchedule)``.

    The topology layer decides which edges EXIST each round (this
    module); the transport layer (``repro_torch.dfl.faults``) decides what
    happens to the payloads riding the edges that do — drop, stale
    delivery, duplication, bit-corruption, crash-restart.  The two
    compose through the valid mask: a fault schedule is generated
    against a topology schedule's shape and the engine ANDs fault
    delivery into ``valid`` each round, so ``make_schedule(...)`` plus
    ``faults.make_fault_schedule(...)`` is all this is — one
    deterministic call.  ``params``
    go to the scenario generator; pick the fault kind's knobs (lag
    depth, restart probability, ...) via ``fault_config`` /
    ``faults.FAULTS``.
    """
    from repro_torch.dfl import faults as flt

    sched = make_schedule(scenario, topo, rounds, seed=seed, **params)
    fs = flt.make_fault_schedule(fault, sched, intensity, seed=fault_seed,
                                 config=fault_config)
    return sched, fs
