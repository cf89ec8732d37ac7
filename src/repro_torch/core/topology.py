"""DFL communication topologies (paper Section V-A); port of
``repro.core.topology``, numpy only and kept bit-equal with it.

The paper models the network as an undirected graph; experiments use a
20-node 8-regular ring lattice (Watts-Strogatz with rewiring p=0), 10%
malicious nodes placed so every node has at most 25% malicious neighbors.

Irregular graphs (erdos_renyi, or any hand-built adjacency) are
represented with a PADDED neighbor table: ``neighbor_indices`` is
(N, K_max) where padded slots repeat the node's own index (a safe row to
read; the self model is always finite) and ``neighbor_valid`` marks the
real edges.  The aggregation honors the valid mask, so per-node degrees
may differ freely, including degree 0 (the node keeps its own model).

Round-varying schedules (``TopologySchedule``) come with the dynamic
rounds: ROADMAP queue 1, item 6.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class Topology:
    n_nodes: int
    adjacency: np.ndarray          # (N, N) bool, symmetric, no self-loops
    neighbor_indices: np.ndarray   # (N, K) int32 - padded to the max degree
    malicious: np.ndarray          # (N,) bool
    neighbor_valid: np.ndarray = None   # (N, K) bool - False on padded slots

    def __post_init__(self):
        if self.neighbor_valid is None:
            object.__setattr__(
                self, "neighbor_valid",
                np.ones(self.neighbor_indices.shape, dtype=bool))

    @property
    def degree(self) -> int:
        """Neighbor-table width K (= max degree for irregular graphs)."""
        return int(self.neighbor_indices.shape[1])

    @property
    def degrees(self) -> np.ndarray:
        """Per-node true degree (valid neighbor count)."""
        return self.neighbor_valid.sum(axis=1)

    @property
    def is_regular(self) -> bool:
        return bool(self.neighbor_valid.all())

    def malicious_neighbor_count(self) -> np.ndarray:
        """Per node, how many of its neighbors are malicious."""
        return (self.adjacency & self.malicious[None, :]).sum(axis=1)


def ring_lattice(n: int, degree: int) -> np.ndarray:
    """c-regular ring lattice (Watts-Strogatz p=0): each node connects to
    its degree/2 nearest neighbors on each side."""
    if degree % 2 != 0:
        raise ValueError("ring lattice degree must be even")
    if degree >= n:
        raise ValueError("degree must be < n")
    adj = np.zeros((n, n), dtype=bool)
    half = degree // 2
    for i in range(n):
        for off in range(1, half + 1):
            j = (i + off) % n
            adj[i, j] = adj[j, i] = True
    return adj


def complete_graph(n: int) -> np.ndarray:
    adj = np.ones((n, n), dtype=bool)
    np.fill_diagonal(adj, False)
    return adj


def erdos_renyi(n: int, p: float, seed: int = 0, min_degree: int = 1) -> np.ndarray:
    """Random G(n, p) graph, patched to ensure min_degree (adds ring edges).

    ``min_degree=0`` skips the patching and may leave isolated nodes —
    the padded-table path represents those as all-invalid rows and the
    aggregation keeps their local model (mobility scenarios use this).
    """
    rng = np.random.default_rng(seed)
    upper = rng.random((n, n)) < p
    adj = np.triu(upper, 1)
    adj = adj | adj.T
    # guarantee connectivity floor with a ring
    if min_degree > 0:
        for i in range(n):
            if adj[i].sum() < min_degree:
                adj[i, (i + 1) % n] = adj[(i + 1) % n, i] = True
    return adj


def spaced_malicious(n: int, n_mal: int) -> np.ndarray:
    """Evenly spaced malicious placement.

    For the paper's 20-node/2-malicious 8-regular setup this reproduces the
    'at most 25% malicious neighbors' property (and matches Fig. 7's nodes
    5 and 11 up to rotation).
    """
    mal = np.zeros(n, dtype=bool)
    if n_mal > 0:
        idx = (np.arange(n_mal) * n) // n_mal + n // (2 * max(n_mal, 1))
        mal[idx % n] = True
    return mal


def close_malicious(n: int, n_mal: int, degree: int = 8) -> np.ndarray:
    """Malicious nodes placed degree/2 apart on the ring so that some
    benign nodes see 0, some 1 and some 2 malicious neighbors — this is
    the placement that populates every 'decentralized m.n.' column of the
    paper's Table I (with spaced placement no node ever has 2)."""
    mal = np.zeros(n, dtype=bool)
    step = max(1, degree // 2)
    for i in range(n_mal):
        mal[(i * step) % n] = True
    return mal


def padded_neighbor_table(adj: np.ndarray, width: int = None):
    """(table (N, K_max) int32, valid (N, K_max) bool) for ANY graph.

    Padded slots carry the node's OWN index: the indexed aggregation
    kernels DMA that row like any other candidate (always a finite,
    in-bounds address) and the valid mask excludes it from every
    median/mask/score computation downstream.  Degree-0 rows (a fully
    churned-out node) come back all-invalid and all-self — still a safe
    DMA target, and the valid-aware aggregation keeps the local model.

    ``width`` forces the table to a wider K than this graph needs — the
    schedule builders use it so every round of a dynamic topology shares
    ONE (N, K) shape (no retrace when the graph changes).
    """
    n = adj.shape[0]
    degs = adj.sum(axis=1).astype(np.int64)
    k_max = max(1, int(degs.max()))
    if width is not None:
        if width < k_max:
            raise ValueError(f"width {width} < max degree {k_max}")
        k_max = max(1, int(width))
    table = np.empty((n, k_max), dtype=np.int32)
    valid = np.zeros((n, k_max), dtype=bool)
    for i in range(n):
        nbrs = np.nonzero(adj[i])[0]
        table[i, : len(nbrs)] = nbrs
        table[i, len(nbrs):] = i
        valid[i, : len(nbrs)] = True
    return table, valid


def make_topology(
    n_nodes: int = 20,
    degree: int = 8,
    n_malicious: int = 2,
    kind: str = "ring",
    seed: int = 0,
    placement: str = "spaced",    # spaced | close
) -> Topology:
    if kind == "ring":
        adj = ring_lattice(n_nodes, degree)
    elif kind == "complete":
        adj = complete_graph(n_nodes)
        degree = n_nodes - 1
    elif kind == "erdos_renyi":
        adj = erdos_renyi(n_nodes, degree / (n_nodes - 1), seed=seed)
    else:
        raise ValueError(f"unknown topology kind {kind!r}")
    mal = (close_malicious(n_nodes, n_malicious, degree)
           if placement == "close" else spaced_malicious(n_nodes, n_malicious))
    table, valid = padded_neighbor_table(adj)
    return Topology(n_nodes=n_nodes, adjacency=adj, neighbor_indices=table,
                    malicious=mal, neighbor_valid=valid)


def paper_topology() -> Topology:
    """The paper's validation scenario: 20 nodes, 8-regular ring, 2 malicious."""
    return make_topology(n_nodes=20, degree=8, n_malicious=2, kind="ring")
