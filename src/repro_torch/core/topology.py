"""Sparse gossip topologies: static mixing matrices over the worker axis
(counterpart of ``repro.core.topology``, the port's own copy).

A topology is a **column-stochastic mixing matrix** P per phase: column j
says how worker j splits its mass among its out-neighbours
(Σ_i P[i,j] = 1), and worker i receives ``mix_i = Σ_j P[i,j]·x_j``.
:class:`repro_torch.core.strategy.GossipPushSumStrategy` owns the
push-weight recursion that debiases the received mixes.

Three families, all with self-loops and doubly stochastic when every worker
is live (push weights then stay at w ≡ 1):

* ``full`` — P = 1/m everywhere, one phase;
* ``ring`` — one phase, each worker averages with its two ring neighbours
  (weights 1/3; ``full`` for m ≤ 2);
* ``exp`` — one-peer exponential: ⌈log2 m⌉ phases cycled round-robin; in
  phase l worker j keeps half its mass and pushes half to ``(j + 2^l) mod m``.

:func:`compose_membership` zeroes a dead worker's row and column and
renormalises every live column to sum to 1 (the SGP recipe).

On a worker mesh (W ranks, each holding m/W consecutive workers) a push is a
neighbour exchange: :func:`rank_peers` gives, for each rank at a phase, the
rows it sends to each peer and the rows it receives from each, read off
``in_mask(phase)``. The membership does not enter it: composing one zeroes
dead rows and columns in Peff's weights, so the transport schedule is static.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

TOPOLOGIES = ("full", "ring", "exp")


@dataclass(frozen=True)
class Topology:
    """A static, phase-cycled gossip topology over ``m`` workers. ``mats`` is
    the (L, m, m) float32 stack of column-stochastic matrices; round r uses
    phase ``r % L``. ``degree`` is the most *other* in-neighbours a worker
    waits on in one round."""

    name: str
    m: int
    mats: np.ndarray = field(repr=False)

    def __post_init__(self):
        assert self.mats.ndim == 3 and self.mats.shape[1:] == (self.m, self.m), self.mats.shape
        assert np.allclose(self.mats.sum(axis=1), 1.0, atol=1e-6), "mixing matrices must be column-stochastic"

    @property
    def num_phases(self) -> int:
        return int(self.mats.shape[0])

    @property
    def is_full(self) -> bool:
        return self.name == "full"

    @property
    def degree(self) -> int:
        off_diag = ~np.eye(self.m, dtype=bool)
        return max(int((self.in_mask(l) & off_diag).sum(axis=1).max()) for l in range(self.num_phases))

    def matrix(self, r: int) -> np.ndarray:
        """Round r's (m, m) mixing matrix (phase ``r % num_phases``)."""
        return self.mats[r % self.num_phases]

    def in_mask(self, r: int) -> np.ndarray:
        """(m, m) bool: does worker i receive from j in round r (self-loops
        included)?"""
        return self.matrix(r) > 0


def _full_matrix(m: int) -> np.ndarray:
    return np.full((1, m, m), 1.0 / m, np.float32)


def _ring_matrix(m: int) -> np.ndarray:
    if m <= 2:
        return _full_matrix(m)
    P = np.zeros((m, m), np.float32)
    for j in range(m):
        for i in (j - 1, j, j + 1):
            P[i % m, j] = 1.0 / 3.0
    return P[None]


def _exp_matrices(m: int) -> np.ndarray:
    if m == 1:
        return np.ones((1, 1, 1), np.float32)
    L = max(1, int(math.ceil(math.log2(m))))
    mats = np.zeros((L, m, m), np.float32)
    for l in range(L):
        off = pow(2, l) % m
        for j in range(m):
            mats[l, j, j] += 0.5
            mats[l, (j + off) % m, j] += 0.5
    return mats


def make_topology(name: str, m: int) -> Topology:
    """The named topology (``full``/``ring``/``exp``) over ``m`` workers."""
    if m < 1:
        raise ValueError(f"topology needs at least one worker, got m={m}")
    matrices = {"full": _full_matrix, "ring": _ring_matrix, "exp": _exp_matrices}
    if name not in matrices:
        raise ValueError(f"unknown topology {name!r}; known: {TOPOLOGIES}")
    return Topology(name=name, m=m, mats=matrices[name](m))


def compose_membership(P, mask) -> torch.Tensor:
    """An (m, m) mixing matrix composed with an (m,) {0, 1} live mask: dead
    rows and columns zeroed, every live column renormalised to sum to 1.
    Returns a float32 tensor on the mask's device (a numpy mask: the CPU)."""
    mask = torch.as_tensor(mask)
    live = (mask > 0).to(torch.float32)
    Pm = torch.as_tensor(P, dtype=torch.float32, device=live.device) * live[:, None] * live[None, :]
    col = torch.sum(Pm, dim=0)
    return Pm / torch.where(col > 0, col, torch.ones_like(col))[None, :]


_CACHE: Dict[Tuple[str, int], Topology] = {}


def cached_topology(name: str, m: int) -> Topology:
    """Memoised :func:`make_topology`."""
    key = (name, m)
    if key not in _CACHE:
        _CACHE[key] = make_topology(name, m)
    return _CACHE[key]


@dataclass(frozen=True)
class RankPeers:
    """One rank's neighbour exchange at one phase: ``rows`` its workers
    ``[lo, hi)``; ``send`` (peer rank, the global indices of this rank's
    rows that peer's rows receive from) and ``recv`` (peer rank, the global
    indices of that peer's rows this rank's rows receive from), peers
    ascending, rows ascending."""

    rank: int
    rows: Tuple[int, int]
    send: Tuple[Tuple[int, Tuple[int, ...]], ...]
    recv: Tuple[Tuple[int, Tuple[int, ...]], ...]

    @property
    def received(self) -> Tuple[int, ...]:
        """The received rows' global indices, ascending (the order of the
        receive buffer)."""
        return tuple(sorted(j for _, rows in self.recv for j in rows))

    @property
    def held(self) -> Tuple[int, ...]:
        """Every row this rank's mix reads, its own and the received ones,
        ascending: the order of the mix's sum."""
        return tuple(sorted(set(range(*self.rows)) | set(self.received)))


def rank_peers(topo: Topology, m: int, W: int, phase: int) -> Tuple[RankPeers, ...]:
    """The neighbour exchange of ``topo`` over m workers spread over W ranks
    (rank q holds rows ``[q·m/W, (q+1)·m/W)``) at ``phase`` (taken modulo
    the topology's phases): for each rank, whom it sends its rows to and
    whom it receives rows from. Worker i receives from j where
    ``in_mask(phase)[i, j]``; rows on the same rank move nothing."""
    if topo.m != m or m % W or W < 1:
        raise ValueError(f"rank_peers: a topology over {topo.m} workers cannot spread m={m} over {W} ranks")
    per = m // W
    mask = topo.in_mask(phase % topo.num_phases)
    out = []
    for q in range(W):
        lo, hi = q * per, (q + 1) * per
        send, recv = [], []
        for p in range(W):
            if p == q:
                continue
            plo, phi = p * per, (p + 1) * per
            # rows of q that some row of p receives from; rows of p that some row of q receives from
            to_p = tuple(j for j in range(lo, hi) if mask[plo:phi, j].any())
            from_p = tuple(j for j in range(plo, phi) if mask[lo:hi, j].any())
            if to_p:
                send.append((p, to_p))
            if from_p:
                recv.append((p, from_p))
        out.append(RankPeers(rank=q, rows=(lo, hi), send=tuple(send), recv=tuple(recv)))
    return tuple(out)


_PEERS: Dict[Tuple[str, int, int, int], Tuple[RankPeers, ...]] = {}


def cached_rank_peers(name: str, m: int, W: int, phase: int) -> Tuple[RankPeers, ...]:
    """Memoised :func:`rank_peers` of the named topology (phase modulo its
    phases)."""
    topo = cached_topology(name, m)
    key = (name, m, W, phase % topo.num_phases)
    if key not in _PEERS:
        _PEERS[key] = rank_peers(topo, m, W, key[3])
    return _PEERS[key]
