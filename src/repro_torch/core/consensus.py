"""SOP-consensus ("gossip") data parallelism: the paper's technique applied
to distributed neural-network training (port of ``repro.core.consensus``).

Mapping: data-parallel replica i  <->  sensor i; replica parameters theta_i
<->  the sensor's local function f_i; the coupling constraint f_i = f_j for
neighbors  <->  the consensus subspace C_ij = {theta : theta_i = theta_j}.
The orthogonal projection onto C_ij replaces theta_i and theta_j by their
average, so SOP over a *pairing schedule* is a sequence of exact pairwise
parameter averagings.  Lemma 3.1 ("fully connected = centralized") maps to:
a full hypercube sweep of pairwise projections equals the all-reduce mean.

Two execution modes:
  * device mode: one process per replica in a ``torch.distributed`` group,
    which takes the place of the reference's mesh axis name.  The leaves
    of a tree are packed into one flat buffer per dtype, so one collective
    moves a whole model; the reference's ``ppermute`` is an
    ``all_to_all_single`` in which each rank sends its buffer to one rank
    and receives one (it works with the partner equal to the rank, so a
    world of one issues the same collectives);
  * sim mode: replicas stacked on axis 0 of every leaf (tests, one device).

Trees are those of ``repro_torch.tree``; an ``nn.Module`` is averaged in
place and returned.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .. import tree as T

Tree = T.Tree


# --------------------------------------------------------------------------
# Pairing schedules (partner[i] = who replica i projects with this round).
# --------------------------------------------------------------------------


def hypercube_schedule(n: int) -> list[list[int]]:
    """log2(n) rounds of partner = i XOR 2^d.  Full sweep == global mean."""
    if n & (n - 1):
        raise ValueError(f"hypercube schedule needs power-of-two replicas, got {n}")
    return [[i ^ (1 << d) for i in range(n)] for d in range(int(math.log2(n)))]


def ring_schedule(n: int) -> list[list[int]]:
    """Two alternating even/odd pairings on a ring (the relaxed topology)."""
    if n % 2:
        raise ValueError("ring schedule needs an even replica count")
    even = [i ^ 1 for i in range(n)]  # (0,1)(2,3)...
    odd = [(i - 1) % n if i % 2 == 0 else (i + 1) % n for i in range(n)]
    return [even, odd]


def one_sided_ring_schedule(n: int) -> list[list[int]]:
    """Neighborhood averaging with both ring neighbors (Cimmino-style
    simultaneous projection): theta_i <- (theta_{i-1} + theta_i + theta_{i+1})/3.
    Returned as two shift permutations; see ``neighborhood_average``.
    """
    fwd = [(i + 1) % n for i in range(n)]
    bwd = [(i - 1) % n for i in range(n)]
    return [fwd, bwd]


def schedule(name: str, n: int) -> list[list[int]]:
    if name == "hypercube":
        return hypercube_schedule(n)
    if name == "ring":
        return ring_schedule(n)
    raise ValueError(f"unknown gossip schedule {name!r}")


# --------------------------------------------------------------------------
# Device mode (one process per replica, ``group`` for the axis name).
# --------------------------------------------------------------------------


def _flat_buffers(xs: list[torch.Tensor]):
    """(leaf indices, one flat buffer of those leaves) per (dtype, device),
    in leaf order."""
    groups: dict[tuple, list[int]] = {}
    for i, x in enumerate(xs):
        groups.setdefault((x.dtype, x.device), []).append(i)
    for idx in groups.values():
        yield idx, torch.cat([xs[i].reshape(-1) for i in idx])


def _flat_map(tree: Tree, fn) -> Tree:
    """``fn`` over one flat buffer per (dtype, device) of ``tree``'s leaves;
    ``fn`` returns a buffer of the same size."""
    xs = T.leaves(tree)
    out = list(xs)
    with torch.no_grad():
        for idx, buf in _flat_buffers(xs):
            pieces = torch.split(fn(buf), [xs[i].numel() for i in idx])
            for i, piece in zip(idx, pieces):
                out[i] = piece.view(xs[i].shape)
    return T.rebuild(tree, out)


def _permute(buf: torch.Tensor, group, dest: list[int]) -> torch.Tensor:
    """The buffer of the rank that sends here, where rank i sends to
    ``dest[i]`` (the reference's ``ppermute`` pairs ``(i, dest[i])``)."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if sorted(dest) != list(range(world)):
        raise ValueError(f"{dest} is not a permutation of the {world} ranks")
    src, n = dest.index(rank), buf.numel()
    out = torch.empty_like(buf)
    dist.all_to_all_single(
        out, buf,
        output_split_sizes=[n if j == src else 0 for j in range(world)],
        input_split_sizes=[n if j == dest[rank] else 0 for j in range(world)],
        group=group,
    )
    return out


def _mean(buf: torch.Tensor, group) -> torch.Tensor:
    """All-reduce SUM, then one divide that every rank applies identically
    (so replicas stay bitwise equal)."""
    out = buf.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out / dist.get_world_size(group)


def pairwise_project(params: Tree, group, partners: list[int]) -> Tree:
    """One SOP projection onto intersect_{paired (i,j)} C_ij.

    ``partners`` must be an involution (partner[partner[i]] == i).
    """
    return _flat_map(params, lambda x: 0.5 * (x + _permute(x, group, partners)))


def neighborhood_average(params: Tree, group, n: int) -> Tree:
    """Cimmino-style simultaneous projection over ring neighborhoods:
    rank j averages x_{j-1}, x_j and x_{j+1}.

    Formed as x_j + ((x_{j-1} - x_j) + (x_{j+1} - x_j)) / 3, the
    reference's (x_j + x_{j-1} + x_{j+1}) / 3 up to rounding, so replicas
    at consensus (a world of one included) stay bitwise where they are.
    """
    fwd = [(i + 1) % n for i in range(n)]
    bwd = [(i - 1) % n for i in range(n)]

    def avg(x):
        return x + ((_permute(x, group, fwd) - x) + (_permute(x, group, bwd) - x)) / 3.0

    return _flat_map(params, avg)


def gossip_round(params: Tree, group, sched: list[list[int]], round_idx: int) -> Tree:
    """Apply the round_idx-th pairing of a schedule (round-robin)."""
    return pairwise_project(params, group, sched[round_idx % len(sched)])


def allreduce_average(params: Tree, group) -> Tree:
    """The centralized special case (complete graph; paper Lemma 3.1)."""
    return _flat_map(params, lambda x: _mean(x, group))


def consensus_sq_distance(params: Tree, group) -> torch.Tensor:
    """sum_i ||theta_i - mean||^2, the Fejer-monotone disagreement metric;
    the same 0-d tensor on every rank, summed in at least float32."""
    per = None
    with torch.no_grad():
        for _, buf in _flat_buffers(T.leaves(params)):
            wd = torch.promote_types(buf.dtype, torch.float32)
            part = torch.sum((buf - _mean(buf, group)) ** 2, dtype=wd)
            per = part if per is None else per + part
        dist.all_reduce(per, op=dist.ReduceOp.SUM, group=group)
    return per


# --------------------------------------------------------------------------
# Sim mode: replicas stacked on axis 0 of every leaf.
# --------------------------------------------------------------------------


def sim_pairwise_project(stacked: Tree, partners: list[int]) -> Tree:
    return T.tree_map(
        lambda x: 0.5 * (x + x[torch.as_tensor(partners, device=x.device)]), stacked
    )


def sim_gossip_sweep(stacked: Tree, sched: list[list[int]]) -> Tree:
    for partners in sched:
        stacked = sim_pairwise_project(stacked, partners)
    return stacked


def sim_consensus_sq_distance(stacked: Tree) -> torch.Tensor:
    total = None
    for x in T.leaves(stacked):
        part = torch.sum((x - torch.mean(x, dim=0, keepdim=True)) ** 2)
        total = part if total is None else total + part
    return total
