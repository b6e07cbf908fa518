"""Offline pre-sampling stage (paper §5, "Finding the global partitioning
function").

Runs the *same* sampling algorithm used during training for a fixed number of
epochs and accumulates

  ``k_v`` -- number of times vertex ``v`` appears at a layer ``l > 0``
             (i.e. in any non-input frontier: it will be sampled *and* its
             hidden feature computed there), and
  ``k_e`` -- number of times edge ``e`` is sampled, across all layers.

The weighted graph ``G_w`` has ``w_V(v) = k_v / N`` and ``w_E(e) = k_e / N``
with ``N`` the number of pre-sampling epochs. The paper finds 10 epochs
sufficient (§7.3); that is our default.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from repro_torch.graph.csr import CSRGraph
from repro_torch.graph.sampling import NeighborSampler


@dataclass
class PresampleWeights:
    """Weighted graph G_w from the pre-sampling stage."""

    vertex_weight: np.ndarray  # (num_nodes,) float64 = k_v / N
    edge_weight: np.ndarray  # (num_edges,) float64 = k_e / N, CSR edge order
    num_epochs: int


def _accumulate(k_v: np.ndarray, k_e: np.ndarray, mbs) -> None:
    """Add the vertex/edge appearance counts of ``mbs`` into ``k_v``/``k_e``.

    ``mbs`` is an iterable of mini-batches — typically one full epoch, which
    is what makes the ``np.bincount`` formulation scale: the histogram runs
    over the *sampled* indices of every batch in the call, and the dense
    O(num_nodes + num_edges) count-array add is paid once per call instead
    of once per batch (at full Orkut/Papers100M edge counts a per-batch
    dense add would dominate; per epoch it amortizes to noise). Versus the
    old per-batch ``np.add.at``: ``ufunc.at`` was historically an unbuffered
    per-element loop and orders of magnitude slower; numpy >= 1.24 gave
    integer ``add.at`` a fast indexed path, so ``benchmarks/presample_cost.py``
    measures both formulations so the trade stays visible as numpy or the
    graph scale changes.

    Layers ``l > 0`` are all non-input frontiers (``frontiers[0..L-1]``);
    self-loop sentinels (``edge_id == -1``) are not CSR edges and are
    excluded. Only the index arrays are buffered (references into each
    mini-batch), so a generator of samples streams through without holding
    the epoch's samples alive.
    """
    vparts: list[np.ndarray] = []
    eparts: list[np.ndarray] = []
    for mb in mbs:
        vparts.extend(mb.frontiers[:-1])
        eparts.extend(layer.edge_id for layer in mb.layers)
    verts = np.concatenate(vparts)
    k_v += np.bincount(verts, minlength=k_v.shape[0])
    eids = np.concatenate(eparts)
    eids = eids[eids >= 0]
    k_e += np.bincount(eids, minlength=k_e.shape[0])


def presample(
    graph: CSRGraph,
    train_ids: np.ndarray,
    fanouts: list[int],
    batch_size: int,
    num_epochs: int = 10,
    seed: int = 0,
    workers: int = 1,
) -> PresampleWeights:
    """Accumulate k_v / k_e over ``num_epochs`` of simulated sampling.

    ``workers == 1`` replays the historical single-generator stream.
    ``workers > 1`` parallelizes across epochs with the sampler's keyed RNG
    API — each epoch's draws depend only on ``(seed, epoch, batch)``, so the
    result is deterministic and independent of scheduling (integer counts
    summed in epoch order, no shared mutable state). Both paths are
    individually reproducible, but they draw *different* streams: flipping
    the knob changes the weights (hence the partition and downstream
    trajectories). Keep it fixed within any experiment being compared.

    Both paths iterate epochs with ``drop_last=True`` batch slicing (the
    training default): the trailing remainder batch contributes no counts
    unless the whole training set fits in one (short) batch — matching what
    the trainer will actually sample, which is the load the partitioner
    should balance.
    """
    sampler = NeighborSampler(graph, train_ids, fanouts, batch_size, seed=seed)
    k_v = np.zeros(graph.num_nodes, dtype=np.int64)
    k_e = np.zeros(graph.num_edges, dtype=np.int64)
    if workers <= 1:
        for _ in range(num_epochs):
            _accumulate(
                k_v, k_e, (sampler.sample(t) for t in sampler.epoch_batches())
            )
    else:
        def one_epoch(epoch: int):
            ev = np.zeros(graph.num_nodes, dtype=np.int64)
            ee = np.zeros(graph.num_edges, dtype=np.int64)
            _accumulate(
                ev, ee,
                (
                    sampler.sample_batch(t, epoch, i)
                    for i, t in enumerate(sampler.epoch_targets(epoch))
                ),
            )
            return ev, ee

        with ThreadPoolExecutor(max_workers=workers) as pool:
            for ev, ee in pool.map(one_epoch, range(num_epochs)):
                k_v += ev
                k_e += ee
    n = float(num_epochs)
    return PresampleWeights(
        vertex_weight=k_v / n, edge_weight=k_e / n, num_epochs=num_epochs
    )
