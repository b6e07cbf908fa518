"""Fanout neighbor sampling (the paper's default: GraphSAGE-style, fanout 15,
3 GNN layers, batch size 1024).

Sampling is a host-side pipeline stage producing numpy index structures; the
device only ever consumes padded static-shape arrays (DESIGN.md §3). Layer
numbering follows the paper: targets live at layer ``L`` (top), input features
at layer ``0`` (bottom); sampling proceeds top-down.

Semantics: for a frontier vertex with degree ``d`` we take all ``d`` in-edges
when ``d <= fanout``; otherwise we draw ``fanout`` uniform slots with
replacement and de-duplicate (standard GraphSAGE neighbor sampling).
Zero-degree vertices contribute a self-loop so every vertex has at least one
message source.

A numpy copy of ``repro.graph.sampling`` (the port imports nothing of the
JAX package); ``tests/test_torch_trainer.py`` pins the two to bitwise-equal
plans.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.graph.csr import CSRGraph


@dataclass
class LayerSample:
    """Edges sampled for one layer transition (layer l sources -> layer l+1 dsts)."""

    src: np.ndarray  # (num_edges,) global vertex ids at layer l
    dst: np.ndarray  # (num_edges,) global vertex ids at layer l+1
    edge_id: np.ndarray  # (num_edges,) global CSR edge id (-1 for self loops)

    @property
    def num_edges(self) -> int:
        return int(self.src.shape[0])


@dataclass
class MiniBatchSample:
    """A sampled k-hop mini-batch.

    ``layers[i]`` holds the edges between layer ``L-1-i`` and ``L-i``
    (``layers[0]`` is the top transition, sampled first). ``frontiers[i]`` is
    the unique vertex set at layer ``L-i`` (``frontiers[0]`` == targets,
    ``frontiers[L]`` == input vertices whose features are loaded).
    """

    target_ids: np.ndarray
    layers: list[LayerSample]
    frontiers: list[np.ndarray]

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    @property
    def input_ids(self) -> np.ndarray:
        return self.frontiers[-1]


def _sample_layer(
    graph: CSRGraph, frontier: np.ndarray, fanout: int, rng: np.random.Generator
) -> LayerSample:
    """Sample the in-neighborhood of every frontier vertex."""
    indptr, indices = graph.indptr, graph.indices
    deg = (indptr[frontier + 1] - indptr[frontier]).astype(np.int64)

    # --- take-all group (deg <= fanout, deg > 0) -------------------------
    small = (deg <= fanout) & (deg > 0)
    sf = frontier[small]
    sd = deg[small]
    if sf.size:
        dst_small = np.repeat(sf, sd)
        starts = np.repeat(indptr[sf], sd)
        # within-row offsets 0..d-1 for each vertex
        csum = np.concatenate([[0], np.cumsum(sd)])
        offs = np.arange(int(sd.sum()), dtype=np.int64) - np.repeat(csum[:-1], sd)
        eid_small = starts + offs
        src_small = indices[eid_small].astype(np.int64)
    else:
        dst_small = src_small = eid_small = np.empty(0, dtype=np.int64)

    # --- sampled group (deg > fanout): fanout slots w/ replacement, dedup -
    big = deg > fanout
    bf = frontier[big]
    bd = deg[big]
    if bf.size:
        slots = (rng.random((bf.size, fanout)) * bd[:, None]).astype(np.int64)
        eid_big = (indptr[bf][:, None] + slots).reshape(-1)
        dst_big = np.repeat(bf, fanout)
        # de-duplicate repeated draws of the same edge
        key = dst_big * (graph.num_edges + 1) + eid_big
        _, uniq = np.unique(key, return_index=True)
        eid_big = eid_big[uniq]
        dst_big = dst_big[uniq]
        src_big = indices[eid_big].astype(np.int64)
    else:
        dst_big = src_big = eid_big = np.empty(0, dtype=np.int64)

    # --- zero-degree: self loop ------------------------------------------
    zf = frontier[deg == 0]
    dst_zero = src_zero = zf.astype(np.int64)
    eid_zero = np.full(zf.size, -1, dtype=np.int64)

    src = np.concatenate([src_small, src_big, src_zero])
    dst = np.concatenate([dst_small, dst_big, dst_zero])
    eid = np.concatenate([eid_small, eid_big, eid_zero])
    return LayerSample(src=src, dst=dst, edge_id=eid)


def sample_minibatch(
    graph: CSRGraph,
    targets: np.ndarray,
    fanouts: list[int],
    rng: np.random.Generator,
) -> MiniBatchSample:
    """Sample a k-hop mini-batch top-down (``fanouts[0]`` is the top layer)."""
    targets = np.asarray(targets, dtype=np.int64)
    frontiers = [np.unique(targets)]
    layers: list[LayerSample] = []
    frontier = frontiers[0]
    for fanout in fanouts:
        layer = _sample_layer(graph, frontier, fanout, rng)
        layers.append(layer)
        # next-layer vertex set: self vertices + sampled sources
        frontier = np.unique(np.concatenate([frontier, layer.src]))
        frontiers.append(frontier)
    return MiniBatchSample(target_ids=targets, layers=layers, frontiers=frontiers)


class NeighborSampler:
    """Epoch iterator over shuffled target batches -> MiniBatchSample.

    ``sample``/``sample_batch`` sample one batch of ``batch_size`` targets
    (split parallelism, Table 1 "Mini"); ``sample_micro``/
    ``sample_micro_batch`` sample ``num_devices`` independent micro-batches
    of about ``batch_size // num_devices`` (data parallelism, Table 1
    "Micro").

    Two RNG disciplines coexist:

      * the legacy *streamed* API (``epoch_batches`` / ``sample`` /
        ``sample_micro``) advances one shared generator in call order, and
      * the *keyed* API (``epoch_targets`` / ``sample_batch`` /
        ``sample_micro_batch``) derives an independent generator from
        ``(seed, epoch, batch)``, so any thread can sample any batch and get
        the same draws — the contract the pipelined runtime needs for
        serial-equals-pipelined determinism (DESIGN.md §6).
    """

    def __init__(
        self,
        graph: CSRGraph,
        train_ids: np.ndarray,
        fanouts: list[int],
        batch_size: int,
        seed: int = 0,
    ):
        self.graph = graph
        self.train_ids = np.asarray(train_ids, dtype=np.int64)
        self.fanouts = list(fanouts)
        self.batch_size = batch_size
        self.seed = seed
        self.rng = np.random.default_rng(seed)

    def _slice_batches(self, ids: np.ndarray) -> list[np.ndarray]:
        """Slice a permuted id vector into target batches.

        Short-batch contract (shared by both RNG disciplines): with
        ``n <= batch_size`` one (short) batch, so an epoch always yields at
        least one batch; otherwise the trailing remainder is dropped and
        every batch has exactly ``batch_size`` targets (the JAX package's
        ``drop_last=True``, the only setting training uses).
        """
        n = ids.shape[0]
        if n <= self.batch_size:
            return [ids]  # fewer targets than a batch: one (short) batch
        stop = n - (n % self.batch_size)
        return [
            ids[i : i + self.batch_size]
            for i in range(0, stop, self.batch_size)
        ]

    def epoch_batches(self):
        """Streamed-API epoch: permute + slice, advancing the shared rng.

        Draw-order dependent by design (each call mutates ``self.rng``) —
        kept for offline code that replays the historical stream. Anything
        running under the pipelined runtime must use ``epoch_targets``.
        """
        yield from self._slice_batches(self.rng.permutation(self.train_ids))

    def sample(self, targets: np.ndarray) -> MiniBatchSample:
        """Streamed-API sampling: consumes the shared rng in call order."""
        return sample_minibatch(self.graph, targets, self.fanouts, self.rng)

    def sample_micro(self, targets: np.ndarray, num_devices: int) -> list[MiniBatchSample]:
        """Data-parallel micro-batching: partition targets, sample independently.

        Streamed discipline: the ``num_devices`` micro-samples consume the
        shared rng sequentially, so results depend on call order.
        """
        parts = np.array_split(targets, num_devices)
        return [self.sample(p) for p in parts]

    # ---- keyed API: order-independent draws for the pipelined runtime ---- #
    def _keyed_rng(self, *key: int) -> np.random.Generator:
        """An independent generator derived from ``(seed, *key)``.

        The keyed-RNG discipline (DESIGN.md §6): every consumer that may run
        off-thread or out of order derives its stream from static integers —
        ``(seed, salt, epoch, batch[, micro])`` — never from a shared
        generator.
        """
        return np.random.default_rng((self.seed, *key))

    def epoch_targets(self, epoch: int) -> list[np.ndarray]:
        """The epoch's target batches as a list, permuted by ``(seed, epoch)``."""
        return self._slice_batches(
            self._keyed_rng(0x9E7, epoch).permutation(self.train_ids)
        )

    def sample_batch(
        self, targets: np.ndarray, epoch: int, batch: int
    ) -> MiniBatchSample:
        """Sample one mini-batch with draws keyed by ``(seed, epoch, batch)``."""
        rng = self._keyed_rng(0x5A3, epoch, batch)
        return sample_minibatch(self.graph, targets, self.fanouts, rng)

    def sample_micro_batch(
        self, targets: np.ndarray, num_devices: int, epoch: int, batch: int
    ) -> list[MiniBatchSample]:
        """Keyed counterpart of ``sample_micro`` (one rng per micro-batch)."""
        parts = np.array_split(targets, num_devices)
        return [
            sample_minibatch(
                self.graph, p, self.fanouts, self._keyed_rng(0x5A3, epoch, batch, i)
            )
            for i, p in enumerate(parts)
        ]
