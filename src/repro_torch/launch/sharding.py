"""The (replica, split) mesh of ranks and each rank's slice of the arrays,
the counterpart of the GNN part of ``repro/launch/sharding.py``.

The JAX package states where each array lives as a ``PartitionSpec`` and
``shard_map`` hands each device its slice. Here one process runs one split
of one replica, so the specs become slicers: each takes the rank's slice of
a plan, cache or shard array, with the same rules.

  * plan arrays (every array ``plan_io`` stages, the labels and the feature
    or miss block): a mesh batch holds R parts (``MeshPlanBatch``), each
    with a leading split axis P; the rank takes its replica's part and row
    ``p`` of the split axis (``plan_slice``).
  * the cache: the (P, C, F) resident block and every ``CachePlan`` array
    lead with the split axis (the owner for ``send_slot``, the needer for
    ``recv_pos``/``recv_mask``), the same in every replica group.
  * the replicated hot-vertex block: the same on every rank, used whole.
  * the sampler's CSR shards: ``indptr``/``indices``/``edge_id`` and
    ``num_local`` by split; the O(V) ``owner``/``local_row`` maps whole
    (``sampler_shard_slice``).

Every slice keeps the split axis with length 1, so the layers, the fused
kernels and the send gather's adjoint run on a rank as they do on all P
splits. Every array that the staging produces holds only its own split's
entries (indices into its own rows, edges and packs), so slicing row ``p``
is the whole of the per-rank rebuild; ``split_slice`` refuses an array
whose leading axis is not P.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch.distributed as dist

#: the sampler shards' O(V) maps, replicated on every rank
REPLICATED_SHARD_KEYS = ("owner", "local_row")


@dataclass(frozen=True)
class SplitMesh:
    """A rank's place on the (R, P) mesh: replica ``replica``, split
    ``split`` (rank = replica * P + split, the split axis minor), with the
    process group of its replica's P splits (the exchanges) and the group
    of the R ranks that hold its split in every replica (the gradient
    mean)."""

    num_replicas: int
    num_splits: int
    replica: int
    split: int
    split_group: object
    replica_group: object


def make_split_mesh(num_replicas: int = 1, num_splits: int = 1) -> SplitMesh:
    """The 2-D (replica, split) mesh over the default process group, whose
    world must be R * P ranks. The split axis is minor, as in the JAX
    package: on machines whose rank order follows interconnect locality the
    P ranks of a replica group are neighbours, so the layer shuffles, the
    cache fetch and the sampler exchange stay on the fast links while only
    the once-a-step gradient mean crosses replica groups. ``R == 1`` is the
    1-D split mesh. Every rank creates every group, in one order (as
    ``dist.new_group`` requires)."""
    if num_replicas < 1 or num_splits < 1:
        raise ValueError(
            f"mesh axes must be >= 1, got R={num_replicas} P={num_splits}"
        )
    world = dist.get_world_size()
    if world != num_replicas * num_splits:
        raise ValueError(
            f"a {num_replicas} x {num_splits} mesh needs "
            f"{num_replicas * num_splits} ranks, the process group has {world}"
        )
    rank = dist.get_rank()
    replica, split = divmod(rank, num_splits)
    split_groups = [
        dist.new_group([r * num_splits + p for p in range(num_splits)])
        for r in range(num_replicas)
    ]
    replica_groups = [
        dist.new_group([r * num_splits + p for r in range(num_replicas)])
        for p in range(num_splits)
    ]
    return SplitMesh(num_replicas, num_splits, replica, split,
                     split_groups[replica], replica_groups[split])


def split_slice(a, mesh: SplitMesh):
    """Row ``mesh.split`` of ``a``'s leading split axis, kept as an axis of
    length 1 (a view). Raises unless that axis is P long."""
    if a.ndim == 0 or a.shape[0] != mesh.num_splits:
        raise ValueError(
            f"an array of shape {tuple(a.shape)} has no leading split axis "
            f"of {mesh.num_splits}"
        )
    return a[mesh.split:mesh.split + 1]


def plan_slice(tree, mesh: SplitMesh):
    """The rank's slice of a plan dict (``plan_io``'s keys, ``"cache"``
    included), a cache plan, or a single array: every array sliced by
    ``split_slice``."""
    if isinstance(tree, dict):
        return {k: plan_slice(v, mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(plan_slice(v, mesh) for v in tree)
    return split_slice(tree, mesh)


def sampler_shard_slice(dev: dict, mesh: SplitMesh) -> dict:
    """The rank's CSR shard (``shards_to_device`` keys): its split's
    ``indptr``/``indices``/``edge_id``/``num_local``, and the whole
    ``owner``/``local_row`` maps (every split routes any vertex to its owner
    in O(1))."""
    return {k: (v if k in REPLICATED_SHARD_KEYS else split_slice(v, mesh))
            for k, v in dev.items()}
