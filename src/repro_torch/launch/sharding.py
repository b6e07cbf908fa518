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

The transformer half (``param_specs``, ``batch_specs``, ``cache_specs``)
states, with the JAX package's rules, how each parameter, batch and cache
leaf lies on the (data, model) mesh of ``launch/mesh.py``: tensor
parallelism over ``model`` (attention heads, the MLP's hidden width, the
vocabulary, MoE experts, the SSM's inner width), the batch over ``("pod",
"data")``. A spec is a tuple with one entry per dimension: None, an axis
name, or a tuple of axis names, equal to the JAX ``PartitionSpec``'s
entries (a single data axis is its name, as ``PartitionSpec`` has it). A
shard axis that does not divide its dimension is dropped (the leaf is
replicated along it), with two fallbacks in the caches: MQA's k/v (one KV
head) and MLA's latents (no head dimension) are sharded by sequence over
``model``. Where the JAX tree stacks the scanned blocks on a leading layer
axis, and its specs lead with None for it, the port's per-layer ``Block``s
have no such axis. The slicers (``param_slice``, ``cache_slice``,
``batch_slice``) take a rank's slice of each leaf by its spec, as a tensor
of its own, so the rank keeps nothing of the rest.

``opt_state_specs`` gives an optimizer's state the reference's
``param_specs(cfg, opt_sds, mesh)``: each slot its leaf's spec, the step
counter none; a rank's slots (``optimizer.init`` of its slices) have its
slices' shapes.

This module alone decides how a leaf lies: ``mark`` records on a tensor
the dimension its spec shards over a model axis of more than one rank
(``spec_slice`` marks every slice; ``model.py`` marks the parameters and
the caches), and the sharded forward asks ``model_dim`` instead of
comparing shapes.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import data_axes

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


# --------------------------------------------------------------------------- #
# The transformer on the (data, model) mesh
# --------------------------------------------------------------------------- #
def _spec_for_leaf(name: str, ndim: int, cfg) -> tuple:
    """A parameter's spec by its name (and, for the MoE and dense MLP
    weights, its rank), before shard axes that do not divide are dropped."""
    if name == "embed":
        return (None, "model", None) if cfg.num_codebooks else ("model", None)
    if name in ("lm_head", "wq", "wk", "wv", "wq_b", "wkv_b", "in_proj"):
        return (None, "model")
    if name in ("wo", "out_proj"):
        return ("model", None)
    if name in ("w_in", "w_gate"):
        return ("model", None, None) if ndim == 3 else (None, "model")
    if name == "w_out":
        return ("model", None, None) if ndim == 3 else ("model", None)
    # wq_a, wkv_a, the router, norms, A_log, D, dt_bias
    return (None,) * ndim


def _axis_size(entry, mesh) -> int:
    axes = (entry,) if isinstance(entry, str) else tuple(entry)
    return math.prod(mesh.shape[a] for a in axes)


def _lead(mesh):
    """The batch dimension's entry: the data axes, one as its name."""
    dp = data_axes(mesh)
    return dp[0] if len(dp) == 1 else dp


def param_specs(cfg, params, mesh) -> dict:
    """Parameter name -> spec, for ``params`` (a ``TransformerLM`` or a dict
    of named tensors, ``meta`` ones included) on ``mesh`` (only its
    ``shape`` and ``axis_names`` are read)."""
    named = dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else params
    out = {}
    for name, leaf in named.items():
        spec = _spec_for_leaf(name.split(".")[-1], leaf.ndim, cfg)
        out[name] = tuple(
            e if e is None or leaf.shape[i] % _axis_size(e, mesh) == 0 else None
            for i, e in enumerate(spec))
    return out


def opt_state_specs(cfg, opt_state, mesh):
    """The specs of an ``OptimizerState`` of ``train/optimizer.py`` whose
    slots follow ``list(model.parameters())`` of ``cfg``'s model (as
    ``optimizer.init`` makes them): the same structure, each slot its
    leaf's ``param_specs`` entry on ``mesh`` (from the whole leaves'
    shapes), the step counter ``()``. Raises ``ValueError`` on a slot list
    of another length, or a slot whose shape is neither its whole leaf's
    nor the slice's that its spec gives a rank of ``mesh``."""
    from repro_torch.models.transformer.model import empty_params

    whole = dict(empty_params(cfg, "meta").named_parameters())
    specs = param_specs(cfg, whole, mesh)

    def local(name):
        return tuple(n // (1 if e is None else _axis_size(e, mesh))
                     for n, e in zip(whole[name].shape, specs[name]))

    def slots(tree):
        if isinstance(tree, dict):
            return {k: slots(v) for k, v in tree.items()}
        if isinstance(tree, tuple) and not tree:  # no slots (plain SGD)
            return ()
        if len(tree) != len(whole):
            raise ValueError(f"{len(tree)} slots for {len(whole)} parameters")
        for (name, leaf), t in zip(whole.items(), tree):
            if tuple(t.shape) not in (tuple(leaf.shape), local(name)):
                raise ValueError(f"slot of {name}: shape {tuple(t.shape)}, "
                                 f"the leaf's {tuple(leaf.shape)}, a rank's "
                                 f"{local(name)}")
        return [specs[name] for name in whole]

    return type(opt_state)((), slots(opt_state.slots))


def batch_specs(cfg, batch: dict, mesh) -> dict:
    """Batch inputs: the leading batch dimension over the data axes when
    they divide it and it holds more than one row."""
    lead = _lead(mesh)
    dp = math.prod(mesh.shape[a] for a in data_axes(mesh))

    def spec(t):
        if t.ndim == 0:
            return ()
        b = t.shape[0]
        return (lead if b % dp == 0 and b > 1 else None,) + (None,) * (t.ndim - 1)

    return {k: spec(t) for k, t in batch.items()}


def cache_specs(cfg, caches: list, mesh) -> list:
    """One dict of specs a layer, as ``init_caches`` lays the caches out:
    the batch over the data axes; k/v (B, S, KV, hd) by head over ``model``,
    or by sequence where the heads do not divide it (MQA) and the rows do;
    MLA's latents ``c_kv``/``k_rope`` (B, S, .) by sequence; the SSM
    ``state`` (B, H, N, P) by head; anything else replicated."""
    lead = _lead(mesh)
    dp = math.prod(mesh.shape[a] for a in data_axes(mesh))
    M = mesh.shape["model"]

    def batch(shape):
        return lead if shape[0] % dp == 0 and shape[0] > 1 else None

    def spec(name, t):
        shape = t.shape
        if name in ("k", "v"):
            head_ok = shape[2] % M == 0
            seq_ok = not head_ok and shape[1] % M == 0
            return (batch(shape), "model" if seq_ok else None,
                    "model" if head_ok else None, None)
        if name in ("c_kv", "k_rope"):
            return (batch(shape), "model" if shape[1] % M == 0 else None, None)
        if name == "state":
            return (batch(shape), "model" if shape[1] % M == 0 else None,
                    None, None)
        return (None,) * t.ndim

    def layer(cache):
        return {k: layer(v) if isinstance(v, dict) else spec(k, v)
                for k, v in cache.items()}

    return [layer(c) for c in caches]


def mark(t, spec: tuple, mesh):
    """Record on ``t`` the dimension that ``spec`` shards over ``mesh``'s
    model axis (None where it is whole, or the axis is one rank), for
    ``model_dim``; returns ``t``."""
    t.model_dim = spec.index("model") if (
        "model" in spec and mesh.model_size > 1) else None
    return t


def model_dim(t) -> int | None:
    """The dimension of ``t`` that is sharded over the model axis, as
    ``mark`` recorded it; None for a whole tensor (an unmarked one too)."""
    return getattr(t, "model_dim", None)


def spec_slice(t, spec: tuple, mesh) -> torch.Tensor:
    """The rank's slice of ``t`` by ``spec``: along each sharded dimension
    the block of the rank's index on its axes (row-major over a tuple of
    axes), as a tensor of its own (a clone: the rank keeps nothing of the
    rest), marked (``mark``)."""
    if len(spec) != t.ndim:
        raise ValueError(f"spec {spec} for a {t.ndim}-d tensor")
    for i, e in enumerate(spec):
        if e is None:
            continue
        axes = (e,) if isinstance(e, str) else tuple(e)
        n = _axis_size(e, mesh)
        if t.shape[i] % n:
            raise ValueError(f"dimension {i} of {tuple(t.shape)} does not "
                             f"split over {axes} ({n})")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
        size = t.shape[i] // n
        t = t.narrow(i, idx * size, size)
    return mark(t.clone(), spec, mesh)


def param_slice(cfg, params, mesh) -> dict:
    """Parameter name -> the rank's slice (``param_specs``)."""
    named = dict(params.named_parameters()) if hasattr(
        params, "named_parameters") else params
    specs = param_specs(cfg, named, mesh)
    return {k: spec_slice(t.detach(), specs[k], mesh) for k, t in named.items()}


def cache_slice(cfg, caches: list, mesh) -> list:
    """The rank's slice of every layer's cache (``cache_specs``)."""
    def layer(cache, specs):
        return {k: layer(v, specs[k]) if isinstance(v, dict)
                else spec_slice(v, specs[k], mesh) for k, v in cache.items()}

    return [layer(c, s) for c, s in zip(caches, cache_specs(cfg, caches, mesh),
                                        strict=True)]


def batch_slice(cfg, batch: dict, mesh) -> dict:
    """The rank's rows of each batch input (``batch_specs``)."""
    specs = batch_specs(cfg, batch, mesh)
    return {k: spec_slice(t, specs[k], mesh) for k, t in batch.items()}
