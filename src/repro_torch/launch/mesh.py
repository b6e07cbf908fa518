"""The transformer's (data, model) mesh of ranks — the counterpart of
``repro/launch/mesh.py`` — and the collectives its sharded forward runs over
the mesh's axes, with their counters.

The JAX package builds its production mesh with ``jax.make_mesh``: (16, 16)
as ("data", "model"), or (2, 16, 16) as ("pod", "data", "model") across two
pods. Data parallelism runs over ``pod`` and ``data``, model (tensor)
parallelism over ``model``. Here one process runs one mesh coordinate.
``make_mesh`` lays the ranks of the default process group out row-major with
the model axis minor (as ``sharding.make_split_mesh`` lays out its split
axis): the M ranks of one model group are neighbours, so on machines whose
rank order follows the interconnect the per-layer exchanges stay on the fast
links. It creates one process group for each model group and one for each
data group (the ranks that hold one model index across ``pod`` and
``data``), every rank all of them in one order, as ``dist.new_group``
requires; an axis of size 1 gets none. ``abstract_mesh`` is a mesh of axis
sizes alone, with no process group: what the spec functions of
``launch/sharding.py`` need, so the production mesh's specs can be computed
in one process. On an abstract mesh the collectives take ``meta`` tensors
only (the shape-only pass of ``launch/dryrun.py``): they count their calls
and bytes exactly as a real rank counts them and return ``meta`` results of
the real results' shapes, without ``torch.distributed``; any other tensor
raises.

The collectives (``all_reduce``, ``all_gather``, ``enter`` and the
reduce-scatter that is an all-gather's adjoint) count their calls and the
bytes of their results (the measure the reference's
``collective_bytes_from_hlo`` takes from the HLO) in ``COLLECTIVES``, by
axis and kind; ``launch/shapes.py::roofline_record`` reads them
(``collective_record``). On an axis of size 1 they return their input and
count nothing. Gloo takes no CUDA tensor for an all-gather, so a mesh over
gloo (``host_transport``, the rehearsal of several ranks on one card) copies
a CUDA tensor to the host around every collective; over gloo a
reduce-scatter is an all-reduce of which the rank keeps its block.

Without autograd (``torch.no_grad``, ``inference_mode``, or a tensor that
needs no gradient) ``all_reduce`` sums in place, as serving runs. Where
autograd records, each collective is a ``torch.autograd.Function`` whose
backward is itself a counted collective, chosen by the role of the value
on each axis:

* ``model``: the loss is one value that every rank computes the same way,
  and no gradient is averaged over ``model``. A value is either replicated
  (the same on every rank of the model group, its gradient the whole one
  on each) or partial (each rank computes its own part: its heads, hidden
  columns, experts or vocabulary block). ``all_reduce`` of partial sums
  gives a replicated value: its adjoint is the identity. ``enter`` marks
  where replicated values enter a partial region: the identity forward,
  an all-reduce of the gradients backward (without it every replicated
  leaf would get a partial gradient that differs from rank to rank).
  ``all_gather`` has two adjoints: before replicated code (the logits
  before the loss) the rank's slice of the gradient; into a partial
  region (``partial=True``: a weight gathered where a column shard cuts a
  head, the SSM projection) a reduce-scatter.
* ``data`` (the pod and data axes): each rank's loss is its own term of a
  mean, and the train step averages the gradients over these axes after
  the backward. A value computed from every data rank's rows feeds every
  rank's term: ``all_gather`` (the global MoE dispatch's tokens) has a
  reduce-scatter adjoint and ``all_reduce`` (the expert-local dispatch's
  ``aux``) an all-reduce adjoint. A slicing or identity adjoint there
  would be off by the data size.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.distributed as dist

#: the axis names of a mesh of two and of three axes
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
DATA_AXES = ("pod", "data")
KINDS = ("all-reduce", "all-gather", "reduce-scatter")
#: collectives since the last ``reset_collectives()``: axis ("model", or
#: "data" for the pod and data axes together) -> kind -> [calls, bytes]
COLLECTIVES = {axis: {kind: [0, 0] for kind in KINDS}
               for axis in ("model", "data")}


@dataclass(frozen=True, eq=False)
class Mesh:
    """A rank's place on the mesh: the axis names, each axis's size
    (``shape``, as ``jax.sharding.Mesh.shape``) and this rank's index on it
    (``coords``), the process group of its model axis and of its data axes
    (None on an axis of size 1, and on an ``abstract_mesh``), whether its
    collectives copy CUDA tensors to the host (gloo), and whether it is an
    ``abstract_mesh`` (shapes only: no process group)."""

    axis_names: tuple
    shape: dict
    coords: dict
    model_group: object = None
    data_group: object = None
    host_transport: bool = False
    abstract: bool = False

    @property
    def model_size(self) -> int:
        return self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.coords["model"]

    @property
    def data_size(self) -> int:
        """Ranks that split the batch: the product of ``pod`` and ``data``."""
        return math.prod(self.shape[a] for a in data_axes(self))

    @property
    def data_index(self) -> int:
        """This rank's place among them, ``pod`` major."""
        idx = 0
        for a in data_axes(self):
            idx = idx * self.shape[a] + self.coords[a]
        return idx


def production_shape(multi_pod: bool = False) -> tuple:
    """The reference's production mesh: (16, 16), or (2, 16, 16) across two
    pods."""
    return (2, 16, 16) if multi_pod else (16, 16)


def _axes(shape, axes) -> tuple:
    axes = AXES.get(len(shape)) if axes is None else tuple(axes)
    if axes not in AXES.values() or len(axes) != len(shape):
        raise ValueError(f"a mesh of shape {tuple(shape)} needs the axes "
                         f"{AXES.get(len(shape))}, got {axes}")
    if any(n < 1 for n in shape):
        raise ValueError(f"mesh axes must be >= 1, got {tuple(shape)}")
    return axes


def abstract_mesh(shape, axes=None, coords=None) -> Mesh:
    """A mesh of axis sizes (and, for a slicer, of one rank's ``coords``,
    a dict by axis, 0 by default) with no process group."""
    axes = _axes(shape, axes)
    coords = {a: (coords or {}).get(a, 0) for a in axes}
    for a, n in zip(axes, shape):
        if not 0 <= coords[a] < n:
            raise ValueError(f"coordinate {coords[a]} outside axis {a} of {n}")
    return Mesh(axes, dict(zip(axes, shape)), coords, abstract=True)


def production_mesh(multi_pod: bool = False) -> Mesh:
    """``abstract_mesh`` of ``production_shape``."""
    return abstract_mesh(production_shape(multi_pod))


def make_mesh(shape, axes=None) -> Mesh:
    """The mesh over the default process group, whose world must be the
    product of ``shape``: rank r sits at the row-major coordinate of r with
    the model axis minor."""
    axes = _axes(shape, axes)
    world = dist.get_world_size()
    if world != math.prod(shape):
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks, the process group has {world}")
    rank = dist.get_rank()
    M = shape[-1]
    n_data = world // M
    coords, rest = {}, rank
    for a, n in reversed(list(zip(axes, shape))):
        rest, coords[a] = divmod(rest, n)
    model_groups = [dist.new_group([f * M + j for j in range(M)])
                    for f in range(n_data)] if M > 1 else None
    data_groups = [dist.new_group([f * M + j for f in range(n_data)])
                   for j in range(M)] if n_data > 1 else None
    return Mesh(
        axes, dict(zip(axes, shape)), {a: coords[a] for a in axes},
        model_groups[rank // M] if model_groups else None,
        data_groups[rank % M] if data_groups else None,
        host_transport=dist.get_backend() == "gloo",
    )


def data_axes(mesh) -> tuple:
    """The mesh axes that shard the batch dimension."""
    return tuple(a for a in DATA_AXES if a in mesh.axis_names)


def model_axis(mesh) -> str:
    if "model" not in mesh.axis_names:
        raise ValueError(f"mesh axes {mesh.axis_names} have no model axis")
    return "model"


# --------------------------------------------------------------------------- #
# Collectives over an axis, counted
# --------------------------------------------------------------------------- #
def reset_collectives() -> None:
    for kinds in COLLECTIVES.values():
        for kind in kinds:
            kinds[kind] = [0, 0]


def collective_record() -> dict:
    """The counters as the reference's ``collectives`` record holds them:
    the result bytes of each kind, ``total`` and ``count``, over both axes,
    and ``by_axis`` (axis -> kind -> {"count", "bytes"})."""
    rec = {kind: sum(COLLECTIVES[a][kind][1] for a in COLLECTIVES)
           for kind in KINDS}
    rec["total"] = sum(rec[kind] for kind in KINDS)
    rec["count"] = sum(c for a in COLLECTIVES.values() for c, _ in a.values())
    rec["by_axis"] = {a: {kind: {"count": c, "bytes": b}
                          for kind, (c, b) in kinds.items()}
                      for a, kinds in COLLECTIVES.items()}
    return rec


def _group(mesh: Mesh, axis: str):
    """(process group, ranks) of the rank's ``axis`` ("model" or "data")."""
    if axis == "model":
        return mesh.model_group, mesh.model_size
    if axis == "data":
        return mesh.data_group, mesh.data_size
    raise ValueError(f"collectives run over 'model' or 'data', not {axis!r}")


def _count(axis: str, kind: str, nbytes: int) -> None:
    c = COLLECTIVES[axis][kind]
    c[0] += 1
    c[1] += nbytes


def _shape_only(t: torch.Tensor, mesh: Mesh) -> bool:
    """True on an abstract mesh, whose collectives take ``meta`` tensors
    only (they have no process group to run over); raises on any other."""
    if not mesh.abstract:
        return False
    if t.device.type != "meta":
        raise ValueError(f"a collective on an abstract mesh takes meta "
                         f"tensors only, not one on {t.device}")
    return True


def _sum_(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The counted in-place sum of ``t`` over ``axis`` (of more than one
    rank)."""
    group, _ = _group(mesh, axis)
    _count(axis, "all-reduce", t.numel() * t.element_size())
    if _shape_only(t, mesh):
        return t
    if mesh.host_transport and t.is_cuda:
        h = t.cpu()
        dist.all_reduce(h, group=group)
        return t.copy_(h)
    dist.all_reduce(t, group=group)
    return t


def _gather(t: torch.Tensor, mesh: Mesh, dim: int, axis: str) -> torch.Tensor:
    """The counted concatenation of the ranks' ``t`` along ``dim``."""
    group, n = _group(mesh, axis)
    _count(axis, "all-gather", n * t.numel() * t.element_size())
    if _shape_only(t, mesh):
        return torch.cat([t.contiguous()] * n, dim=dim)
    src = t.contiguous()
    if mesh.host_transport and t.is_cuda:
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(t.device)


def _scatter(t: torch.Tensor, mesh: Mesh, dim: int, axis: str) -> torch.Tensor:
    """The counted reduce-scatter: the sum of the ranks' ``t``, of which the
    rank keeps its block along ``dim`` (its index on ``axis``)."""
    group, n = _group(mesh, axis)
    size = t.shape[dim] // n
    idx = mesh.model_index if axis == "model" else mesh.data_index
    _count(axis, "reduce-scatter", t.numel() // n * t.element_size())
    if _shape_only(t, mesh):
        return t.narrow(dim, idx * size, size).clone(
            memory_format=torch.contiguous_format)
    if mesh.host_transport:  # gloo: an all-reduce, the rank's block kept
        h = t.detach().to("cpu", copy=True).contiguous()
        dist.all_reduce(h, group=group)
        return h.narrow(dim, idx * size, size).to(t.device, copy=True)
    src = t.movedim(dim, 0).contiguous()
    out = src.new_empty((size,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim)


def _records(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


class _AllReduce(torch.autograd.Function):
    """The sum over ``axis``; backward: the identity over ``model``, an
    all-reduce over ``data`` (module docstring)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return _sum_(t.clone(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        if ctx.axis == "model":
            return g, None, None
        return _sum_(g.clone(), ctx.mesh, ctx.axis), None, None


class _AllGather(torch.autograd.Function):
    """The ranks' blocks concatenated; backward: the rank's block of the
    gradient, or (``partial``, and always over ``data``) the
    reduce-scatter of the gradients."""

    @staticmethod
    def forward(ctx, t, mesh, dim, axis, partial):
        ctx.mesh, ctx.dim, ctx.axis = mesh, dim % t.dim(), axis
        ctx.scatter = partial or axis == "data"
        return _gather(t, mesh, dim, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, axis = ctx.mesh, ctx.dim, ctx.axis
        if ctx.scatter:
            return _scatter(g, mesh, dim, axis), None, None, None, None
        n = _group(mesh, axis)[1]
        size = g.shape[dim] // n
        return (g.narrow(dim, mesh.model_index * size, size), None, None,
                None, None)


class _Enter(torch.autograd.Function):
    """Replicated values entering a partial region of ``model``: the
    identity forward; backward, the gradients summed over ``model`` in one
    all-reduce a dtype."""

    @staticmethod
    def forward(ctx, mesh, *ts):
        ctx.mesh = mesh
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        out = list(gs)
        for dtype in dict.fromkeys(g.dtype for g in gs):
            idx = [i for i, g in enumerate(gs) if g.dtype == dtype]
            flat = _sum_(torch.cat([gs[i].reshape(-1) for i in idx]),
                         ctx.mesh, "model")
            for i, part in zip(idx, flat.split([gs[i].numel() for i in idx]),
                               strict=True):
                out[i] = part.view_as(gs[i])
        return (None, *out)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str = "model") -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``axis``: in place (``t`` is
    returned) without autograd; where autograd records, a new tensor with
    the adjoint of ``axis`` (module docstring)."""
    if _group(mesh, axis)[1] == 1:
        return t
    if _records(t):
        return _AllReduce.apply(t, mesh, axis)
    return _sum_(t, mesh, axis)


def all_gather(t: torch.Tensor, mesh: Mesh, dim: int, axis: str = "model",
               partial: bool = False) -> torch.Tensor:
    """The ranks' ``t`` of ``axis`` concatenated along ``dim`` in rank
    order. Its adjoint (where autograd records) is the rank's slice of the
    gradient, or with ``partial`` (the result feeds a partial region of
    ``model``), and over ``data`` always, a reduce-scatter."""
    if _group(mesh, axis)[1] == 1:
        return t
    if _records(t):
        return _AllGather.apply(t, mesh, dim, axis, partial)
    return _gather(t, mesh, dim, axis)


def enter(*ts: torch.Tensor, mesh: Mesh):
    """``ts`` (replicated over ``model``) as they enter a partial region:
    the same tensors, whose gradients are summed over ``model`` (one
    counted all-reduce a dtype) where autograd records. One tensor in, one
    out; several in, a tuple out. Without autograd, or on a model axis of
    one rank (or no mesh), ``ts`` themselves."""
    if mesh is None or mesh.model_size == 1 or not _records(*ts):
        return ts[0] if len(ts) == 1 else ts
    out = _Enter.apply(mesh, *ts)
    return out[0] if len(ts) == 1 else out
