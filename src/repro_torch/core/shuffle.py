"""Shuffle and cache-serving primitives (Algorithm 2, §2.2), the counterpart
of ``repro.core.shuffle``. Two execution forms with the same math:

  * sim  -- all P splits on one device as a leading axis ``P``; the
    all-to-all is a transpose of the (owner, needer) axes (``sim_*``,
    ``SimComm``).
  * spmd -- one process per split over ``torch.distributed`` (NCCL on the
    card, gloo on the CPU); the all-to-all is ``all_to_all_single`` over the
    split group (``spmd_*``, ``SpmdComm``), the torch statement of the JAX
    package's ``shard_map`` bodies. A rank keeps a leading split axis of
    length 1 on its rows, plan slices and cache block, so the layers, the
    fused kernels and the send gather's adjoint run unchanged (one owner);
    only the exchange differs. The exchange is its own adjoint
    (``_AllToAll``), and ``replica_grad_mean`` is the 2-D mesh's one
    gradient sync across replica groups.

The mixed-frontier buffer is ``concat([local rows, recv rows])``; padding
recv rows are never addressed by ``edge_src``, so their values are
irrelevant (and receive zero cotangent). The send gather's adjoint is
``kernels/shuffle``'s (the CUDA kernel on the card), which reads only the
valid slots of each (owner, needer) pair. ``chunk_slices`` tiles the overlap
schedule's exchange along the feature axis; ``sim_append_replicated``
appends the static hot-vertex block past the recv region;
``sim_serve_features``/``spmd_serve_features`` assemble the input block from
the resident feature cache (their gathers and scatter-adds are plain torch
ops, as the JAX package leaves them to XLA).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.kernels.shuffle import send_gather

#: dtypes a shuffled row may travel in. Rows are down-cast immediately
#: before the all-to-all and up-cast to the compute dtype immediately after,
#: so every accumulation stays fp32 — only the bytes-on-wire change.
#: ``float32`` is the identity wire (bit-exact).
WIRE_DTYPES = ("float32", "bfloat16", "float16")


def wire_cast(send: torch.Tensor, wire_dtype: str | None):
    """Down-cast a float payload to the wire dtype; returns (wire, restore).

    Integer payloads pass through untouched (ids must never be quantized), as
    does a ``wire_dtype`` of None/"float32". ``restore`` is the payload's
    original dtype: callers up-cast the received block back before
    accumulating.
    """
    if wire_dtype in (None, "float32"):
        return send, send.dtype
    if wire_dtype not in WIRE_DTYPES:
        raise ValueError(f"unknown wire dtype {wire_dtype!r} ({WIRE_DTYPES})")
    if not send.dtype.is_floating_point:
        return send, send.dtype
    return send.to(getattr(torch, wire_dtype)), send.dtype


def sim_alltoall(send: torch.Tensor, wire_dtype: str | None = None,
                 axis: int = 0) -> torch.Tensor:
    """The fixed-size all-to-all, sim mode: ``send[p, q, ...]`` is device
    ``p``'s block for peer ``q``; the exchange swaps that axis pair.

    ``axis`` names where the split axis lives: a replica-batched tensor
    ``send[r, p, q, ...]`` takes ``axis=1``, and swapping axes (1, 2) never
    mixes rows across R, the sim statement of the 2-D mesh's confinement of
    each exchange to its replica group."""
    wire, restore = wire_cast(send, wire_dtype)
    return wire.transpose(axis, axis + 1).to(restore)


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` over ``group`` along axis 0. The all-to-all is
    its own transpose, so the adjoint is the same exchange of the
    cotangent (every rank reaches it: the graphs are the same on every rank
    of the group)."""

    @staticmethod
    def forward(ctx, send, group):
        ctx.group = group
        return _all_to_all(send, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def spmd_alltoall(send: torch.Tensor, group,
                  wire_dtype: str | None = None) -> torch.Tensor:
    """The fixed-size all-to-all, spmd form: ``send`` (P, ...) holds one
    equal-size block per rank of ``group`` (in group rank order); returns
    (P, ...) with ``recv[q]`` rank q's block for this rank, the mirror of
    ``sim_alltoall`` with its wire contract. The wire cast stays outside the
    exchange, as on the sim path, so autograd carries its adjoint.

    On the 2-D (replica, split) mesh ``group`` is the rank's split group
    (``launch.sharding.make_split_mesh``): the exchange stays inside its
    replica group, the spmd statement of the mesh's locality invariant."""
    wire, restore = wire_cast(send, wire_dtype)
    return _AllToAll.apply(wire, group).to(restore)


class SimComm:
    """The exchange of the layer shuffles, the cache's remote fetch, the
    overlap schedule and the cooperative sampler, sim form.

    ``exchange(send, wire_dtype)`` takes a send buffer ``send[p, q, s, ...]``
    (split p's s-th row for needer q) and returns the recv region
    ``(P, P*S, ...)``: each needer's rows from every owner q, in owner
    order, where a plan's ``n_local + q*S + s`` entries find them. The JAX
    adapter also batches the per-split math and the send gather; the port's
    per-split math takes the leading split axis already (of length 1 on a
    rank), so the exchange is all that differs between the two forms.
    """

    def exchange(self, send: torch.Tensor, wire_dtype: str | None = None):
        recv = sim_alltoall(send, wire_dtype)
        return recv.reshape(recv.shape[0], -1, *recv.shape[3:])


class SpmdComm:
    """The exchange in spmd form, over ``group`` (the rank's split group):
    ``send`` (1, P, S, ...) holds this rank's rows for each peer; returns
    the recv region (1, P*S, ...). Mirrors ``SimComm``: tests hold the two
    forms to the same rows, forward and adjoint."""

    def __init__(self, group):
        self.group = group

    def exchange(self, send: torch.Tensor, wire_dtype: str | None = None):
        recv = spmd_alltoall(send[0], self.group, wire_dtype)
        return recv.reshape(1, -1, *recv.shape[2:])


def shuffle(h, send_idx, comm, wire_dtype=None, *, send_count):
    """The layer shuffle over ``comm`` (``SimComm`` or ``SpmdComm``): gather
    each owner's rows for every needer (``send_gather``), exchange them, and
    append the recv region to ``h``. ``sim_shuffle`` and ``spmd_shuffle``
    are this over their exchange. A plan whose S is 0 (one split) moves
    nothing and returns ``h``."""
    if send_idx.shape[-1] == 0:
        return h
    send = send_gather(h, send_idx, send_count)  # (P, P, S, F)
    return torch.cat([h, comm.exchange(send, wire_dtype)], dim=1)


def sim_shuffle(
    h: torch.Tensor,
    send_idx: torch.Tensor,
    wire_dtype: str | None = None,
    *,
    send_count: torch.Tensor,
) -> torch.Tensor:
    """Simulated all-to-all shuffle.

    h          -- (P, N, F) local row blocks at the source depth
    send_idx   -- (P, P, S) int32 gather rows: [owner q, needer p, slot]
    send_count -- (P, P) int32 true (unpadded) pair sizes: the send gather's
                  adjoint (``kernels/shuffle``) reads only the valid slots
    returns    -- (P, N + P*S, F) mixed buffers per device
    """
    return shuffle(h, send_idx, SimComm(), wire_dtype, send_count=send_count)


def spmd_shuffle(
    h: torch.Tensor,
    send_idx: torch.Tensor,
    group,
    wire_dtype: str | None = None,
    *,
    send_count: torch.Tensor,
) -> torch.Tensor:
    """The shuffle on one rank of ``group``.

    h          -- (1, N, F) this rank's row block
    send_idx   -- (1, P, S) int32 its rows for each peer (slice p of the
                  plan's ``send_idx``), ``send_count`` (1, P) their counts
    returns    -- (1, N + P*S, F) the rank's mixed buffer, row for row
                  split p's of ``sim_shuffle``

    A one-split plan has S = 0: nothing moves, as in the JAX package.
    """
    return shuffle(h, send_idx, SpmdComm(group), wire_dtype,
                   send_count=send_count)


def sim_append_replicated(mixed: torch.Tensor,
                          rep_block: torch.Tensor) -> torch.Tensor:
    """Append the static replicated block to every split's buffer (sim).

    mixed     -- (P, M, F) per-split rows (a mixed buffer or a local block)
    rep_block -- (R, F) the device-resident replicated rows: *one* copy,
                 broadcast across the P axis (every split holds the same
                 block by construction; no bytes travel)
    returns   -- (P, M + R, F)

    This completes the mixed-buffer layout ``[local][recv][replicated]``:
    plan entries ``>= n_local + P*S`` index the appended region. The rows
    are the same fp32 bits as the loaded features, so rerouted edges read
    bit-identical values.
    """
    P = mixed.shape[0]
    rep = rep_block.to(mixed.dtype).unsqueeze(0).expand(P, *rep_block.shape)
    return torch.cat([mixed, rep], dim=1)


#: the spmd form of ``sim_append_replicated``: a rank's (1, M, F) rows and
#: the whole replicated block, which every rank holds, give (1, M + R, F)
spmd_append_replicated = sim_append_replicated


def chunk_slices(width: int, chunks: int, align: int = 1) -> list[slice]:
    """Static feature-axis tiling for the chunked overlapped exchange.

    Splits ``[0, width)`` into at most ``chunks`` contiguous slices whose
    boundaries are multiples of ``align`` (GAT requires head-aligned chunks
    so each chunk carries whole heads). Python ints only: the tiling is
    program structure, never data-dependent.
    """
    if chunks <= 1 or width <= align:
        return [slice(0, width)]
    blocks = width // align  # align divides width at every call site
    per = -(-blocks // chunks)
    out = []
    for start in range(0, blocks, per):
        lo = start * align
        hi = min((start + per) * align, width)
        out.append(slice(lo, hi))
    return out


def all_reduce_sum(tensors: list, group) -> list:
    """Each tensor summed over the ranks of ``group``, in one ``all_reduce``
    of their concatenation (one dtype): every rank gets the same bits.
    Returns new tensors shaped as the inputs."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


def replica_grad_mean(grads: list, group, num_replicas: int) -> list:
    """Average a gradient list across the replica groups of the 2-D mesh
    (spmd form): the one gradient sync that crosses replica groups, an
    ``all_reduce(SUM)`` over ``group`` (the rank's replica group) and a
    division by R. At R = 1 it is the identity, with no collective and no
    division, as ``Trainer._dispatch_step`` skips them on the sim path. A
    sum of two terms is the same bits in either order, so at R = 2 the
    result is the sim mesh's ``(g0 + g1) / 2`` bit for bit given bitwise
    replica gradients."""
    if num_replicas == 1:
        return list(grads)
    return [g / num_replicas for g in all_reduce_sum(grads, group)]


def _scatter_add_rows(block: torch.Tensor, rows: torch.Tensor,
                      pos: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Scatter ``rows`` (P, K, F), masked, into ``block`` (P, N, F) at
    ``pos`` (P, K) by addition, per split.

    Valid positions are written by exactly one source and start at 0.0, so
    the add is exact in any order (also the order of the card's atomics);
    masked (padding) rows contribute 0.0 at row 0, also exact. This is what
    makes the served feature block equal to a full host gather whatever the
    padding widths.
    """
    P, N, F = block.shape
    split = torch.arange(P, device=block.device)[:, None]
    idx = (pos.long() + split * N).reshape(-1)
    vals = (rows * mask[:, :, None].to(rows.dtype)).reshape(-1, F)
    return block.reshape(P * N, F).index_add(0, idx, vals).reshape(P, N, F)


def serve_features(cache_block, cplan, miss_feats, comm, wire_dtype=None):
    """The input block served from the resident cache over ``comm``: local
    hits, the remote hits' exchange and the miss rows, scattered into their
    positions. ``sim_serve_features`` and ``spmd_serve_features`` are this
    over their exchange."""
    P = cache_block.shape[0]
    split = torch.arange(P, device=cache_block.device)[:, None]
    feats = cache_block[split, cplan["local_slot"].long()]  # (P, N, F)
    feats = feats * cplan["local_mask"][:, :, None].to(feats.dtype)
    if cplan["send_slot"].shape[-1]:
        # remote hits ride the same all-to-all as the layer shuffles: gather
        # the (P, P, Sc, F) send buffer from owner blocks, exchange it, and
        # scatter each needer's recv region into its positions
        send = cache_block[split[:, :, None], cplan["send_slot"].long()]
        feats = _scatter_add_rows(
            feats, comm.exchange(send, wire_dtype),
            cplan["recv_pos"].reshape(P, -1), cplan["recv_mask"].reshape(P, -1),
        )
    if miss_feats.shape[1]:
        feats = _scatter_add_rows(
            feats, miss_feats, cplan["miss_pos"], cplan["miss_mask"]
        )
    return feats


def sim_serve_features(
    cache_block: torch.Tensor,
    cplan: dict,
    miss_feats: torch.Tensor,
    wire_dtype: str | None = None,
) -> torch.Tensor:
    """Assemble the input-feature block from the resident cache (sim mode).

    cache_block -- (P, C, F) device-resident rows (trainer setup, static)
    cplan       -- device tensors of a ``graph.cache.CachePlan``
                   (``plan_io.cache_plan_to_device``)
    miss_feats  -- (P, M, F) host-gathered miss rows (padding rows zeroed)
    wire_dtype  -- wire format of the remote-hit all-to-all; fp32 keeps the
                   served block equal to ``plan_io.load_features``, bf16/fp16
                   quantize only the remotely fetched rows
    returns     -- (P, N_L, F), equal to ``plan_io.load_features`` when the
                   wire is fp32
    """
    return serve_features(cache_block, cplan, miss_feats, SimComm(),
                           wire_dtype)


def spmd_serve_features(
    cache_local: torch.Tensor,
    cplan_local: dict,
    miss_feats_local: torch.Tensor,
    group,
    wire_dtype: str | None = None,
) -> torch.Tensor:
    """Feature serving on one rank of ``group``, the mirror of
    ``sim_serve_features``.

    cache_local      -- (1, C, F) this rank's resident block
    cplan_local      -- the rank's slice of every ``CachePlan`` array
                        (``send_slot`` (1, P, Sc) by owner, ``recv_pos`` /
                        ``recv_mask`` (1, P, Sc) by needer)
    miss_feats_local -- (1, M, F) its host-gathered miss rows
    returns          -- (1, N_L, F), split p's rows of ``sim_serve_features``
    """
    return serve_features(cache_local, cplan_local, miss_feats_local,
                           SpmdComm(group), wire_dtype)
