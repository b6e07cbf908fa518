"""Sim-mode shuffle primitives (Algorithm 2), the counterpart of
``repro.core.shuffle``'s sim path.

All P splits live on one device as a leading axis ``P``; the all-to-all is a
transpose of the (owner, needer) axes. The mixed-frontier buffer is
``concat([local rows, recv rows])``; padding recv rows are never addressed by
``edge_src``, so their values are irrelevant (and receive zero cotangent).
The send gather's adjoint is ``kernels/shuffle``'s (the CUDA kernel on the
card), which reads only the valid slots of each (owner, needer) pair.
``chunk_slices`` tiles the overlap schedule's exchange along the feature
axis; ``sim_append_replicated`` appends the static hot-vertex block past the
recv region; ``sim_serve_features`` assembles the input block from the resident
feature cache (its gathers and scatter-adds are plain torch ops, as the JAX
package leaves them to XLA). The multi-GPU form (``all_to_all_single`` over
NCCL) comes with a later slice.
"""
from __future__ import annotations

import torch

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
    P, N, F = h.shape
    S = send_idx.shape[-1]
    if S == 0:
        return h
    send = send_gather(h, send_idx, send_count)  # (P, P, S, F)
    recv = sim_alltoall(send, wire_dtype)
    return torch.cat([h, recv.reshape(P, P * S, F)], dim=1)


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
    P = cache_block.shape[0]
    split = torch.arange(P, device=cache_block.device)[:, None]
    feats = cache_block[split, cplan["local_slot"].long()]  # (P, N, F)
    feats = feats * cplan["local_mask"][:, :, None].to(feats.dtype)
    if cplan["send_slot"].shape[-1]:
        # remote hits ride the same all-to-all as the layer shuffles: gather
        # the (P, P, Sc, F) send buffer from owner blocks, transpose the
        # (owner, needer) axes, scatter into needer positions
        send = cache_block[split[:, :, None], cplan["send_slot"].long()]
        recv = sim_alltoall(send, wire_dtype)  # (P_needer, P_owner, Sc, F)
        feats = _scatter_add_rows(
            feats, recv.reshape(P, -1, feats.shape[-1]),
            cplan["recv_pos"].reshape(P, -1), cplan["recv_mask"].reshape(P, -1),
        )
    if miss_feats.shape[1]:
        feats = _scatter_add_rows(
            feats, miss_feats, cplan["miss_pos"], cplan["miss_mask"]
        )
    return feats
