"""Sim-mode shuffle primitives (Algorithm 2), the counterpart of
``repro.core.shuffle``'s sim path.

All P splits live on one device as a leading axis ``P``; the all-to-all is a
transpose of the (owner, needer) axes. The mixed-frontier buffer is
``concat([local rows, recv rows])``; padding recv rows are never addressed by
``edge_src``, so their values are irrelevant (and receive zero cotangent).
The send gather's adjoint is ``kernels/shuffle``'s (the CUDA kernel on the
card), which reads only the valid slots of each (owner, needer) pair.
The multi-GPU form (``all_to_all_single`` over NCCL) comes with a later slice.
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


def sim_alltoall(send: torch.Tensor, wire_dtype: str | None = None) -> torch.Tensor:
    """The fixed-size all-to-all, sim mode: ``send[p, q, ...]`` is device
    ``p``'s block for peer ``q``; the exchange swaps that axis pair."""
    wire, restore = wire_cast(send, wire_dtype)
    return wire.transpose(0, 1).to(restore)


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
