"""Plain torch version of the shuffle adjoint kernel
(``csrc/shuffle_bwd.cu``).

``shuffle_bwd`` is the adjoint of ``send[q, p, s] = h[q, send_idx[q, p, s]]``
for ``h``: for each owner q and local row n, the sum over the groups p (the
needers) in ascending order of ``g[q, p, s]`` over the valid slots ``s <
send_count[q, p]`` with ``send_idx[q, p, s] == n``, in fp32 from +0.0. One
``index_add_`` per p, on rows that are distinct within the call (a pair's
valid slots hold distinct rows, and owners are offset apart), so the order
of each row's sum is fixed by the loop over p and by nothing else. The CUDA kernel equals it
bit for bit; so does ``jax.vjp`` of the JAX package's ``sim_shuffle`` on the
CPU, less the local rows' cotangent (``tests/test_torch_shuffle.py``).

Padding slots are skipped: their cotangents are zero on every path (the
row adjoint never addresses a padding receive row), and a sum from +0.0 that
skips a +0.0 term has the same bits.
"""
from __future__ import annotations

import torch


def shuffle_bwd(g, send_idx, send_count, num_rows: int) -> torch.Tensor:
    """dh (P, num_rows, F) from the cotangent ``g`` (P, Q, S, F),
    ``send_idx`` (P, Q, S) and ``send_count`` (P, Q) int32."""
    P, Q, S, F = g.shape
    dh = torch.zeros(P * num_rows, F, dtype=g.dtype, device=g.device)
    slot = torch.arange(S, device=g.device)
    base = (torch.arange(P, device=g.device) * num_rows)[:, None]
    for p in range(Q):
        valid = slot[None, :] < send_count[:, p, None].long()  # (owner, S)
        rows = (base + send_idx[:, p, :].long())[valid]
        dh.index_add_(0, rows, g[:, p][valid])
    return dh.reshape(P, num_rows, F)
