"""Plain torch version of the wavefront-expansion kernel — the counterpart of
``repro/sampler/ref.py``.

``expand_codes`` is the semantic definition of one frontier expansion; the
CUDA kernel (``csrc/wavefront_expand.cu``) is held bitwise equal to it.

Slot-code encoding (one int32 per (vertex, slot)):

  * ``>= 0`` -- a valid within-row neighbour offset: edge id is
    ``row_start + code``;
  * ``-1``   -- a self-loop (the vertex has zero in-degree: every vertex
    has at least one message source, as in the host sampler);
  * ``-2``   -- an invalid slot (padding row, beyond-degree take-all slot,
    or a de-duplicated repeated draw).

``deg <= fanout`` takes all ``deg`` in-edges; ``deg > fanout`` draws
``fanout`` uniform slots with replacement, then slot j dies if an earlier
slot drew the same offset; ``deg == 0`` emits the self-loop; ``deg < 0``
marks an invalid row.
"""
from __future__ import annotations

import torch

from repro_torch.sampler.rng import draw_u32

INVALID = -2
SELF_LOOP = -1


def expand_codes(vid, deg, key_lo, key_hi, fanout: int) -> torch.Tensor:
    """Slot codes (B, fanout) int32 for frontier ``vid``/``deg`` (B,) int32
    under the layer key lanes ``key_lo``/``key_hi`` (int64 words, python
    ints or 0-d tensors)."""
    B = vid.shape[0]
    slots = torch.arange(fanout, device=vid.device).expand(B, fanout)
    u = draw_u32(vid[:, None], slots, key_lo, key_hi)
    degl = deg.long()
    sampled = u % degl.clamp(min=1)[:, None]
    take_all = (degl <= fanout)[:, None]
    off = torch.where(take_all, slots, sampled)
    d = degl[:, None]
    valid = torch.where(
        d < 0,
        False,
        torch.where(d == 0, slots == 0, torch.where(take_all, slots < d, True)),
    )
    off = torch.where((d == 0) & (slots == 0), SELF_LOOP, off)
    # slot j dies if any k < j drew the same offset (take-all offsets are
    # distinct, so only sampled rows are affected): the (B, F, F) compare
    eq = off[:, :, None] == off[:, None, :]
    idx = torch.arange(fanout, device=vid.device)
    earlier = idx[None, :] < idx[:, None]
    dup = (eq & earlier).any(dim=-1)
    return torch.where(valid & ~dup, off, INVALID).to(torch.int32)
