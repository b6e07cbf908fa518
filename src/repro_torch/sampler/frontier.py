"""Static-cap frontier set operations — the counterpart of
``repro/sampler/frontier.py``.

Device-side sampling cannot grow arrays: every set operation here has a
static output capacity, reports the true element count, and raises an
overflow flag when the capacity would truncate (the engine then falls back
to the host sampler for that batch). Both primitives are sort-based and
work over the last axis of batched inputs (leading axes, e.g. the P splits,
are independent problems). Only static-shape ops are used, so nothing syncs
the host and the cap and overflow semantics match the JAX ops bit for bit:
one ``sort``, ``cumsum`` bookkeeping, and a ``scatter`` into a ``cap + 1``
buffer whose last slot is the dump slot for overflowing entries. Value arrays
stay int32 as in JAX; torch's ``gather``/``scatter`` take int64 indices.
"""
from __future__ import annotations

import torch


def take(table, idx):
    """``table[idx]`` for a 1-d table and an integer index tensor of any
    shape, through ``index_select`` (no host sync on the card)."""
    return table.index_select(0, idx.reshape(-1).long()).reshape(idx.shape)


def _sorted_uniq(key, sentinel):
    """Sort the last axis; mark the first of each run of valid values."""
    s = torch.sort(key, dim=-1).values
    prev = torch.cat([torch.full_like(s[..., :1], -1), s[..., :-1]], dim=-1)
    return s, (s != prev) & (s < sentinel)


def sorted_unique_capped(vals, valid, cap: int, sentinel: int):
    """Sorted unique valid values of ``vals (..., C)`` int32 ->
    ``((..., cap) block, (...,) true count capped at cap, (...,) overflow)``.

    Output slots beyond ``min(count, cap)`` are zero; ``sentinel`` is
    strictly greater than any valid value (e.g. the number of nodes).
    """
    key = torch.where(valid, vals, torch.full_like(vals, sentinel))
    s, uniq = _sorted_uniq(key, sentinel)
    count = uniq.sum(dim=-1, dtype=torch.int32)
    rank = torch.cumsum(uniq, dim=-1) - 1
    idx = torch.where(uniq, rank.clamp(max=cap), cap)  # cap = dump slot
    out = torch.zeros(vals.shape[:-1] + (cap + 1,), dtype=vals.dtype,
                      device=vals.device)
    out.scatter_(-1, idx, s)
    return out[..., :cap], count.clamp(max=cap), count > cap


def bucket_by_owner(vals, valid, owner_of, num_parts: int, cap: int,
                    num_nodes: int):
    """Group the valid values of ``vals (..., C)`` by owner ->
    ``((..., P, cap) rows, (..., P) counts capped at cap, (...,) overflow)``.

    Row ``q`` holds the sorted unique valid values owned by ``q``
    (duplicates collapse). The (owner, vertex) pair packs into one int32 key
    ``o * V + v``; ``shard.build_shards`` guards ``P * V < 2**31``.
    """
    V, P = num_nodes, num_parts
    o = take(owner_of, vals.clamp(0, V - 1))
    big = P * V
    key = torch.where(valid, o * V + vals, torch.full_like(vals, big))
    s, uniq = _sorted_uniq(key, big)
    o_s = s // V
    v_s = s % V
    lead = vals.shape[:-1]
    row = torch.where(uniq, o_s, P).long()
    cnt = torch.zeros(lead + (P + 1,), dtype=torch.int32, device=vals.device)
    cnt.scatter_add_(-1, row, torch.ones_like(s))
    start = torch.cumsum(cnt[..., :P], dim=-1, dtype=torch.int32) - cnt[..., :P]
    rank = torch.cumsum(uniq, dim=-1, dtype=torch.int32) - 1
    pos = rank - torch.gather(start, -1, o_s.clamp(0, P - 1).long())
    col = torch.where(uniq, pos.clamp(max=cap), cap).long()
    buf = torch.zeros(lead + ((P + 1) * (cap + 1),), dtype=vals.dtype,
                      device=vals.device)
    buf.scatter_(-1, row * (cap + 1) + col, v_s)
    buf = buf.reshape(lead + (P + 1, cap + 1))
    overflow = (cnt[..., :P] > cap).any(dim=-1)
    return buf[..., :P, :cap], cnt[..., :P].clamp(max=cap), overflow
