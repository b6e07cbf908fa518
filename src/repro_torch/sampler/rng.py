"""Counter-based RNG for device-side sampling — the counterpart of
``repro/sampler/rng.py``.

Every neighbour draw is a pure function of ``(seed, epoch, batch, layer,
vertex, slot)``: the first four fold into a 64-bit layer key on the host
(``fold_key_pair``, two uint32 lanes), and the device hashes ``(layer key,
vertex id, slot)`` to a uniform uint32 (``draw_u32``, three rounds of the
lowbias32 avalanche). Keying by global vertex id, never buffer position,
keeps device sampling deterministic under capacity growth and padding.

The tensor functions emulate uint32 arithmetic in int64, because ``>>`` on
``torch.uint32`` is not implemented on the CPU: every multiply and add is
masked with ``& 0xFFFFFFFF`` before the next shift. A product of two words
below 2**32 can overflow int64; the wrap keeps the low 32 bits, which is all
the mask keeps, and masking before every ``>>`` keeps the shifted value
non-negative (an arithmetic shift of a negative int64 would bring in sign
bits). The CUDA kernel (``csrc/wavefront_expand.cu``) computes the same
words in native uint32.
"""
from __future__ import annotations

import torch

_M1 = 0x7FEB352D
_M2 = 0x846CA68B
_GOLDEN = 0x9E3779B9
_FNV = 0x01000193
MASK32 = 0xFFFFFFFF


def _mix32_py(x: int) -> int:
    """lowbias32 on a python int (host-side key folding)."""
    x &= 0xFFFFFFFF
    x ^= x >> 16
    x = (x * _M1) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * _M2) & 0xFFFFFFFF
    x ^= x >> 16
    return x


_SALT_HI = 0x243F6A88  # decorrelates the high key lane from the low one


def fold_key(*parts: int) -> int:
    """Fold integers (seed, epoch, batch, layer, ...) into one uint32 word.

    FNV-style absorb + full remix per component, so nearby (epoch, batch)
    tuples land in unrelated keys.
    """
    h = 0x811C9DC5
    for p in parts:
        h = _mix32_py((h ^ (int(p) & 0xFFFFFFFF)) * _FNV)
    return h


def fold_key_pair(*parts: int) -> tuple[int, int]:
    """The 64-bit draw key: two uint32 lanes folded under different salts."""
    return fold_key(*parts), fold_key(_SALT_HI, *parts)


def mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 avalanche on int64 tensors holding uint32 words."""
    x = x & MASK32
    x = x ^ (x >> 16)
    x = (x * _M1) & MASK32
    x = x ^ (x >> 15)
    x = (x * _M2) & MASK32
    return x ^ (x >> 16)


def draw_u32(vid, slot, key_lo, key_hi) -> torch.Tensor:
    """Uniform uint32 words (as int64) for (vertex, slot) under the 64-bit
    layer key. Arguments broadcast against each other; ``vid`` and ``slot``
    are any integer tensors (reinterpreted as uint32, as ``astype`` does),
    the keys int64 words or python ints. Three dependent mix rounds: (vid,
    low lane), the high lane, the slot."""
    h = mix32((vid.long() & MASK32) ^ key_lo)
    h = mix32(h ^ key_hi)
    return mix32(h + ((slot.long() & MASK32) * _GOLDEN))
