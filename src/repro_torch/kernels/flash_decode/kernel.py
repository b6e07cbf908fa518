"""Wrapper of the CUDA split-K decode-attention kernel
(``csrc/flash_decode.cu``), replacing the Pallas kernel
``repro/kernels/flash_decode/kernel.py::decode_attention_pallas_bkv``.

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it runs
the plain version (``ref.decode_attention_ref``), the only reason it ever
does. It checks device, dtype, shapes and strides and raises on anything the
kernel does not take, allocates the output with ``torch.empty`` (and the
split-K workspace once per shape and stream), and counts its launches in
``LAUNCHES``.

The decode loop calls it once per layer and token, so its host time is paid
thousands of times a serve run. What depends only on the shapes and strides
(their checks, the chunk, the shared-memory check, the scale and the bound
entry point) is worked out once per (dtypes, shapes, strides) and cached in
a plan; each call then checks only what can differ between calls with the
same plan (devices, base alignment, ``cache_len``), makes one output, and
makes one ctypes call that launches both kernels.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.build import INT, PTR, raise_on, typed_library
from repro_torch.kernels.flash_decode import ref

#: kernel launches since the last ``reset_launches()``; only a launch of the
#: CUDA kernel counts (one per call: the partial and merge kernels together),
#: never a plain-version call
LAUNCHES = {"flash_decode": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: streaming multiprocessors of an H100 SXM: the chunk is sized for them
SMS = 132
#: shared memory a block may use on Hopper (232,448 bytes)
MAX_SMEM = 232448


class DecodeShape(ctypes.Structure):
    """``csrc/flash_decode.cu``'s ``DecodeShape``: what a call's shapes and
    strides fix, passed by pointer."""

    _fields_ = [(name, ctypes.c_int) for name in ("B", "S", "KV", "G", "D", "Dv")] \
        + [(name, ctypes.c_longlong) for name in ("k_sb", "k_ss", "v_sb", "v_ss")] \
        + [("scale", ctypes.c_float), ("chunk", ctypes.c_int), ("dtype", ctypes.c_int)]


# q, k, v, cache_len, ws, out, &DecodeShape, stream
_SIGNATURES = {
    "flash_decode": [PTR] * 8,
    # dtype, G, D, Dv -> bytes of shared memory of one partial block
    "flash_decode_smem_bytes": [INT] * 4,
    # dtype, D, Dv -> 1 on the tensor-core path
    "flash_decode_uses_mma": [INT] * 3,
}


def reset_launches() -> None:
    LAUNCHES["flash_decode"] = 0


def decode_chunk(B: int, KV: int, S: int, G: int = 1) -> int:
    """Cache rows per block of the partial kernel for B*KV (b, kv) pairs of
    G query heads over S rows: a multiple of 16 (one tensor-core step), at
    least 16, and small enough that the tensor-core grid, B*KV*ceil(G/16)
    blocks (one per 16-head tile) times ceil(S/chunk), makes at least two
    waves on the card's ``SMS`` multiprocessors whenever S allows it. Of
    those, the first that splits S into the fewest nearly equal chunks. A
    pure function of its arguments, so a shape always splits alike."""
    want = -(-2 * SMS // (B * KV * -(-G // 16)))  # chunks per (b, kv) pair
    parts = want
    while True:
        chunk = max(16, -(-(-(-S // parts)) // 16) * 16)
        if chunk == 16 or -(-S // chunk) >= want:
            return chunk
        parts += 1


def _check(q, k, v, cache_len):
    """Raise unless the kernel takes these tensors: q (B, H, D) contiguous;
    k (B, S, KV, D) and v (B, S, KV, Dv) of q's dtype, unit stride in the
    last dim and heads packed in a row, batch and row strides and pointers
    16-byte aligned; H a multiple of KV; D and Dv multiples of 8; cache_len
    one int32 on the same device."""
    if q.dtype not in DTYPES:
        raise TypeError(f"q: expected float32/bfloat16, got {q.dtype}")
    if q.dim() != 3 or k.dim() != 4 or v.dim() != 4:
        raise TypeError(
            f"expected q (B, H, D), k/v (B, S, KV, D); got {q.dim()}-d, "
            f"{k.dim()}-d, {v.dim()}-d"
        )
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    _check_len(cache_len, q.device)
    B, H, D = q.shape
    _, S, KV, Dk = k.shape
    if k.shape[0] != B or Dk != D or v.shape[:3] != k.shape[:3]:
        raise ValueError(
            f"q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)} "
            "do not match"
        )
    if H % KV:
        raise ValueError(f"{H} query heads are not a multiple of {KV} KV heads")
    Dv = v.shape[3]
    if D % 8 or Dv % 8:
        raise ValueError(f"head dims {D}/{Dv} must be multiples of 8")
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    for name, t, d in (("k", k, D), ("v", v, Dv)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(
                f"{name} strides {t.stride()}: the last dim must be unit-"
                "stride and the heads of a row packed"
            )
        if t.stride(0) % 8 or t.stride(1) % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name} strides/pointer must be 16-byte aligned")


def _check_len(cache_len, device):
    if not isinstance(cache_len, torch.Tensor) or cache_len.dtype != torch.int32 \
            or cache_len.numel() != 1:
        raise TypeError("cache_len must be one int32 in a tensor")
    if cache_len.device != device:
        raise ValueError(f"cache_len is on {cache_len.device}, q on {device}")


class _Plan(NamedTuple):
    """What one (dtypes, shapes, strides) key fixes: the bound entry point,
    the output's shape, the workspace's length, the ``DecodeShape`` (kept
    alive here) with its address, and the workspace of each (card, stream)."""

    fn: object
    out_shape: tuple
    ws_numel: int
    shape: DecodeShape
    shape_ptr: int
    workspaces: dict


#: (dtypes, shapes, strides) -> _Plan, filled on the first call of each
_PLANS: dict = {}


def _plan(q, k, v) -> _Plan:
    B, H, D = q.shape
    _, S, KV, _ = k.shape
    Dv, G = v.shape[3], H // KV
    if B * KV > 65535:
        raise ValueError(f"B*KV = {B * KV} exceeds the grid's 65535")
    lib = typed_library("flash_decode", _SIGNATURES)
    code = DTYPES[q.dtype]
    smem = lib.flash_decode_smem_bytes(code, G, D, Dv)
    if smem > MAX_SMEM:
        raise ValueError(
            f"a group of {G} heads at D={D}/{Dv} needs {smem} bytes of shared "
            f"memory, over {MAX_SMEM}"
        )
    chunk = decode_chunk(B, KV, S, G)
    n_chunks = -(-S // chunk)
    ks, vs = k.stride(), v.stride()
    shape = DecodeShape(B, S, KV, G, D, Dv, ks[0], ks[1], vs[0], vs[1],
                        float(1.0 / np.sqrt(D)), chunk, code)
    return _Plan(fn=lib.flash_decode, out_shape=(B, H, Dv),
                 ws_numel=B * KV * n_chunks * G * (Dv + 2), shape=shape,
                 shape_ptr=ctypes.addressof(shape), workspaces={})


def _raw_stream(index: int) -> int:
    """The handle of PyTorch's current stream on card ``index``, read as
    PyTorch's own kernel launchers read it (no Stream object is made)."""
    return torch._C._cuda_getCurrentRawStream(index)


def flash_decode(q, k, v, cache_len):
    """Single-token GQA decode attention -> (B, H, Dv) in q's dtype.

    q (B, H, D), k (B, S, KV, D), v (B, S, KV, Dv) f32/bf16 (the cache read
    where it lies, by its strides); cache_len one int32 on q's device, in
    [1, S] (cache rows at or past it are masked; below 1 every row is, and
    the output is zeros). Math in f32 with the Pallas kernel's clamps; in
    bf16 the products run on the tensor cores. Bound by bytes (the valid
    K/V rows once). Split-K over chunks of ``decode_chunk(B, KV, S, G)`` rows,
    merged in a fixed order: no atomics, the result repeats bit for bit.
    """
    dev = q.get_device()
    if dev < 0:  # not on a card: every check, then the plain version
        _check(q, k, v, cache_len)
        return ref.decode_attention_ref(q, k, v, cache_len.reshape(()))
    key = (q.dtype, k.dtype, v.dtype, q.shape, k.shape, v.shape, q.stride(),
           k.stride(), v.stride())
    plan = _PLANS.get(key)
    if plan is None:
        _check(q, k, v, cache_len)
        plan = _PLANS[key] = _plan(q, k, v)
    # what the key does not fix: devices, base alignment, cache_len
    qp, kp, vp = q.data_ptr(), k.data_ptr(), v.data_ptr()
    if k.get_device() != dev or v.get_device() != dev:
        raise ValueError(f"q, k, v on devices {dev}, {k.device}, {v.device}")
    if kp % 16 or vp % 16:
        raise ValueError("k/v pointers must be 16-byte aligned")
    if type(cache_len) is not torch.Tensor or cache_len.dtype != torch.int32 \
            or cache_len.numel() != 1 or cache_len.get_device() != dev:
        _check_len(cache_len, q.device)
    # the split-K workspace: one per stream, reused by the calls on it (they
    # run in stream order, so no call overwrites partials another still reads)
    stream = _raw_stream(dev)
    ws = plan.workspaces.get((dev, stream))
    if ws is None:
        ws = plan.workspaces[dev, stream] = torch.empty(
            plan.ws_numel, dtype=torch.float32, device=dev)
    out = torch.empty(plan.out_shape, dtype=q.dtype, device=dev)
    rc = plan.fn(qp, kp, vp, cache_len.data_ptr(), ws.data_ptr(),
                 out.data_ptr(), plan.shape_ptr, stream)
    raise_on(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
