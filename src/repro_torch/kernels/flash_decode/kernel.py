"""Wrapper of the CUDA split-K decode-attention kernel
(``csrc/flash_decode.cu``), replacing the Pallas kernel
``repro/kernels/flash_decode/kernel.py::decode_attention_pallas_bkv``.

For a CUDA tensor it launches the kernel or raises; for a CPU tensor it runs
the plain version (``ref.decode_attention_ref``), the only reason it ever
does. It checks device, dtype, shapes and strides and raises on anything the
kernel does not take, allocates the output and the split-K workspace with
``torch.empty``, and counts its launches in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels.build import INT, PTR, ptr, raise_on, stream
from repro_torch.kernels.build import typed_library
from repro_torch.kernels.flash_decode import ref

#: kernel launches since the last ``reset_launches()``; only a launch of the
#: CUDA kernel counts (one per call: the partial and merge kernels together),
#: never a plain-version call
LAUNCHES = {"flash_decode": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: cache rows per block of the partial kernel
CHUNK = 128
#: shared memory a block may use on Hopper (232,448 bytes)
MAX_SMEM = 232448

_LL = ctypes.c_longlong
# q, k, v, cache_len, ws_o, ws_ml, out, B, S, KV, G, D, Dv,
# k_sb, k_ss, v_sb, v_ss, scale, chunk, dtype, stream
_SIGNATURES = {
    "flash_decode": [PTR] * 7 + [INT] * 6 + [_LL] * 4
    + [ctypes.c_float, INT, INT, PTR],
    # G, D, Dv, chunk -> bytes of shared memory of one partial block
    "flash_decode_smem_bytes": [INT] * 4,
}


def reset_launches() -> None:
    LAUNCHES["flash_decode"] = 0


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
    if not isinstance(cache_len, torch.Tensor) or cache_len.dtype != torch.int32 \
            or cache_len.numel() != 1:
        raise TypeError("cache_len must be one int32 in a tensor")
    if cache_len.device != q.device:
        raise ValueError(f"cache_len is on {cache_len.device}, q on {q.device}")
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


def flash_decode(q, k, v, cache_len):
    """Single-token GQA decode attention -> (B, H, Dv) in q's dtype.

    q (B, H, D), k (B, S, KV, D), v (B, S, KV, Dv) f32/bf16 (the cache read
    where it lies, by its strides); cache_len one int32 on q's device, in
    [1, S] (cache rows at or past it are masked; below 1 every row is, and
    the output is zeros). Math in f32 with the Pallas kernel's clamps. Bound
    by bytes at small groups (the valid K/V rows once), by operations at
    Granite's G=48 (CUDA-core FMAs). Split-K over chunks of ``CHUNK`` rows,
    merged in a fixed order: no atomics, the result repeats bit for bit.
    """
    _check(q, k, v, cache_len)
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, cache_len.reshape(()))
    B, H, D = q.shape
    _, S, KV, _ = k.shape
    Dv, G = v.shape[3], H // KV
    if B * KV > 65535:
        raise ValueError(f"B*KV = {B * KV} exceeds the grid's 65535")
    lib = typed_library("flash_decode", _SIGNATURES)
    smem = lib.flash_decode_smem_bytes(G, D, Dv, CHUNK)
    if smem > MAX_SMEM:
        raise ValueError(
            f"a group of {G} heads at D={D}/{Dv} needs {smem} bytes of shared "
            f"memory, over {MAX_SMEM}"
        )
    n_chunks = -(-S // CHUNK)
    dev = q.device
    ws_o = torch.empty((B * KV, n_chunks, G, Dv), dtype=torch.float32, device=dev)
    ws_ml = torch.empty((B * KV, n_chunks, G, 2), dtype=torch.float32, device=dev)
    out = torch.empty((B, H, Dv), dtype=q.dtype, device=dev)
    rc = lib.flash_decode(
        ptr(q), ptr(k), ptr(v), ptr(cache_len), ptr(ws_o), ptr(ws_ml), ptr(out),
        B, S, KV, G, D, Dv, k.stride(0), k.stride(1), v.stride(0), v.stride(1),
        float(1.0 / np.sqrt(D)), CHUNK, DTYPES[q.dtype], stream(dev),
    )
    raise_on(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    return out
