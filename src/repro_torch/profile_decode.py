"""Where the decode-attention kernel's device time goes, on a card.

    python -m repro_torch.profile_decode [--chunks 64,112,256]

For each dense config's decode shape (bf16, B=8, a full cache: SmolLM-135M
at its serve length 1088, the others at 4096 rows) it runs the kernel's
wrapper under ``torch.profiler`` over 20 calls, each after a 64 MB write
that leaves the cache cold in L2, and prints one JSON line with the device
time per call of each of its two kernels (the chunks' partials and their
merge) and of scaled_dot_product_attention on the same inputs. With
``--chunks`` the partial kernel is also run at those chunk sizes instead of
``decode_chunk``'s, through the same C entry point. Needs a card.
"""
from __future__ import annotations

import argparse
import ctypes
import json

import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels.flash_decode import kernel as fd

#: arch -> B, H, KV, D, S
SHAPES = {
    "smollm-135m": (8, 9, 3, 64, 1088),
    "phi3-mini-3.8b": (8, 32, 32, 96, 4096),
    "gemma-7b": (8, 16, 16, 256, 4096),
    "granite-20b": (8, 48, 1, 128, 4096),
}


def device_ms_by_kernel(fn, flush, calls=20) -> dict:
    """Device time per call of each kernel ``fn`` launches, the flush's
    own kernels left out."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as pf:
        flush.zero_()
        torch.cuda.synchronize()
    flush_keys = {e.key for e in pf.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA}
    return {e.key[:60]: e.self_device_time_total / 1e3 / calls
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.key not in flush_keys}


def with_chunk(q, k, v, n, chunk):
    """The wrapper's launch with ``chunk`` rows a block instead of the
    policy's: its plan's shape with the chunk replaced."""
    fd.flash_decode(q, k, v, n)  # make the plan
    key = (q.dtype, k.dtype, v.dtype, q.shape, k.shape, v.shape, q.stride(),
           k.stride(), v.stride())
    plan = fd._PLANS[key]
    shape = fd.DecodeShape.from_buffer_copy(plan.shape)
    shape.chunk = chunk
    B, S, KV, G, Dv = shape.B, shape.S, shape.KV, shape.G, plan.out_shape[2]
    ws = torch.empty(B * KV * -(-S // chunk) * G * (Dv + 2), device=q.device)
    out = torch.empty(plan.out_shape, dtype=q.dtype, device=q.device)
    dev = q.get_device()

    def call():
        rc = plan.fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), n.data_ptr(),
                     ws.data_ptr(), out.data_ptr(), ctypes.addressof(shape),
                     fd._raw_stream(dev))
        fd.raise_on(rc, "flash_decode")
        return out

    return call


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", default="",
                    help="comma-separated chunk sizes to run besides the policy's")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA card")
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    extra = [int(c) for c in args.chunks.split(",") if c]
    for arch, (B, H, KV, D, S) in SHAPES.items():
        q = torch.randn(B, H, D, device=dev, generator=gen).bfloat16()
        k = torch.randn(B, S, KV, D, device=dev, generator=gen).bfloat16()
        v = torch.randn(B, S, KV, D, device=dev, generator=gen).bfloat16()
        n = torch.tensor([S], dtype=torch.int32, device=dev)
        policy = fd.decode_chunk(B, KV, S, H // KV)
        rows = {f"chunk {policy} (policy)": device_ms_by_kernel(
            lambda: fd.flash_decode(q, k, v, n), flush)}
        for chunk in extra:
            call = with_chunk(q, k, v, n, chunk)
            torch.testing.assert_close(call(), fd.flash_decode(q, k, v, n),
                                       rtol=2e-2, atol=2e-2)
            rows[f"chunk {chunk}"] = device_ms_by_kernel(call, flush)
        q4 = q.reshape(B, H, 1, D)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        rows["sdpa"] = device_ms_by_kernel(lambda: F.scaled_dot_product_attention(
            q4, kt, vt, enable_gqa=True), flush)
        print(json.dumps({"arch": arch, "B": B, "H": H, "KV": KV, "D": D,
                          "S": S, "device_ms": rows}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
