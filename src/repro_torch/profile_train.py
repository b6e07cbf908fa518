"""Where a transformer train step's time goes, on a card.

    python -m repro_torch.profile_train --arch smollm-135m
    python -m repro_torch.profile_train --arch deepseek-v2-236b --layers 2
    python -m repro_torch.profile_train --arch llava-next-mistral-7b \\
        --batch 1 --seq 3520

Builds the config at full width in bf16 (``--layers`` cuts the depth, as
``chip_smoke.py`` phase 21 cuts DeepSeek's), seeds its weights on the card,
takes two train steps (``make_train_step`` + ``adamw(1e-3)`` on the serve
path's seeded prompt draw of ``--batch`` x ``--seq`` tokens, a VLM's patch
rows before them), then one more under ``torch.profiler``, and prints one
JSON line: the card, the step reduced by ``profile_decode.trace_per_step``
(wall, device ms, idle share, torch calls, top kernels) and the device ms
of kernel groups (products, elementwise, copies, reductions, indexing,
other). Needs a card.
"""
from __future__ import annotations

import argparse
import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import serve
from repro_torch.configs import list_archs
from repro_torch.models.transformer.model import init_params, make_train_step
from repro_torch.profile_decode import trace_per_step
from repro_torch.train.optimizer import adamw

#: train steps before the profiled one (allocator growth, library init)
WARM_STEPS = 2

#: kernel group -> name fragments, matched in order
GROUPS = {
    "products": ("gemm", "nvjet", "xmma", "cutlass", "gemv", "sm90_"),
    "indexing": ("index",),
    "copies": ("copy",),
    "reductions": ("reduce", "softmax"),
    "elementwise": ("elementwise",),
}


def group_of(name: str) -> str:
    low = name.lower()
    for group, parts in GROUPS.items():
        if any(p in low for p in parts):
            return group
    return "other"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096,
                    help="text tokens a sequence (a VLM's patch rows come "
                         "before them)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a CUDA card")
    dev = torch.device("cuda")
    cfg = serve.serve_config(args.arch, reduced=False, layers=args.layers)
    model = init_params(cfg, torch.Generator(dev).manual_seed(0))
    tokens = torch.as_tensor(serve.make_prompts(cfg, args.batch, args.seq, 0),
                             device=dev)
    patches = serve.make_patches(cfg, args.batch, 0)
    if patches is not None:
        patches = torch.as_tensor(patches, device=dev).to(model.embed.dtype)
    opt = adamw(1e-3)
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt)
    for _ in range(WARM_STEPS):
        state, _ = step(model, state, tokens, patches)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(model, state, tokens, patches)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    groups = dict.fromkeys([*GROUPS, "other"], 0.0)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            groups[group_of(e.key)] += e.self_device_time_total / 1e3
    out = {
        "card": serve.device_line(), "arch": cfg.name, "layers": cfg.num_layers,
        "batch": args.batch, "rows": cfg.num_patches + args.seq,
        **trace_per_step(prof, wall, 1), "device_ms_by_group": groups,
    }
    print(json.dumps({"profile_train": out}), flush=True)
    return out


if __name__ == "__main__":
    main()
