"""Serve a transformer of any of the six families with batched requests:
prefill the prompt batch, then decode new tokens greedily, step by step,
against the caches. The counterpart of ``examples/serve_transformer.py``, at
full width by default.

    python -m repro_torch.serve --arch smollm-135m            # on the card
    python -m repro_torch.serve --arch deepseek-v2-lite-16b   # MoE + MLA
    python -m repro_torch.serve --arch mamba2-2.7b --reduced --device cpu \\
        --batch 2 --prompt-len 16 --new-tokens 8

The prompts are drawn with numpy from ``--seed`` ((B, S, nc) for an audio
model's codebooks), a VLM's patch rows (``num_patches`` of them, before the
prompt) likewise, and the weights with a ``torch.Generator`` from the same
seed. Decoding writes each new K/V (latent) row into the cache and each SSM
state in place and keeps the position on the device, so the decode loop
makes no host sync; the tokens come back in one transfer at the end. On the
card it prints the ``nvidia-smi`` name and power limit, the prefill time,
the median decode time per step (CUDA events) and tokens per second.

Across ranks, ``generate`` of a model sharded on a (data, model) mesh
(``launch/mesh.py``; ``init_params(mesh=...)``) serves on that mesh: each
rank takes its rows of the batch and its slice of the caches, and returns
its rows' tokens and logits. ``serve_rank`` is a rank function for
``launch/spmd.py::launch``: it builds the mesh and its slice of the weights
(seeded, or the caller's) one leaf at a time, and serves, with its launches,
collectives and peak memory counted.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import statistics
import subprocess
import time

import numpy as np
import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.flash_decode import kernel as flash_decode_kernel
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.sharding import batch_slice, model_dim
from repro_torch.models.transformer.model import (
    init_caches,
    init_params,
    make_decode_step,
    make_prefill_step,
    transformer_params_from_jax,
)
from repro_torch.obs.memory import peak_profile


def device_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def make_prompts(cfg, batch: int, prompt_len: int, seed: int) -> np.ndarray:
    """(B, S) int64 prompt ids, (B, S, nc) with codebooks, as
    ``examples/serve_transformer.py`` draws them
    (``default_rng(seed).integers(0, vocab)``)."""
    rng = np.random.default_rng(seed)
    shape = (batch, prompt_len) + ((cfg.num_codebooks,) if cfg.num_codebooks
                                   else ())
    return rng.integers(0, cfg.vocab_size, shape).astype(np.int64)


def make_patches(cfg, batch: int, seed: int) -> np.ndarray | None:
    """A VLM's (B, num_patches, d) float32 patch embeddings (the vision tower
    is a stub, as in the reference): standard normal from
    ``default_rng(seed + 1)``; None for a model without patches."""
    if not cfg.num_patches:
        return None
    rng = np.random.default_rng(seed + 1)
    return rng.standard_normal((batch, cfg.num_patches, cfg.d_model),
                               dtype=np.float32)


def fill_caches(caches: list, prefill: list, mesh=None) -> None:
    """Copy each layer's prefill cache into the decode-length caches, in
    place, whatever its keys: a row-indexed tensor (k/v, c_kv/k_rope) into
    rows [0, n) (a windowed prefill's last W rows into slots [0, W), as
    ``examples/serve_transformer.py`` does), an SSM state whole. A decode
    cache sharded by sequence (``sharding.model_dim`` 1: MLA's latents, k/v
    whose KV heads do not divide the model axis) holds rows [j * S_loc,
    (j + 1) * S_loc) of ``mesh``'s model rank j, of the prefill's rows,
    which are every row. An SSM state sharded by head is the rank's heads
    already (the prefill computes only those)."""
    for dst, src in zip(caches, prefill, strict=True):
        for name, s in src.items():
            d = dst[name]
            if isinstance(s, dict):
                fill_caches([d], [s], mesh)
            elif model_dim(d) == 1 and name != "state":
                off = mesh.model_index * d.shape[1]
                rows = s[:, off:off + d.shape[1]]
                d[:, : rows.shape[1]].copy_(rows)
            elif d.shape == s.shape:
                d.copy_(s)
            else:
                d[:, : s.shape[1]].copy_(s)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def generate(model, prompts: torch.Tensor, new_tokens: int,
             patches: torch.Tensor | None = None) -> dict:
    """Prefill ``prompts`` ((B, S), or (B, S, nc) with codebooks; a VLM's
    ``patches`` (B, Np, d) before them) and decode ``new_tokens`` tokens
    greedily (each codebook's own argmax): the first from the prefill's
    logits, then ``new_tokens - 1`` decode steps at positions ``Np + S + t``,
    as the JAX example does.

    Returns, on the host, ``tokens`` (B, new_tokens) or (B, new_tokens,
    nc), ``step_logits`` (new_tokens, B, V) or (new_tokens, B, nc, V): the
    prefill's last position, then each decode step's, as float32, and the
    last of them as ``logits``; and ``prefill_ms`` (host clock, ending in a
    sync, including the copy of the prefill caches into the decode-length
    caches), ``step_ms`` (each decode step: CUDA events on the card, the
    host clock on the CPU) and ``decode_ms`` (the whole decode loop, host
    clock, ending in a sync).

    On a model sharded on a mesh (``model.mesh``): ``prompts`` and
    ``patches`` are the whole batch, of which the rank serves its rows
    (``batch_specs``; the data axes, when more than one rank, must divide
    the batch), and the results are those rows', with ``rows``, their
    [start, stop) in the batch, and ``cache_shapes``, the shapes of the
    rank's caches.
    """
    cfg = model.cfg
    mesh = model.mesh
    device = prompts.device
    B, S = prompts.shape[:2]
    if patches is not None and not cfg.num_patches:
        raise ValueError(f"{cfg.name} takes no patches")
    start_pos = S + (patches.shape[1] if patches is not None else 0)
    prefill = make_prefill_step(cfg, mesh)
    decode = make_decode_step(cfg, mesh)
    caches = init_caches(cfg, B, start_pos + new_tokens, device, mesh)
    rows = (0, B)
    if mesh is not None:  # init_caches raised unless the data axes split B
        n = B // mesh.data_size
        rows = (mesh.data_index * n, (mesh.data_index + 1) * n)
        batch = {"tokens": prompts}
        if patches is not None:
            batch["patches"] = patches
        batch = batch_slice(cfg, batch, mesh)
        prompts, patches = batch["tokens"], batch.get("patches")
    _sync(device)
    t0 = time.perf_counter()
    logits, pre = prefill(model, prompts, patches)
    fill_caches(caches, pre, mesh)
    del pre
    _sync(device)
    prefill_ms = 1e3 * (time.perf_counter() - t0)

    # (B, 1) or (B, 1, nc): the greedy token of each codebook
    tok = logits[:, -1:].argmax(dim=-1)
    generated, step_logits = [tok], [logits[:, -1]]
    pos = torch.tensor(start_pos, dtype=torch.int64, device=device)
    on_card = device.type == "cuda"
    marks = []
    t0 = time.perf_counter()
    for _ in range(new_tokens - 1):
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            start = time.perf_counter()
        logits, caches = decode(model, tok, pos, caches)
        tok = logits[:, -1:].argmax(dim=-1)
        generated.append(tok)
        step_logits.append(logits[:, -1])
        pos = pos + 1
        if on_card:
            end.record()
            marks.append((start, end))
        else:
            marks.append(1e3 * (time.perf_counter() - start))
    _sync(device)
    decode_ms = 1e3 * (time.perf_counter() - t0)
    step_ms = [s.elapsed_time(e) for s, e in marks] if on_card else marks
    step_logits = torch.stack(step_logits).float().cpu()
    out = {
        "tokens": torch.cat(generated, dim=1).cpu(),
        "step_logits": step_logits,
        "logits": step_logits[-1],
        "prefill_ms": prefill_ms,
        "step_ms": step_ms,
        "decode_ms": decode_ms,
    }
    if mesh is not None:
        out["rows"] = rows
        out["cache_shapes"] = [_shapes(c) for c in caches]
    return out


def _shapes(cache: dict) -> dict:
    return {k: _shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in cache.items()}


def serve_rank(device, cfg, mesh_shape, new_tokens: int, batch: int = 8,
               prompt_len: int = 1024, seed: int = 0, *, prompts=None,
               patches=None, np_params=None, profile_peak: bool = False) -> dict:
    """A rank function for ``launch``: ``generate`` of ``cfg`` (an
    ``ArchConfig`` or an architecture's name) on a ``make_mesh(mesh_shape)``
    mesh, on the rank's ``device``.

    The weights are ``np_params`` (the JAX package's tree as numpy arrays,
    ``transformer_params_from_jax``) or ``init_params`` from a generator on
    the device seeded ``seed``, both built with the mesh: the rank makes one
    leaf at a time and keeps its slice, so it never holds the whole model.
    The prompts (and a VLM's patches) are the caller's, or
    ``make_prompts``/``make_patches`` of ``batch`` x ``prompt_len`` from
    ``seed``. Returns ``generate``'s results (host data) with the rank's
    ``coords``, the shapes of its parameter slices (``param_shapes``), its
    decode-kernel launches (``launches``) and its collectives
    (``collectives``, ``mesh.collective_record``), both counted over the
    ``generate`` call alone, and whether its collectives crossed the host
    (``host_transport``). On a card also ``build_peak_bytes`` (the most
    bytes allocated while the weights were built, beyond those allocated
    before), ``param_bytes`` (the rank's slices), ``max_memory_allocated``
    over the ``generate`` call and, with ``profile_peak``, ``peak_profile``
    (``obs/memory.py``: what was alive at that peak; the profile's history
    slows the run)."""
    if isinstance(cfg, str):
        cfg = get_arch(cfg)
    mesh = mesh_mod.make_mesh(mesh_shape)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
        before = torch.cuda.memory_allocated(device)
    if np_params is not None:
        model = transformer_params_from_jax(np_params, cfg, device, mesh)
    else:
        model = init_params(cfg, torch.Generator(device).manual_seed(seed), mesh)
    if on_card:
        build_peak = torch.cuda.max_memory_allocated(device) - before
    if prompts is None:
        prompts = make_prompts(cfg, batch, prompt_len, seed)
        patches = make_patches(cfg, batch, seed)
    prompts = torch.as_tensor(prompts, device=device)
    if patches is not None:
        patches = torch.as_tensor(patches, device=device).to(model.embed.dtype)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    flash_decode_kernel.reset_launches()
    mesh_mod.reset_collectives()
    with (peak_profile(device) if profile_peak and on_card
          else contextlib.nullcontext()) as peak:
        out = generate(model, prompts, new_tokens, patches)
    out["launches"] = dict(flash_decode_kernel.LAUNCHES)
    out["collectives"] = mesh_mod.collective_record()
    out["coords"] = dict(mesh.coords)
    out["param_shapes"] = {k: tuple(v.shape)
                           for k, v in model.named_parameters()}
    out["host_transport"] = mesh.host_transport
    if on_card:
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        out["build_peak_bytes"] = build_peak
        out["param_bytes"] = sum(p.numel() * p.element_size()
                                 for p in model.parameters())
    if peak is not None:
        out["peak_profile"] = peak
    return out


def serve_config(arch: str, reduced: bool, layers: int | None = None):
    """The architecture at full width, or the example's reduced config;
    ``layers`` cuts the depth (widths unchanged)."""
    full = get_arch(arch)
    cfg = full.reduced(attn_window=16 if full.attn_window else None) \
        if reduced else full
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="the example's reduced config (2 layers, f32)")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (DeepSeek-V2-236B "
                         "fits one card at 2)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=1024)
    ap.add_argument("--new-tokens", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass --device cpu to run on the CPU")
    if device.type == "cuda":
        print(device_line(), flush=True)
    cfg = serve_config(args.arch, args.reduced, args.layers)
    model = init_params(cfg, torch.Generator(device).manual_seed(args.seed))
    prompts = torch.as_tensor(
        make_prompts(cfg, args.batch, args.prompt_len, args.seed), device=device)
    patches = make_patches(cfg, args.batch, args.seed)
    if patches is not None:
        patches = torch.as_tensor(patches, device=device).to(model.embed.dtype)
    print(f"serving {cfg.name} ({'reduced' if args.reduced else 'full width'}: "
          f"{cfg.family}, {cfg.num_layers}L d={cfg.d_model} {cfg.num_heads}/"
          f"{cfg.num_kv_heads} heads, {cfg.dtype}) on {device}", flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    out = generate(model, prompts, args.new_tokens, patches)
    B, S = prompts.shape[:2]
    steps = args.new_tokens - 1
    out["decode_ms_per_step"] = statistics.median(out["step_ms"]) if steps else None
    out["tokens_per_s"] = B * steps / (out["decode_ms"] / 1e3) if steps else None
    rows = f" + {patches.shape[1]} patch rows" if patches is not None else ""
    print(f"prefill: {B}x{S} tokens{rows} in {out['prefill_ms']:.3f} ms")
    if steps:
        print(f"decode: {steps} steps x {B} sequences, median "
              f"{out['decode_ms_per_step']:.3f} ms per step, "
              f"{out['tokens_per_s']:.1f} tokens/s")
    if device.type == "cuda":
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
        print(f"peak device memory: {out['max_memory_allocated']} bytes")
    print("sample output ids:", out["tokens"][0].reshape(-1)[:16].tolist())
    if not torch.isfinite(out["logits"]).all():
        raise RuntimeError("non-finite logits")
    return out


if __name__ == "__main__":
    main()
