"""One (architecture, input shape) run on the card, and its roofline record
— the port's counterpart of the record ``repro/launch/dryrun.py::lower_one``
builds (without its lowering for 512 placeholder devices: the port runs the
step on the one card it has, at one card's batch).

    python -m repro_torch.launch.shapes --arch smollm-135m --shape decode_32k
    python -m repro_torch.launch.shapes --arch granite-20b --shape prefill_32k \\
        --layers 4
    python -m repro_torch.launch.shapes --arch deepseek-v2-236b --layers 2

``run_one`` builds the variant config (``input_specs.variant_config``) and
the model from a seed, sizes the batch for the card (``card_batch``; a
config whose weights alone exceed the card, as DeepSeek-V2-236B's 60
layers do, raises until the caller cuts its depth), and runs the shape's
step:

* ``train_4k``: ``make_train_step`` with ``adamw(1e-3)``; one warm step,
  then the median of 3 timed steps;
* ``prefill_32k``: ``make_prefill_step`` at B = 1; one warm call, then one
  timed call;
* ``decode_32k`` and ``long_500k``: ``make_decode_step`` against seeded
  caches, at positions ``seq_len - 7`` to ``seq_len - 1`` (``long_500k``'s
  8192-row ring is then 64 windows past its first row); 2 warm steps, then
  the median of 5 timed steps.

Each time is a host clock around the step, ending in a sync. The record
holds the reference's keys (``arch``, ``shape``, ``kind``, ``chips``,
``flops``, ``bytes_accessed``, ``collectives``, ``memory``, ``params``,
``active_params``, ``variant_window``) and the port's: ``batch``,
``reduced`` (every cut, of batch or depth), ``t_step_s``, ``roofline``
(``roofline.roofline_terms``), ``roofline_share`` (the largest term over
``t_step_s``) and ``mfu`` (``roofline_record``, which phase 21 of
``chip_smoke.py`` and ``profile_train`` build their train records with),
``launches`` (the decode kernel's launches in the run, read as the rise
of its counter, which the run never resets) and ``estimated_bytes``
(``card_bytes`` at the run's batch, beside the measured ``memory``).

Where each count runs: ``flops`` of a train step and of a prefill on the
``meta`` device (no storage, shapes only; ``meta_flops``), counted at two
depths and extrapolated in depth as the reference's dry-run does (every
layer past the lead ones is the same, and a 32768-row flash loop is some
9,000 counted operations a layer, each dispatched in Python); of a
decode step in its first warm step on the card, since the decode kernel's
wrapper refuses a ``meta`` tensor, plus the kernel's own count
(``flash_decode.kernel.decode_flops``) for each attention layer: the
counter never sees its launch. ``bytes_accessed`` is
``roofline.step_bytes``, from shapes.

``train_rank`` is a rank function for ``launch/spmd.py::launch`` (beside
``serve.serve_rank``): ``make_train_step`` with ``adamw`` on a rank of a
(data, model) mesh, its weights built with the mesh one leaf at a time,
its rows of one seeded batch; it returns the rank's losses, its slices
after the steps (or their errors against an unsharded run's), digests of
its replicated leaves, its collectives (each step's, the adjoints and the
data-axis gradient mean included, and a ``roofline_record`` of the last),
its peak bytes on a card and its coordinates.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import hashlib
import json
import math
import statistics
import time

import torch

from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.flash_decode import kernel as flash_decode
from repro_torch.launch import roofline
from repro_torch.launch.input_specs import (
    INPUT_SHAPES,
    batch_struct,
    card_batch,
    card_bytes,
    input_specs,
    variant_config,
)
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.mesh import collective_record
from repro_torch.launch.sharding import (
    batch_slice,
    model_dim,
    param_specs,
    spec_slice,
)
from repro_torch.models.transformer.model import (
    empty_params,
    init_params,
    lm_grads,
    lm_loss,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    transformer_params_from_jax,
)
from repro_torch.train.optimizer import adamw

#: prefill runs one sequence: a 32768-row prefill of the plain flash loop
#: takes seconds a layer
PREFILL_BATCH = 1
DECODE_WARM, DECODE_TIMED = 2, 5
TRAIN_TIMED = 3
TRAIN_LR = 1e-3
#: ``train_rank``'s count of weights off the reference: by more than this
#: share of their leaf's max abs
REF_TOL = 1e-4


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def attention_layers(cfg) -> int:
    """Layers whose decode step launches the decode kernel: every attention
    layer, none of an SSM model's, none with MLA absorbed."""
    if cfg.family == "ssm" or (cfg.use_mla and cfg.opt_mla_absorb):
        return 0
    return cfg.num_layers


def decode_kernel_dims(cfg) -> tuple[int, int, int, int]:
    """(H, KV, D, Dv) of the decode kernel's calls: MLA's expanded heads
    (every head its own KV head, D = nope + rope, Dv = v_head_dim)."""
    if cfg.use_mla:
        return (cfg.num_heads, cfg.num_heads, cfg.qk_nope_dim + cfg.qk_rope_dim,
                cfg.v_head_dim)
    return cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.head_dim


def meta_flops(cfg, kind: str, batch: int, rows: int) -> int:
    """The products' flops of one train step (``lm_loss``, its gradients;
    AdamW makes none) or one prefill, counted by ``FlopCounterMode`` on
    ``meta`` tensors at the full shape. Deeper than the lead layers plus 2,
    it counts the lead layers plus 1 and plus 2 and extrapolates in depth,
    as ``repro/launch/dryrun.py`` does: each further layer is the same."""
    n_lead = cfg.first_dense_layers if cfg.family == "moe" else 0
    if cfg.num_layers <= n_lead + 2:
        return _meta_flops(cfg, kind, batch, rows)
    small = _meta_flops(dataclasses.replace(cfg, num_layers=n_lead + 1), kind,
                        batch, rows)
    mid = _meta_flops(dataclasses.replace(cfg, num_layers=n_lead + 2), kind,
                      batch, rows)
    return small + (cfg.num_layers - n_lead - 1) * (mid - small)


def _meta_flops(cfg, kind, batch, rows):
    model = empty_params(cfg, "meta")
    b = batch_struct(cfg, batch, rows, "meta")
    tokens, patches = b["tokens"], b.get("patches")
    if kind == "train":
        def step():
            total, _ = lm_loss(model, tokens, patches)
            torch.autograd.grad(total, list(model.parameters()))
    elif kind == "prefill":
        def step():
            with torch.no_grad():
                make_prefill_step(cfg)(model, tokens, patches)
    else:
        raise ValueError(f"meta_flops counts train and prefill, not {kind!r}")
    return roofline.count_flops(step)[1]


def roofline_record(cfg, model, shape_name: str, batch: int, rows: int,
                    t_step: float, *, flops: int | None = None,
                    cache_len: int = 0, mesh=None) -> dict:
    """The roofline part of a record of one step of ``shape_name``'s kind
    at ``batch`` sequences of ``rows`` rows (decode: one row against
    ``cache_len`` valid cache rows), timed at ``t_step`` seconds: the
    reference's keys (``shape``, ``kind``, ``chips``, ``flops``,
    ``bytes_accessed``, ``collectives``, ``params``, ``active_params``,
    ``variant_window``), ``batch``, ``rows``, ``roofline``,
    ``roofline_share`` and ``mfu``. ``flops`` defaults to ``meta_flops``
    (train and prefill); ``bytes_accessed`` is ``roofline.step_bytes``.
    With ``mesh`` (the step ran on a rank of it) ``chips`` is the mesh's
    ranks and ``collectives`` the rank's exchange counters
    (``launch/mesh.py::collective_record``, which the caller set to 0 just
    before the step); without one, one card and no exchange."""
    kind = INPUT_SHAPES[shape_name].kind
    if flops is None:
        flops = meta_flops(cfg, kind, batch, rows)
    rec = {
        "shape": shape_name, "kind": kind,
        "chips": 1 if mesh is None else math.prod(mesh.shape.values()),
        "batch": batch, "rows": rows, "flops": flops,
        "bytes_accessed": roofline.step_bytes(model, kind, batch, rows,
                                              cache_len),
        "collectives": ({"total": 0, "count": 0} if mesh is None
                        else collective_record()),
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "variant_window": cfg.attn_window,
    }
    rec["roofline"] = roofline.roofline_terms(rec)
    rec["roofline_share"] = roofline.roofline_share(rec["roofline"], t_step)
    rec["mfu"] = roofline.mfu(rec["roofline"]["model_flops"], t_step)
    return rec


def _timed(fn, device) -> float:
    _sync(device)
    t0 = time.perf_counter()
    fn()
    _sync(device)
    return time.perf_counter() - t0


def run_one(arch: str, shape_name: str, device="cuda", *, layers=None,
            batch=None, reduced: bool = False, after=None) -> dict:
    """Run ``shape_name``'s step of ``arch`` on ``device`` and return its
    record (module docstring). ``layers`` cuts the depth, ``batch`` sets
    the batch in place of ``card_batch``'s, ``reduced`` takes the config's
    reduced variant (for the CPU); weights, tokens and caches are drawn
    from one generator seeded 0. ``after``, if given, is called with the
    model, the variant config and the inputs (``input_specs``' dict, the
    caches updated by the steps) before they are freed. On
    ``device="cuda"`` without a card it raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: pass device='cpu' to run on the CPU")
    shape = INPUT_SHAPES[shape_name]
    base = get_arch(arch)
    full_layers = base.num_layers
    cuts = []
    if reduced:
        base = base.reduced()
        cuts.append("the config's reduced variant (2 layers, narrow, f32)")
    if layers and layers < base.num_layers:
        base = dataclasses.replace(base, num_layers=layers)
        cuts.append(f"depth cut from {full_layers} to {layers} layers, widths "
                    "unchanged")
    cfg = variant_config(base, shape)
    if batch is None:
        most = PREFILL_BATCH if shape.kind == "prefill" else None
        B, batch_cuts = card_batch(cfg, shape, most=most)
        if most is not None and B == most < shape.global_batch:
            batch_cuts = [f"batch cut from {shape.global_batch} to "
                          f"{PREFILL_BATCH}: a 32768-row prefill of the plain "
                          "flash loop takes seconds a layer"]
        cuts += batch_cuts
    else:
        B = batch
        if B != shape.global_batch:
            cuts.append(f"batch set to {B} of {shape.global_batch}")

    if device.type == "cuda":
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        baseline = torch.cuda.memory_allocated(device)
    gen = torch.Generator(device).manual_seed(0)
    model = init_params(cfg, gen)
    S = shape.seq_len
    launches0 = flash_decode.LAUNCHES["flash_decode"]
    if shape.kind == "decode":
        steps = DECODE_WARM + DECODE_TIMED
        pos0 = S - steps
        specs = input_specs(cfg, shape_name, device, gen, batch=B, pos=pos0)
        tokens, caches = specs["batch"]["tokens"], specs["caches"]
        decode = make_decode_step(cfg)
        pos = specs["pos"].long()  # one cast, not one a layer and step
        times = []
        with torch.inference_mode():
            (logits, _), flops = roofline.count_flops(decode, model, tokens,
                                                      pos, caches)
            for t in range(1, steps):
                out = {}

                def call(t=t):
                    out["logits"], _ = decode(model, tokens, pos + t, caches)

                times.append(_timed(call, device))
                logits = out["logits"]
        times = times[DECODE_WARM - 1:]
        t_step = statistics.median(times)
        S_phys = min(S, cfg.attn_window) if cfg.attn_window else S
        cache_len = min(pos0 + DECODE_WARM + DECODE_TIMED // 2 + 1, S_phys)
        H, KV, D, Dv = decode_kernel_dims(cfg)
        flops += attention_layers(cfg) * flash_decode.decode_flops(
            B, H, cache_len, D, Dv)
        rows = 1
    elif shape.kind == "prefill":
        specs = input_specs(cfg, shape_name, device, gen, batch=B)
        b = specs["batch"]
        prefill = make_prefill_step(cfg)
        with torch.inference_mode():
            _, pre = prefill(model, b["tokens"], b.get("patches"))  # warm
            del pre
            _sync(device)
            out = {}

            def call():
                out["logits"], _ = prefill(model, b["tokens"], b.get("patches"))

            t_step = _timed(call, device)
            logits = out["logits"]
        times = [t_step]
        steps = 2
        flops, rows, cache_len = None, S, 0
    else:
        specs = input_specs(cfg, shape_name, device, gen, batch=B)
        b = specs["batch"]
        opt = adamw(TRAIN_LR)
        state = opt.init(list(model.parameters()))
        step = make_train_step(cfg, opt)
        times, losses = [], []
        for _ in range(1 + TRAIN_TIMED):
            res = {}

            def call():
                res["state"], res["metrics"] = step(model, state, b["tokens"],
                                                    b.get("patches"))

            times.append(_timed(call, device))
            state = res["state"]
            losses.append(res["metrics"]["loss"])
        logits = torch.stack(losses)
        times = times[1:]
        t_step = statistics.median(times)
        steps = 1 + TRAIN_TIMED
        flops, rows, cache_len = None, S, 0
    launches = flash_decode.LAUNCHES["flash_decode"] - launches0
    memory = (torch.cuda.max_memory_allocated(device) - baseline
              if device.type == "cuda" else None)
    finite = bool(torch.isfinite(logits.float()).all())
    record = {
        "arch": arch,
        "device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                   else str(device)),
        **roofline_record(cfg, model, shape_name, B, rows, t_step,
                          flops=flops, cache_len=cache_len),
        "memory": memory, "estimated_bytes": card_bytes(cfg, shape, B),
        "layers": cfg.num_layers, "reduced": cuts,
        "steps": steps, "step_s": times, "t_step_s": t_step,
        "launches": launches, "attention_layers": attention_layers(cfg),
        "logits_finite": finite,
    }
    if shape.kind == "decode" and cfg.family != "ssm":
        record["cache_len"] = cache_len
    if after is not None:
        after(model, cfg, specs)
    return record


def train_batch(cfg, batch: int, seq: int, seed: int) -> dict:
    """One seeded train batch (numpy): ``tokens`` (B, S) or (B, S, nc) of
    ``seq`` rows (``serve.make_prompts``), and a VLM's ``patches``
    (``serve.make_patches``), whose rows come before the text's."""
    from repro_torch.serve import make_patches, make_prompts

    out = {"tokens": make_prompts(cfg, batch, seq, seed)}
    patches = make_patches(cfg, batch, seed)
    if patches is not None:
        out["patches"] = patches
    return out


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().view(torch.uint8)
                          .numpy().tobytes()).hexdigest()


def train_rank(device, cfg, mesh_shape, steps: int, batch: int = 2,
               seq: int = 1024, seed: int = 0, *, data=None, np_params=None,
               grad_terms=(), reference=None, keep_params: bool = False,
               record: bool = True) -> dict:
    """A rank function for ``launch``: ``steps`` steps of
    ``make_train_step(cfg, adamw(TRAIN_LR), mesh)`` on a
    ``make_mesh(mesh_shape)`` mesh, on the rank's ``device``.

    The weights are ``np_params`` (the JAX package's tree as numpy arrays,
    ``transformer_params_from_jax``) or ``init_params`` from a generator on
    the device seeded ``seed``, both built with the mesh (one leaf at a
    time: the rank never holds the whole model). The batch is ``data``
    (``train_batch``'s dict, the whole batch) or ``train_batch(cfg, batch,
    seq, seed)``; the rank takes its rows (``batch_slice``). Before the
    steps, the gradients of each term of ``grad_terms`` (``lm_grads``:
    ``"total"``, ``"loss"``, ``"aux"``) are kept as numpy slices.

    Returns (host data): ``losses`` (a step's {"loss", "aux"}: the rank's
    term), ``collectives`` (each step's ``collective_record``),
    ``step_ms`` (CUDA events on a card, the host clock on the CPU),
    with ``record`` a ``record`` (``roofline_record`` of the last step with
    the mesh: its collectives, the adjoints and the data-axis gradient mean
    included; its flops the unsharded step's over the rank's rows, counted
    on ``meta``), ``coords``,
    ``param_shapes`` and ``slot_shapes`` (AdamW's m and v), ``digests``
    (the sha256 of each replicated leaf after the steps), ``grads`` (term
    -> name -> slice), ``params`` (name -> slice after the steps) with
    ``keep_params``, and with ``reference`` (a dict, or the path of its
    ``torch.save``: {"params": name -> the unsharded leaf after the same
    steps,
    "scale": name -> its max abs; optionally "first_m": name -> AdamW's m
    after the first step, (1 - b1) times its gradient, "first_m_scale": its
    max abs}) ``param_err``: each slice's max abs error against the
    reference's slice over the leaf's max abs, with ``param_off`` (its
    entries off by more than ``REF_TOL`` times that max abs),
    ``param_off_max`` (the largest of those errors) and ``param_count``
    (the rank's entries); with the reference's first m also ``grad_err``
    (the rank's first m, so its first-step gradient, against the
    reference's slice over the leaf's max abs) and ``param_off_grad`` (the
    largest |m| / max |m| of the reference's first m at the entries
    off). On a card also ``peak_bytes`` (``max_memory_allocated``
    over the steps)."""
    if isinstance(cfg, str):
        cfg = get_arch(cfg)
    device = torch.device(device)
    mesh = mesh_mod.make_mesh(mesh_shape)
    on_card = device.type == "cuda"
    if np_params is not None:
        model = transformer_params_from_jax(np_params, cfg, device, mesh)
    else:
        model = init_params(cfg, torch.Generator(device).manual_seed(seed), mesh)
    data = train_batch(cfg, batch, seq, seed) if data is None else data
    rows = batch_slice(cfg, {k: torch.as_tensor(v) for k, v in data.items()},
                       mesh)
    tokens = rows["tokens"].to(device)
    patches = rows.get("patches")
    if patches is not None:
        patches = patches.to(device, model.embed.dtype)
    names = [n for n, _ in model.named_parameters()]
    out = {"coords": dict(mesh.coords), "grads": {}}
    for term in grad_terms:
        grads, _ = lm_grads(model, tokens, patches, term)
        out["grads"][term] = {n: g.float().cpu().numpy()
                              for n, g in zip(names, grads, strict=True)}
        del grads
    ref = specs = None
    if reference is not None:
        ref = reference if isinstance(reference, dict) else torch.load(
            reference, mmap=True)
        specs = param_specs(cfg, ref["params"], mesh)

        def ref_slice(kind, n):
            return spec_slice(ref[kind][n], specs[n], mesh).to(device).float()

    opt = adamw(TRAIN_LR)
    state = opt.init(list(model.parameters()))
    step = make_train_step(cfg, opt, mesh)
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    losses, collectives, step_ms = [], [], []
    for k in range(steps):
        mesh_mod.reset_collectives()
        if on_card:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        else:
            t0 = time.perf_counter()
        state, metrics = step(model, state, tokens, patches)
        if on_card:
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        else:
            step_ms.append(1e3 * (time.perf_counter() - t0))
        collectives.append(collective_record())
        losses.append({n: float(v) for n, v in metrics.items()})
        if k == 0 and ref is not None and "first_m" in ref:
            # AdamW's first m is (1 - b1) g: the first step's gradient
            out["grad_err"] = {
                n: float((m.float() - ref_slice("first_m", n)).abs().max())
                / max(ref["first_m_scale"][n], 1e-30)
                for n, m in zip(names, state.slots["m"], strict=True)}
    out.update(losses=losses, collectives=collectives, step_ms=step_ms)
    if on_card:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if record:
        # the flops of one rank's rows through the unsharded model (the
        # expert-local dispatch counts as the global one)
        B_loc = tokens.shape[0]
        flops = meta_flops(dataclasses.replace(cfg, opt_moe_shard_map=False),
                           "train", B_loc, seq)
        out["record"] = roofline_record(
            cfg, empty_params(cfg, "meta"), "train_4k", B_loc, seq,
            statistics.median(step_ms) / 1e3, flops=flops, mesh=mesh)
    named = dict(model.named_parameters())
    out["param_shapes"] = {n: tuple(t.shape) for n, t in named.items()}
    out["slot_shapes"] = {k: [tuple(t.shape) for t in v]
                          for k, v in state.slots.items()}
    out["digests"] = {n: _digest(t) for n, t in named.items()
                      if model_dim(t) is None}
    if keep_params:
        out["params"] = {n: t.detach().float().cpu().numpy()
                         for n, t in named.items()}
    if ref is not None:
        out.update(param_err={}, param_off={}, param_off_max={},
                   param_count=sum(t.numel() for t in named.values()))
        if "first_m" in ref:
            out["param_off_grad"] = {}
        for n, t in named.items():
            diff = (t.detach().float() - ref_slice("params", n)).abs()
            scale = max(ref["scale"][n], 1e-30)
            off = diff > REF_TOL * scale
            out["param_err"][n] = float(diff.max()) / scale
            out["param_off"][n] = int(off.sum())
            any_off = bool(off.any())
            out["param_off_max"][n] = float(diff[off].max()) if any_off \
                else 0.0
            if "first_m" in ref:  # the largest first-step |g| / max |g| there
                g = ref_slice("first_m", n).abs()[off]
                out["param_off_grad"][n] = float(g.max()) / max(
                    ref["first_m_scale"][n], 1e-30) if any_off else 0.0
        del ref
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--shape", default="decode_32k", choices=list(INPUT_SHAPES))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth, widths unchanged (DeepSeek-V2-236B's "
                         "60 layers exceed the card: it runs at 2)")
    ap.add_argument("--batch", type=int, default=None,
                    help="the batch (default: the largest that fits the card)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu, which runs the kernels' "
                         "plain versions")
    ap.add_argument("--reduced", action="store_true",
                    help="the config's reduced variant (2 layers, f32)")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA card: pass --device cpu to run on the CPU")
        from repro_torch.serve import device_line

        print(device_line(), flush=True)
    record = run_one(args.arch, args.shape, args.device, layers=args.layers,
                     batch=args.batch, reduced=args.reduced)
    print(json.dumps({"shape_record": record}), flush=True)
    return record


if __name__ == "__main__":
    main()
