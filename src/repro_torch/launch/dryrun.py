"""Shape-only dry run of the production meshes — the counterpart of
``repro/launch/dryrun.py``.

The reference lowers and compiles each step for 512 placeholder devices and
reads XLA's ``memory_analysis()`` and ``cost_analysis()``. There is no XLA
program to lower here. For one rank of the production mesh (16 x 16, or
2 x 16 x 16 across two pods) the port runs the real step on ``meta``
tensors, which carry shapes and dtypes and no storage:

* the rank's slices of the parameters (``sharding.param_slice``, by
  ``shard_params`` of an ``empty_params`` model), in train also the
  optimizer's state (``adamw(1e-3).init`` of the slices, whose specs are
  ``opt_state_specs``), the rank's rows of the global batch that
  ``input_specs`` gives (``batch_slice``) and, in decode, its slices of the
  caches (``cache_slice``) at the reference's position ``seq_len - 1``;
* on ``abstract_mesh(production_shape(multi_pod), coords=...)``, whose
  collectives count their calls and bytes exactly as a real rank's and
  return ``meta`` results (``launch/mesh.py``);
* through ``make_train_step(cfg, adamw(1e-3), mesh)``,
  ``make_prefill_step(cfg, mesh)`` or ``make_decode_step(cfg, mesh)``.

    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    python -m repro_torch.launch.dryrun --arch smollm-135m   # its 4 shapes
    python -m repro_torch.launch.dryrun --all [--multi-pod] [--fast]

Each record is written to ``--out`` (``results/dryrun`` by default) and a
record already there is skipped, as the reference's cache does; a failure
is printed and the sweep goes on, and it exits 1 unless every record was
made (``all dry-runs OK``).

``lower_one`` returns a record with the reference's keys: ``arch``,
``shape``, ``kind``, ``mesh``, ``chips``, ``flops``, ``bytes_accessed``,
``flops_global``, ``collectives`` (``mesh.collective_record``, with
``by_axis``), ``memory`` (``argument_size_gib``, ``output_size_gib``,
``temp_size_gib``, ``peak_gib``), ``params``, ``active_params``,
``variant_window``, ``opts`` and ``roofline`` (``roofline_terms`` at the
H100 constants of ``launch/roofline.py``). What is not the reference's:

* Per rank, ``flops`` are the products ``FlopCounterMode`` counts over the
  pass, plus the decode kernel's attention (``decode_attention_flops``,
  from the shapes as ``shapes.decode_kernel_dims`` gives them): on ``meta``
  the kernel's wrapper computes nothing, so the counter sees none of it.
  ``bytes_accessed`` is the least-bytes count of ``roofline.step_bytes``
  over the rank's slices (each input read once, each output written once),
  not XLA's sum over its operations: the record says so in ``bytes_basis``.
* Memory: ``argument_size`` is the rank's inputs, exactly (the storages of
  its slices, optimizer state, rows and caches); ``output_size`` what the
  step returns (a train step updates the parameters in place and returns
  the optimizer state and the metrics); ``peak`` the most bytes of live
  ``meta`` storage over the pass, arguments included
  (``obs/memory.py::LiveStorage``); ``temp`` is ``peak - argument``. The
  decode kernel's split-K workspace, kept once per shape by its wrapper,
  is not in it.
* Depth: ``t_trace_s`` (the pass's host seconds) replaces ``t_compile_s``;
  ``scan_hlo_crosscheck`` has no counterpart (there is no HLO and no
  scan). By default the pass runs at the lead layers (a MoE model's dense
  ones) plus 1 and plus 2, and flops, bytes, every collective counter and
  the memory terms are extrapolated linearly in depth, as
  ``shapes.meta_flops`` does: each further layer is the same, and a
  32768-row flash loop is thousands of shape-only operations a layer, each
  dispatched in Python. ``fast=True`` (``--fast``), as the reference's,
  skips the extrapolation: one pass at full depth, which here is the
  slower choice (the record's ``depth`` says which was taken).
* Which rank: the record is rank (0, ..., 0)'s (``coords``); every
  coordinate gives the same record (each rank holds slices of the same
  shapes and runs the same collectives).

``rank_pass`` and ``serve_pass`` are the same pass at any mesh, batch and
length: ``chip_smoke.py`` phases 24 and 25 and the tests hold them against
ranks that really run.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.input_specs import (
    INPUT_SHAPES,
    input_specs,
    variant_config,
)
from repro_torch.launch.mesh import (
    abstract_mesh,
    collective_record,
    production_shape,
)
from repro_torch.launch.roofline import roofline_terms, step_bytes
from repro_torch.launch.shapes import decode_attention_flops
from repro_torch.launch.sharding import batch_slice, cache_slice
from repro_torch.models.transformer.model import (
    empty_params,
    init_caches,
    make_decode_step,
    make_prefill_step,
    make_train_step,
    shard_params,
)
from repro_torch.obs.memory import LiveStorage
from repro_torch.serve import _shapes, fill_caches
from repro_torch.train.optimizer import adamw

GIB = 2 ** 30
#: layers past the lead ones of the two counted passes of ``fast``
EXTRAP_SMALL, EXTRAP_MID = 1, 2
TRAIN_LR = 1e-3
BYTES_BASIS = ("least bytes: each input read once, each output written "
               "once (roofline.step_bytes over the rank's slices)")


def _parse_opts(opts: str) -> dict:
    """'opt_mla_absorb=1,opt_remat=none' -> dataclasses.replace kwargs."""
    out = {}
    for kv in filter(None, (opts or "").split(",")):
        k, v = kv.split("=")
        if v in ("0", "1", "true", "false", "True", "False"):
            out[k] = v in ("1", "true", "True")
        elif v.isdigit():
            out[k] = int(v)
        else:
            out[k] = v
    return out


def rank_model(cfg, mesh):
    """A ``meta`` model of ``cfg`` holding the slices of ``mesh``'s rank
    (``shard_params``: the same specs, marks and mesh as ``init_params``
    with the mesh)."""
    return shard_params(empty_params(cfg, "meta"), mesh)


def _bytes(tree) -> int:
    """Bytes of the distinct storages of the tensors in ``tree``."""
    seen = {}
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[id(s)] = s.nbytes()
    return sum(seen.values())


def _counted(fn, args) -> tuple:
    """``fn()`` under ``FlopCounterMode`` and ``LiveStorage(args)``, with
    the mesh's collective counters set to 0 just before: (result, flops,
    collective_record, argument bytes, peak bytes, host seconds)."""
    mesh_mod.reset_collectives()
    t0 = time.perf_counter()
    with LiveStorage(args) as live, FlopCounterMode(display=False) as counter:
        out = fn()
    return (out, counter.get_total_flops(), collective_record(), live.base,
            live.peak, time.perf_counter() - t0)


KINDS = ("train", "prefill", "decode")


def rank_inputs(cfg, kind: str, mesh, batch: dict, *, caches=None,
                pos=None) -> dict:
    """What a step of ``kind`` takes on ``mesh``'s rank, on ``meta``:
    ``model`` (its slices), ``rows`` (its rows of ``batch``, the global
    batch), in train ``opt`` and ``state`` (``adamw``'s, of the slices), in
    decode ``caches`` (its slices of the whole ``caches``) and ``pos``;
    ``args``, the step's inputs as one tree (what ``argument_bytes``
    counts: a train step's counter is a Python int)."""
    if kind not in KINDS:
        raise ValueError(f"a step is one of {KINDS}, not {kind!r}")
    model = rank_model(cfg, mesh)
    out = {"model": model, "rows": batch_slice(cfg, batch, mesh)}
    args = [list(model.parameters()), out["rows"]]
    if kind == "train":
        out["opt"] = adamw(TRAIN_LR)
        out["state"] = out["opt"].init(list(model.parameters()))
        args.append(out["state"].slots)
    elif kind == "decode":
        out["caches"] = cache_slice(cfg, caches, mesh)
        out["pos"] = pos
        args += [out["caches"], pos]
    out["args"] = args
    return out


def rank_pass(cfg, kind: str, mesh, batch: dict, *, caches=None,
              pos=None) -> dict:
    """One step of ``kind`` on ``mesh``'s rank (an ``abstract_mesh`` with
    its ``coords``), shapes only, on ``rank_inputs``: ``batch`` the global
    batch (``tokens``, a VLM's ``patches``) on ``meta``; in decode
    ``caches`` (the whole caches) and ``pos`` (0-d). Returns ``flops``,
    ``collectives``, ``bytes_accessed``, ``argument_bytes``,
    ``output_bytes``, ``peak_bytes``, ``t_trace_s`` and ``rank_batch``."""
    inp = rank_inputs(cfg, kind, mesh, batch, caches=caches, pos=pos)
    model, rows = inp["model"], inp["rows"]
    tokens, patches = rows["tokens"], rows.get("patches")
    B, S = tokens.shape[0], tokens.shape[1] + (
        0 if patches is None else patches.shape[1])
    local = inp.get("caches")
    if kind == "train":
        state = inp["state"]
        step = make_train_step(cfg, inp["opt"], mesh)

        def fn():
            return step(model, state, tokens, patches)
    elif kind == "prefill":
        step = make_prefill_step(cfg, mesh)

        def fn():
            with torch.inference_mode():
                return step(model, tokens, patches)
    else:
        step = make_decode_step(cfg, mesh)

        def fn():
            with torch.inference_mode():
                return step(model, tokens, pos, local)
    out, flops, coll, arg_bytes, peak, secs = _counted(fn, inp["args"])
    if kind == "decode":
        flops += decode_attention_flops(cfg, mesh.model_size,
                                        [_shapes(c) for c in local])
        out_bytes = _bytes(out[0])  # the caches are updated in place
        nbytes = step_bytes(model, kind, B, 1, caches=local)
    elif kind == "prefill":
        out_bytes = _bytes(out)
        nbytes = step_bytes(model, kind, B, S, caches=out[1])
    else:
        out_bytes = _bytes(out)
        nbytes = step_bytes(model, kind, B, S)
    return {"flops": flops, "collectives": coll, "bytes_accessed": nbytes,
            "argument_bytes": arg_bytes, "output_bytes": out_bytes,
            "peak_bytes": peak, "t_trace_s": secs, "rank_batch": B}


@torch.inference_mode()
def serve_pass(cfg, mesh, prompts, new_tokens: int, patches=None) -> dict:
    """``serve.generate`` of ``prompts`` (the whole batch, ``meta``) and
    ``new_tokens`` tokens on ``mesh``'s rank, shapes only: its prefill, the
    copy into the decode-length caches and ``new_tokens - 1`` decode steps,
    each call ``generate`` makes, counted over the whole run as
    ``serve.serve_rank`` counts a rank's. Returns ``flops`` (the counter's
    and the decode kernel's), ``collectives`` and ``peak_bytes``."""
    model = rank_model(cfg, mesh)
    B, S = prompts.shape[:2]
    start = S + (0 if patches is None else patches.shape[1])
    caches = init_caches(cfg, B, start + new_tokens, "meta", mesh)
    batch = {"tokens": prompts}
    if patches is not None:
        batch["patches"] = patches.to(model.embed.dtype)
    rows = batch_slice(cfg, batch, mesh)
    prefill = make_prefill_step(cfg, mesh)
    decode = make_decode_step(cfg, mesh)

    def run():
        logits, pre = prefill(model, rows["tokens"], rows.get("patches"))
        fill_caches(caches, pre, mesh)
        del pre
        tok = logits[:, -1:].argmax(dim=-1)
        pos = torch.tensor(start, dtype=torch.int64, device="meta")
        for _ in range(new_tokens - 1):
            logits, _ = decode(model, tok, pos, caches)
            tok = logits[:, -1:].argmax(dim=-1)
            pos = pos + 1

    _, flops, coll, arg_bytes, peak, secs = _counted(
        run, (list(model.parameters()), rows, caches))
    flops += (new_tokens - 1) * decode_attention_flops(
        cfg, mesh.model_size, [_shapes(c) for c in caches])
    return {"flops": flops, "collectives": coll, "argument_bytes": arg_bytes,
            "peak_bytes": peak, "t_trace_s": secs}


def _shape_pass(cfg, shape_name: str, mesh) -> dict:
    """``rank_pass`` at ``shape_name``'s global inputs (``input_specs`` on
    ``meta``: decode at position ``seq_len - 1``)."""
    spec = input_specs(cfg, shape_name, "meta")
    kind = spec["shape"].kind
    return rank_pass(spec["cfg"], kind, mesh, spec["batch"],
                     caches=spec.get("caches"), pos=spec.get("pos"))


def _extrapolate(small: dict, mid: dict, n_small: int, n_mid: int,
                 n_full: int) -> dict:
    """Every count of ``small`` and ``mid`` (passes at ``n_small`` and
    ``n_mid`` layers past the lead ones) linear in depth at ``n_full``."""
    def line(a, b):
        if isinstance(a, dict):
            return {k: line(a[k], b[k]) for k in a}
        if isinstance(a, (int, float)) and not isinstance(a, bool):
            per = (b - a) / (n_mid - n_small)
            out = a + per * (n_full - n_small)
            return round(out) if isinstance(a, int) else out
        return a

    out = {k: line(small[k], mid[k]) for k in small}
    out["t_trace_s"] = small["t_trace_s"] + mid["t_trace_s"]
    return out


def depth_counts(cfg, count, fast: bool = False) -> tuple[dict, str]:
    """(counts, how): ``count(cfg)`` (a pass's dict of counts) at the lead
    layers plus 1 and plus 2, extrapolated to ``cfg``'s depth
    (``_extrapolate``), or with ``fast``, or where the config is no deeper,
    ``count(cfg)`` itself at full depth."""
    n_lead = cfg.first_dense_layers if cfg.family == "moe" else 0
    n_full = cfg.num_layers - n_lead
    if fast or n_full <= EXTRAP_MID:
        return count(cfg), f"full: {cfg.num_layers} layers"
    small, mid = (count(dataclasses.replace(cfg, num_layers=n_lead + n))
                  for n in (EXTRAP_SMALL, EXTRAP_MID))
    return (_extrapolate(small, mid, EXTRAP_SMALL, EXTRAP_MID, n_full),
            f"extrapolated from {n_lead + EXTRAP_SMALL} and "
            f"{n_lead + EXTRAP_MID} of {cfg.num_layers} layers")


def lower_one(arch: str, shape_name: str, multi_pod: bool = False,
              fast: bool = False, opts: str = "", coords=None) -> dict:
    """The record of one (architecture, input shape, mesh): rank
    ``coords`` (a dict by axis, (0, ..., 0) by default) of the production
    mesh, counted at the lead layers plus 1 and plus 2 and extrapolated in
    depth, or with ``fast`` at full depth (module docstring)."""
    base = get_arch(arch)
    if opts:
        base = dataclasses.replace(base, **_parse_opts(opts))
    mesh = abstract_mesh(production_shape(multi_pod), coords=coords)
    counts, depth = depth_counts(
        base, lambda cfg: _shape_pass(cfg, shape_name, mesh), fast)
    shape = INPUT_SHAPES[shape_name]
    vcfg = variant_config(base, shape)
    chips = 512 if multi_pod else 256
    record = {
        "arch": arch,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "chips": chips,
        "coords": dict(mesh.coords),
        "t_trace_s": counts["t_trace_s"],
        "depth": depth,
        "flops": counts["flops"],
        "bytes_accessed": counts["bytes_accessed"],
        "bytes_basis": BYTES_BASIS,
        "collectives": counts["collectives"],
        "flops_global": counts["flops"] * chips,
        "rank_batch": counts["rank_batch"],
        "memory": {
            "argument_size_gib": counts["argument_bytes"] / GIB,
            "output_size_gib": counts["output_bytes"] / GIB,
            "temp_size_gib": (counts["peak_bytes"]
                              - counts["argument_bytes"]) / GIB,
            "peak_gib": counts["peak_bytes"] / GIB,
        },
        "params": base.param_count(),
        "active_params": base.active_param_count(),
        "variant_window": vcfg.attn_window,
        "opts": opts,
    }
    record["roofline"] = roofline_terms(record)
    return record


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None, choices=list_archs())
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument(
        "--fast", action="store_true",
        help="skip the extrapolation: one pass at full depth (default: the "
             "lead layers plus 1 and plus 2, extrapolated in depth)")
    ap.add_argument(
        "--opts", default="",
        help="comma-separated ArchConfig overrides, e.g. opt_remat=none")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        jobs = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        jobs = [(args.arch, args.shape)]
    elif args.arch:
        jobs = [(args.arch, s) for s in INPUT_SHAPES]
    else:
        ap.error("--arch [--shape] or --all")

    failures, records = [], []
    t_all = time.perf_counter()
    for arch, shape in jobs:
        tag = f"{arch}__{shape}__{'2x16x16' if args.multi_pod else '16x16'}"
        if args.opts:
            tag += "__" + args.opts.replace("=", "").replace(",", "_")
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[skip] {tag} (cached)")
            continue
        print(f"[dryrun] {tag} ...", flush=True)
        try:
            t0 = time.perf_counter()
            record = lower_one(arch, shape, args.multi_pod, fast=args.fast,
                               opts=args.opts)
            r = record["roofline"]
            print(
                f"  flops/dev={record['flops']:.3e} bytes/dev="
                f"{record['bytes_accessed']:.3e} coll/dev="
                f"{record['collectives']['total']:.3e} "
                f"peak/dev={record['memory']['peak_gib']:.2f}GiB "
                f"bottleneck={r['bottleneck']} "
                f"useful={r['useful_flops_ratio']:.2f} "
                f"wall={time.perf_counter() - t0:.1f}s",
                flush=True,
            )
            print(json.dumps({"dryrun_record": record}), flush=True)
            with open(path, "w") as f:
                json.dump(record, f, indent=2)
            records.append(record)
        except Exception as e:  # noqa: BLE001 — record and continue
            failures.append((tag, str(e)))
            traceback.print_exc()
    print(f"\n{len(records)} records in {time.perf_counter() - t_all:.1f}s")
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for tag, err in failures:
            print(f"  {tag}: {err[:200]}")
        raise SystemExit(1)
    print("\nall dry-runs OK")
    return records


if __name__ == "__main__":
    main()
