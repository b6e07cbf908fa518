#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one CUDA card: the split-parallel
training paths and the transformer serve path.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failure exits non-zero; nothing is caught and continued):

1. device  -- requires a CUDA card; prints the nvidia-smi name/power line.
2. build   -- compiles the CUDA sources of ``src/repro_torch/csrc``, one
              ``nvcc`` each, all started together.
3. kernels -- at the shapes the paths give each kernel, holds each kernel
              against its plain torch version and checks it repeats bit for
              bit, and times it (CUDA events, median of 30 launches after
              warm-up) beside the plain version, a library call computing
              the same function where one exists, and the least time the
              card could take (``bound_ms``). The gather_segsum kernels at
              the first papers-s batch's input layer (layer 1 for the
              unweighted row adjoint, which SAGE and GCN never launch at the
              input layer): forward 3e-5, adjoints 3e-4. The wavefront
              expansion at the device sampler's largest launch (P*N rows of
              the largest frontier cap, fan-out 15): bitwise. The packed
              segment sum (F=128) and edge softmax (H=4) on the input layer's
              edges, all P splits flattened with dst offset by split: 3e-5.
              The decode attention at SmolLM-135M's serve shape (B=8, H=9,
              KV=3, D=64, S=1088) and the other dense configs' heads at B=8,
              S=4096, f32 (2e-4/2e-5) and bf16 (the f32 result from the
              same inputs, within the rounding of p and of the output),
              cache_len 1, mid and S; timed in bf16 with a full cache, cold
              in L2.
4. main    -- the trainer's main path at full width: papers-s, SAGE (128 ->
              256 -> 256 -> 16), fan-outs 15,15,15, batch 1024, P=4 splits in
              sim form; one epoch (3 steps). Presampling is cut to 2 epochs.
5. models  -- GCN and GAT (4 heads) take 2 steps each at the same widths.
6. parity  -- tiny graph, 2 layers, hidden 64: 3 steps on the card (kernels)
              and on the CPU (plain versions) from the same weights agree to
              rtol 1e-4, for all three models.
7. device source -- the main path's SAGE run with ``plan_source="device"``:
              sampling on the card (the cooperative sampler and its
              wavefront kernel), one epoch (3 steps). Fails unless a batch was
              sampled on the card without a fallback, and unless the
              wavefront launches equal the layers times the device sampling
              runs. The card's ``sample_batch(targets, 0, 0)`` is held
              bitwise against a ``DeviceSampler`` on the CPU (plain versions)
              with the same shards and caps, and one ``_sample_device`` call
              runs under ``torch.cuda.set_sync_debug_mode("error")``, before
              its single transfer: it fails if that (prototype) detector
              raises on a sync, and reports that none was raised.
8. determinism -- two identical 2-step runs each of SAGE and GAT (serial
              source) and of SAGE on the device source, papers-s; five calls
              of the edge softmax alone on each backend; two identical
              full-width serve runs (tokens and logits). Each must be bitwise
              equal. Also times what the torch backend's fixed-order softmax
              denominator costs against an ``index_add`` one.
9. serve   -- ``repro_torch.serve``'s path at full width: SmolLM-135M, bf16,
              8 requests of 1024-token prompts, 64 new tokens, greedy.
              Prints prefill ms, decode ms per step (median), tokens/s and
              peak device memory; fails unless the logits are finite and the
              decode kernel launched 30 layers x 63 decode steps times.
10. serve parity -- reduced SmolLM (2 layers, f32) from the same weights:
              prefill and 8 decode steps on the card and on the CPU agree to
              rtol/atol 1e-4 at every step, with equal greedy tokens.

Launch counts are set to 0 just before each trainer run and the serve run
and read just after; a kernel of the run's path that was never launched
fails the script. The packed segment kernels run on no trainer path
(``segment_ops``'s packed backend, which the model does not call): their
counts come from one call of ``segment_ops.segment_sum``/``edge_softmax``
with ``backend="packed"``, driven with the counts at 0. The last lines are
the ``kernels`` JSON, the nvidia-smi line and the result line.
"""
import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
BF16_FLOPS = 989e12  # H100 SXM dense bf16 on the tensor cores
# 32-bit integer ops outside the tensor cores: the fp32 rate counts 128 lanes
# an SM at 2 ops (a fused multiply-add); Hopper's SM has 64 INT32 lanes
INT32_OPS = FP32_FLOPS / 4
FWD_TOL = dict(rtol=3e-5, atol=3e-5)
ADJ_TOL = dict(rtol=3e-4, atol=3e-4)
PACKED_TOL = dict(rtol=3e-5, atol=3e-5)
CSRC = "src/repro_torch/csrc/"
#: kernel -> (CUDA source, the TPU kernel it replaces)
KERNELS = {
    "gather_segsum_fwd": ("gather_segsum.cu",
                          "src/repro/kernels/gather_segsum/kernel.py:190"),
    "gather_segsum_bwd_mixed": ("gather_segsum.cu",
                                "src/repro/kernels/gather_segsum/kernel.py:240"),
    "gather_segsum_bwd_w": ("gather_segsum.cu",
                            "src/repro/kernels/gather_segsum/kernel.py:293"),
    "wavefront_expand": ("wavefront_expand.cu", "src/repro/sampler/kernel.py:43"),
    "segment_sum_packed": ("segsum_packed.cu",
                           "src/repro/kernels/segsum/kernel.py:44"),
    "edge_softmax_packed": ("edge_softmax_packed.cu",
                            "src/repro/kernels/edge_softmax/kernel.py:61"),
    "flash_decode": ("flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:61"),
}
LIBRARIES = ("gather_segsum", "wavefront_expand", "segsum_packed",
             "edge_softmax_packed", "flash_decode")
FANOUTS = (15, 15, 15)


def counters():
    """The wrappers' launch-count modules (each has ``LAUNCHES`` and
    ``reset_launches``)."""
    # segment_ops first: it imports the packed ops' modules in an order
    # that resolves their imports of one another
    from repro_torch.kernels import segment_ops  # noqa: F401
    from repro_torch.kernels.edge_softmax import ops as es_ops
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.gather_segsum import kernel as gss
    from repro_torch.kernels.segsum import ops as ss_ops
    from repro_torch.sampler import kernel as wf

    return (gss, wf, ss_ops, es_ops, fd)


def reset_launches():
    for mod in counters():
        mod.reset_launches()


def read_launches():
    out = {}
    for mod in counters():
        out.update(mod.LAUNCHES)
    return out


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(tag, obj):
    print(json.dumps({tag: obj}), flush=True)


def time_ms(fn, iters=30, warmup=5, flush=None):
    """Median device time of ``fn`` over ``iters`` launches (CUDA events).
    ``flush``, a tensor larger than the 50 MB L2, is overwritten before each
    launch, outside the timed interval, so ``fn`` finds its inputs cold."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, iters=20, flush=None):
    """Device time of one ``fn`` call from ``torch.profiler``: the own time
    of every kernel and copy on the card over ``iters`` calls, per call,
    less what the ``flush`` alone takes. Unlike ``time_ms`` it leaves out
    the host's time to launch, which a short kernel can be bound by."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def per_call(body):
        body()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                body()
            torch.cuda.synchronize()
        return sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / iters

    if flush is None:
        return per_call(fn)
    return per_call(lambda: (flush.zero_(), fn())) - per_call(flush.zero_)


def bound(nbytes, ops, rate=FP32_FLOPS):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def papers_first_batch(seed=0):
    """The first batch of papers-s as the trainer builds it (P=4, fan-outs
    15,15,15, batch 1024, presample cut to 2 epochs): the dataset, the
    partition, the host sampler, the batch's targets and its repadded plan."""
    from repro_torch.core import build_split_plan, partition_graph, presample, repad_plan
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.graph.sampling import NeighborSampler

    ds = make_dataset("papers-s")
    fan = list(FANOUTS)
    w = presample(ds.graph, ds.train_ids, fan, 1024, num_epochs=2, seed=seed + 1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w, seed=seed)
    sampler = NeighborSampler(ds.graph, ds.train_ids, fan, 1024, seed=seed)
    targets = sampler.epoch_targets(0)[0]
    plan = build_split_plan(sampler.sample_batch(targets, 0, 0),
                            part.assignment, 4, pad_multiple=-1)
    return SimpleNamespace(ds=ds, part=part, sampler=sampler, targets=targets,
                           plan=repad_plan(plan, {}))


def layer_pack(lp, P, dev):
    """One layer's pack on the card, and what the bounds and the library
    calls need: its valid slots as the (dst, src) entries of one
    block-diagonal (P*num_out x P*M) matrix, and the distinct rows they
    touch."""
    import torch

    from repro_torch.kernels.gather_segsum import ops
    from repro_torch.kernels.gather_segsum.layout import AGG_ROWS as R

    num_out = lp.self_pos.shape[1]
    M = lp.n_local + P * lp.send_idx.shape[2]
    _, DB, EB = lp.pack_dst.shape
    pack_dst = torch.as_tensor(lp.pack_dst, device=dev)
    pack_src = ops._pack_src(torch.as_tensor(lp.edge_src, device=dev),
                             torch.as_tensor(lp.pack_perm, device=dev), pack_dst, M)
    valid = (pack_dst < R).reshape(P, -1)
    n_valid = int(valid.sum())
    split = torch.arange(P, device=dev)[:, None]
    db = (torch.arange(DB * EB, device=dev) // EB)[None]
    flat_src = (split * M + pack_src.reshape(P, -1))[valid]
    flat_dst = (split * num_out + db * R + pack_dst.reshape(P, -1))[valid]
    adj = torch.sparse_coo_tensor(
        torch.stack([flat_dst, flat_src]), torch.ones(n_valid, device=dev),
        (P * num_out, P * M),
    ).coalesce()
    return SimpleNamespace(
        P=P, M=M, num_out=num_out, DB=DB, EB=EB, pack_src=pack_src,
        pack_dst=pack_dst, valid=valid, n_valid=n_valid,
        slot_key=flat_dst * (P * M) + flat_src,
        src_rows=int(torch.unique(flat_src).numel()),
        dst_rows=int(torch.unique(flat_dst).numel()),
        # pack_dst is read in full, pack_src only at the valid slots
        index_bytes=4 * (P * DB * EB + n_valid),
        adj=adj, adj_csr=adj.to_sparse_csr(),
        adj_t_csr=adj.t().coalesce().to_sparse_csr(),
    )


def record(results, name, out, want, fn, plain, library, nbytes, nops,
           tol=None, rate=FP32_FLOPS, shape=None, flush=None, extra=None):
    """Hold a kernel's output against its plain version's (``tol``: the
    rtol/atol of ``assert_close``, an elementwise bound tensor, or None for
    bitwise), check that a second launch repeats it bit for bit,
    time the kernel, its plain version and the library call, and keep the
    row of the ``kernels`` line. A row with a ``shape`` label is emitted and
    not kept: the ``kernels`` line holds each kernel at its main path's
    shape."""
    import torch

    if tol is None:
        check(torch.equal(out, want), f"{name}: differs from its plain version")
        err = 0.0
    else:
        diff = (out.float() - want.float()).abs()
        err = float(diff.max())
        if isinstance(tol, torch.Tensor):
            check(bool((diff <= tol).all()), f"{name}: max error {err} outside the bound")
        else:
            torch.testing.assert_close(out, want, **tol)
    check(torch.equal(out, fn()), f"{name}: two launches differ")
    bound_ms, bound_by = bound(nbytes, nops, rate)
    source, replaces = KERNELS[name]
    row = dict(
        name=name, route="cuda", source=CSRC + source, replaces=replaces,
        launches=0, max_abs_err=err, ms=time_ms(fn, flush=flush),
        plain_ms=time_ms(plain, flush=flush), bound_ms=bound_ms,
        bound_by=bound_by,
        library_ms=time_ms(library, flush=flush) if library is not None else None,
    )
    line = {k: v for k, v in row.items() if k != "launches"}
    if shape is None:
        results[name] = row
    else:
        line["shape"] = shape
    emit("kernel", {**line, **(extra or {})})


def kernel_phase(dev, first, results):
    """Phase 3, the gather_segsum kernels, each against its plain version at
    the shapes the main path gives it. The input layer (F=128 rows, no
    gradient) is SAGE's and GCN's largest forward; its rows get a gradient
    only under GAT (F=256 = 4 heads x 64), so the unweighted row adjoint is
    held and timed at layer 1 (F=256), the largest shape where SAGE and GCN
    launch it."""
    import torch

    from repro_torch.kernels.gather_segsum import kernel, ref

    plan = first.plan
    P = plan.num_devices
    inp = layer_pack(plan.layers[-1], P, dev)
    hid = layer_pack(plan.layers[1], P, dev)
    emit("kernel_shapes", {
        name: dict(P=P, M=lay.M, num_out=lay.num_out, DB=lay.DB, EB=lay.EB,
                   slots=P * lay.DB * lay.EB, valid_slots=lay.n_valid,
                   src_rows=lay.src_rows, dst_rows=lay.dst_rows)
        for name, lay in (("input_layer", inp), ("layer_1", hid))
    })
    gen = torch.Generator(device=dev).manual_seed(0)

    def csr_for(lay, layer):
        csr = kernel.src_sorted_csr(lay.pack_src, lay.pack_dst, lay.M, lay.num_out)
        ms = time_ms(lambda: kernel.src_sorted_csr(
            lay.pack_src, lay.pack_dst, lay.M, lay.num_out))
        emit("src_sorted_csr", {"layer": layer, "ms": ms})
        return csr

    # forward at SAGE's input-layer width (F = 128)
    F = 128
    mixed = torch.randn(P, inp.M, F, device=dev, generator=gen)
    args = (mixed, inp.pack_src, inp.pack_dst, None, inp.num_out)
    fwd = lambda: kernel.gather_segsum_fwd(*args)  # noqa: E731
    plain = lambda: ref.gather_segsum_fwd_packed(*args)  # noqa: E731
    flat_mixed = mixed.reshape(P * inp.M, F)
    library = lambda: torch.sparse.mm(inp.adj_csr, flat_mixed)  # noqa: E731
    out = fwd()
    torch.testing.assert_close(library().reshape(P, inp.num_out, F), out, **FWD_TOL)
    record(results, "gather_segsum_fwd", out, plain(), fwd, plain, library,
           inp.index_bytes + 4 * F * (inp.src_rows + P * inp.num_out),
           inp.n_valid * F, FWD_TOL)

    # GAT's weighted forward at the input layer (F = 256 = 4 x 64): checked
    H, Fw = 4, 256
    mixed_w = torch.randn(P, inp.M, Fw, device=dev, generator=gen)
    w = torch.randn(P, inp.DB * inp.EB, H, device=dev, generator=gen)
    out_w = kernel.gather_segsum_fwd(mixed_w, inp.pack_src, inp.pack_dst, w, inp.num_out)
    want_w = ref.gather_segsum_fwd_packed(mixed_w, inp.pack_src, inp.pack_dst, w,
                                          inp.num_out)
    torch.testing.assert_close(out_w, want_w, **FWD_TOL)
    emit("kernel_check", {"name": "gather_segsum_fwd (weighted, input layer, H=4, F=256)",
                          "max_abs_err": float((out_w - want_w).abs().max())})

    # adjoint w.r.t. the rows, unweighted, at layer 1 (F = 256): SAGE and GCN
    g = torch.randn(P, hid.num_out, Fw, device=dev, generator=gen)
    csr = csr_for(hid, 1)
    args = (g, hid.pack_src, hid.pack_dst, None, hid.M)
    bwd = lambda: kernel.gather_segsum_bwd_mixed(*args, csr)  # noqa: E731
    plain = lambda: ref.gather_segsum_bwd_mixed_packed(*args)  # noqa: E731
    flat_g = g.reshape(P * hid.num_out, Fw)
    library = lambda: torch.sparse.mm(hid.adj_t_csr, flat_g)  # noqa: E731
    out = bwd()
    torch.testing.assert_close(library().reshape(P, hid.M, Fw), out, **ADJ_TOL)
    record(results, "gather_segsum_bwd_mixed", out, plain(), bwd, plain, library,
           hid.index_bytes + 4 * Fw * (hid.dst_rows + P * hid.M),
           hid.n_valid * Fw, ADJ_TOL)

    # GAT's weighted row adjoint at the input layer: checked
    g_w = torch.randn(P, inp.num_out, Fw, device=dev, generator=gen)
    csr_w = csr_for(inp, len(plan.layers) - 1)
    gm_w = kernel.gather_segsum_bwd_mixed(g_w, inp.pack_src, inp.pack_dst, w, inp.M, csr_w)
    want = ref.gather_segsum_bwd_mixed_packed(g_w, inp.pack_src, inp.pack_dst, w, inp.M)
    torch.testing.assert_close(gm_w, want, **ADJ_TOL)
    emit("kernel_check", {"name": "gather_segsum_bwd_mixed (weighted, input layer, H=4, F=256)",
                          "max_abs_err": float((gm_w - want).abs().max())})

    # adjoint w.r.t. GAT's per-slot weights at the input layer; the library
    # call is an SDDMM over the plan's (dst, src) pattern, heads as the batch
    args = (mixed_w, g_w, inp.pack_src, inp.pack_dst, H)
    bw = lambda: kernel.gather_segsum_bwd_w(*args)  # noqa: E731
    plain = lambda: ref.gather_segsum_bwd_w_packed(*args)  # noqa: E731
    rows, cols, nnz = P * inp.num_out, P * inp.M, inp.adj._nnz()
    pattern = torch.sparse_csr_tensor(
        inp.adj_csr.crow_indices().expand(H, -1).contiguous(),
        inp.adj_csr.col_indices().expand(H, -1).contiguous(),
        torch.zeros(H, nnz, device=dev), (H, rows, cols),
    )
    g_heads = g_w.reshape(rows, H, Fw // H).transpose(0, 1).contiguous()
    mixed_heads_t = mixed_w.reshape(cols, H, Fw // H).permute(1, 2, 0).contiguous()
    library = lambda: torch.sparse.sampled_addmm(  # noqa: E731
        pattern, g_heads, mixed_heads_t, beta=0.0)
    keys = inp.adj.indices()[0] * cols + inp.adj.indices()[1]
    at_slot = torch.searchsorted(keys, inp.slot_key)
    out = bw()
    torch.testing.assert_close(library().values()[:, at_slot].T,
                               out.reshape(P, -1, H)[inp.valid], **ADJ_TOL)
    record(results, "gather_segsum_bwd_w", out, plain(), bw, plain, library,
           inp.index_bytes + 4 * Fw * (inp.src_rows + inp.dst_rows)
           + 4 * P * inp.DB * inp.EB * H, 2 * inp.n_valid * Fw, ADJ_TOL)


def wavefront_phase(dev, first, results):
    """Phase 3, the wavefront expansion at the device sampler's largest
    launch of the first papers-s batch: the frontier of the largest cap,
    P*N rows x fan-out 15, bitwise against its plain version. There is no
    library call for it. Bound: the larger of the bytes (vid and deg read,
    the codes written) and the integer work of the valid rows (about 28
    ops a slot for the three hash rounds, the reduction and the selects,
    plus a compare per earlier slot for the dedup) at the INT32 rate."""
    from repro_torch.sampler import DeviceSampler
    from repro_torch.sampler import kernel as wf
    from repro_torch.sampler import ref
    from repro_torch.sampler.engine import _sample_device, frontier_degrees

    eng = DeviceSampler(first.ds.graph, first.part.assignment, 4, FANOUTS, 0,
                        host_sampler=first.sampler, device=dev)
    t_dev, keys = eng.device_inputs(first.targets, 0, 0)
    fronts, counts, _, _ = _sample_device(
        eng._dev, t_dev, len(first.targets), keys, caps=eng.caps_tuple(),
        fanouts=FANOUTS,
    )
    layer = max(range(len(FANOUTS)), key=lambda l: fronts[l].numel())
    _, _, deg = frontier_degrees(eng._dev, fronts[layer], counts[layer])
    vid, deg, key = fronts[layer].reshape(-1), deg.reshape(-1), keys[layer]
    fanout = FANOUTS[layer]
    rows, valid_rows = vid.numel(), int((deg >= 0).sum())
    emit("kernel_shapes", {"wavefront_expand": dict(
        layer=layer, rows=rows, valid_rows=valid_rows, fanout=fanout,
        caps=dict(eng.caps_tuple()))})
    fn = lambda: wf.wavefront_expand(vid, deg, key, fanout)  # noqa: E731
    plain = lambda: ref.expand_codes(vid, deg, key[0], key[1], fanout)  # noqa: E731
    ops = valid_rows * fanout * (28 + (fanout - 1) / 2)
    record(results, "wavefront_expand", fn(), plain(), fn, plain, None,
           8 * rows + 16 + 4 * fanout * rows, ops, rate=INT32_OPS)


def packed_phase(dev, first, results):
    """Phase 3, the packed segment sum (F=128) and edge softmax (H=4) on the
    input layer's edges, all P splits flattened with dst offset by split,
    against their plain versions (3e-5), ``index_add_`` over the valid edges
    and ``torch.sparse.softmax`` over a hybrid COO (num_out, E, H) tensor.
    Bound: bytes (the valid rows or logits and the indices read once, the
    output written once)."""
    import numpy as np
    import torch

    from repro_torch.kernels.edge_softmax import ops as es_ops
    from repro_torch.kernels.segsum import ops as ss_ops

    lp = first.plan.layers[-1]
    P, E = lp.edge_dst.shape
    num_out = lp.self_pos.shape[1]
    N = P * num_out
    dst = (np.arange(P)[:, None] * num_out + lp.edge_dst).reshape(-1)
    mask = lp.edge_mask.reshape(-1)
    pack = ss_ops.pack_edges(dst.astype(np.int32), mask, N)
    R, EB, DB = pack["rows"], pack["edge_block"], pack["num_blocks"]
    total, n_valid = DB * EB, int(mask.sum())
    local = torch.as_tensor(pack["local_dst"], device=dev)
    emit("kernel_shapes", {"packed_input_layer": dict(
        edges=P * E, valid_edges=n_valid, num_out=N, DB=DB, EB=EB,
        slots=total)})
    gen = torch.Generator(device=dev).manual_seed(1)
    dst_v = torch.as_tensor(dst[mask], device=dev).long()
    mask_d = torch.as_tensor(mask, device=dev)

    F = 128
    contrib = torch.randn(P * E, F, device=dev, generator=gen)
    packed = ss_ops.gather_packed(contrib, pack["perm"]).contiguous()
    contrib_v = contrib[mask_d]
    fn = lambda: ss_ops.segment_sum_packed(packed, local, R, EB)  # noqa: E731
    plain = lambda: ss_ops.segment_sum_packed_ref(packed, local, R, EB)  # noqa: E731
    library = lambda: torch.zeros(N, F, device=dev).index_add_(  # noqa: E731
        0, dst_v, contrib_v)
    out = fn()
    torch.testing.assert_close(out[:N], library(), **PACKED_TOL)
    record(results, "segment_sum_packed", out, plain(), fn, plain, library,
           4 * F * n_valid + 4 * total + 4 * F * DB * R, n_valid * F,
           PACKED_TOL)

    H = 4
    logits = 3 * torch.randn(P * E, H, device=dev, generator=gen)
    packed = ss_ops.gather_packed(logits, pack["perm"]).contiguous()
    sp = torch.sparse_coo_tensor(
        torch.stack([dst_v, torch.arange(n_valid, device=dev)]), logits[mask_d],
        (N, n_valid, H),
    ).coalesce()
    fn = lambda: es_ops.edge_softmax_packed(packed, local, R, EB)  # noqa: E731
    plain = lambda: es_ops.edge_softmax_packed_ref(packed, local, R, EB)  # noqa: E731
    library = lambda: torch.sparse.softmax(sp, 1)  # noqa: E731
    out = fn()
    lib = library().coalesce()
    want = torch.zeros(n_valid, H, device=dev)
    want[lib.indices()[1]] = lib.values()
    perm = torch.as_tensor(pack["perm"], device=dev).long()
    by_edge = torch.zeros(P * E + 1, H, device=dev).index_copy_(0, perm, out)
    torch.testing.assert_close(by_edge[:-1][mask_d], want, **PACKED_TOL)
    record(results, "edge_softmax_packed", out, plain(), fn, plain, library,
           4 * H * n_valid + 4 * total + 4 * H * total, 5 * n_valid * H,
           PACKED_TOL)
    return dst, mask, N


def packed_entry_points(dev, dst, mask, N):
    """Path B through the entry points a user calls: ``segment_ops``'s
    ``segment_sum``, ``segment_mean`` and ``edge_softmax`` with
    ``backend="packed"`` on the input layer's edges, counts at 0 just before
    and read just after, each result held against the torch backend."""
    import torch

    from repro_torch.kernels import segment_ops

    gen = torch.Generator(device=dev).manual_seed(2)
    d = torch.as_tensor(dst, device=dev)
    m = torch.as_tensor(mask, device=dev)
    x = torch.randn(len(dst), 128, device=dev, generator=gen)
    logits = torch.randn(len(dst), 4, device=dev, generator=gen)
    reset_launches()
    out = {
        op: getattr(segment_ops, op)(arg, d, m, N, backend="packed")
        for op, arg in (("segment_sum", x), ("segment_mean", x),
                        ("edge_softmax", logits))
    }
    launches = read_launches()
    check(launches["segment_sum_packed"] == 2 and launches["edge_softmax_packed"] == 1,
          f"packed entry points: launches {launches}")
    errs = {}
    for op, arg in (("segment_sum", x), ("segment_mean", x), ("edge_softmax", logits)):
        want = getattr(segment_ops, op)(arg, d, m, N, backend="torch")
        torch.testing.assert_close(out[op], want, **PACKED_TOL)
        errs[op] = float((out[op] - want).abs().max())
    emit("run", {"name": "segment_ops packed backend", "max_abs_err": errs,
                 "launches": launches})
    return launches


#: the decode kernel's shapes: SmolLM-135M's serve shape (B=8, a 1024-token
#: prompt plus 64 new tokens) first, then the other dense configs' heads
DECODE_SHAPES = {
    "smollm-135m": dict(B=8, H=9, KV=3, D=64, S=1088, mid=700),
    "phi3-mini-3.8b": dict(B=8, H=32, KV=32, D=96, S=4096, mid=2051),
    "gemma-7b": dict(B=8, H=16, KV=16, D=256, S=4096, mid=2051),
    "granite-20b": dict(B=8, H=48, KV=1, D=128, S=4096, mid=2051),
}
#: the SDPA yardstick against the decode kernel in bf16: one bf16 rounding
#: of the output (at most 2^-7 of it) plus 2e-3 on outputs of about 0.03-0.05
SDPA_TOL = dict(rtol=1e-2, atol=2e-3)
SERVE_ARCH, SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = "smollm-135m", 8, 1024, 64


def flash_decode_phase(dev, results):
    """Phase 3, the decode-attention kernel at each dense config's head
    shape (B=8; SmolLM at the serve shape S=1088, the others at S=4096), in
    f32 and bf16, with cache_len 1, mid and S: held against its plain
    version computed in f32 from the same inputs, within
    ``ref.decode_attention_bound`` (the f32 tolerance of
    tests/test_kernels.py, 2e-4/2e-5, plus in bf16 the rounding of p and of
    the output), and checked to repeat bit for bit. Timed in
    bf16 with a full cache, cold in L2 (the decode step reads each layer's
    cache after the other layers' have evicted it), beside the plain
    version and ``scaled_dot_product_attention`` with ``enable_gqa`` on
    (B, KV, S, D) tensors transposed beforehand and a cache_len mask (only
    the call is timed; the port never calls it). Bound: the larger of the
    bytes (the valid K/V rows, q and the output once) over 3.35 TB/s and
    the 4*B*H*L*D flops over the bf16 tensor-core rate; ``fma_bound_ms``
    gives the flops over the fp32 CUDA-core rate the kernel runs them at,
    and ``device_ms`` the kernel's own device time by the profiler (without
    the host's time to launch it, which the CUDA events include)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref

    gen = torch.Generator(device=dev).manual_seed(4)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    for arch, sh in DECODE_SHAPES.items():
        B, H, KV, D, S = (sh[k] for k in ("B", "H", "KV", "D", "S"))
        for dtype in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, D, device=dev, generator=gen).to(dtype)
            k = torch.randn(B, S, KV, D, device=dev, generator=gen).to(dtype)
            v = torch.randn(B, S, KV, D, device=dev, generator=gen).to(dtype)
            errs, of_bound = {}, {}
            for L in (1, sh["mid"], S):
                n = torch.tensor([L], dtype=torch.int32, device=dev)
                out = fd.flash_decode(q, k, v, n)
                want, tol = ref.decode_attention_bound(q, k, v, n.reshape(()))
                diff = (out.float() - want).abs()
                check(bool((diff <= tol).all()),
                      f"flash_decode {arch} {dtype} L={L}: max error "
                      f"{float(diff.max())} outside the bound")
                check(torch.equal(out, fd.flash_decode(q, k, v, n)),
                      f"flash_decode {arch} {dtype} L={L}: two launches differ")
                errs[L] = float(diff.max())
                of_bound[L] = float((diff / tol).max())
            emit("kernel_check", {"name": f"flash_decode ({arch}: B={B} H={H} "
                                          f"KV={KV} D={D} S={S}, {dtype})",
                                  "max_abs_err": errs,
                                  "max_err_over_bound": of_bound, "repeats": True})
        # timed in bf16 (the serve dtype) with a full cache
        n = torch.tensor([S], dtype=torch.int32, device=dev)
        fn = lambda: fd.flash_decode(q, k, v, n)  # noqa: E731
        plain = lambda: ref.decode_attention_ref(q, k, v, n.reshape(()))  # noqa: E731
        q4 = q.reshape(B, H, 1, D)
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        mask = (torch.arange(S, device=dev) < n)[None, None, None, :]
        library = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q4, kt, vt, attn_mask=mask, enable_gqa=True)
        out = fn()
        torch.testing.assert_close(library().reshape(B, H, D).float(), out.float(),
                                   **SDPA_TOL)
        want, tol = ref.decode_attention_bound(q, k, v, n.reshape(()))
        nbytes = 2 * (B * S * KV * 2 * D + 2 * B * H * D)
        flops = 4 * B * H * S * D
        record(results, "flash_decode", out, want, fn, plain, library,
               nbytes, flops, tol, rate=BF16_FLOPS,
               shape=None if arch == SERVE_ARCH else f"{arch}: B={B} H={H} "
                                                     f"KV={KV} D={D} S={S}",
               flush=flush,
               extra={"fma_bound_ms": 1e3 * flops / FP32_FLOPS, "arch": arch,
                      "device_ms": device_ms(fn, flush=flush),
                      "library_device_ms": device_ms(library, flush=flush)})


def run_trainer(ds, spec, cfg, dev, steps, name, expect):
    """One trainer run with launch counts set to 0 just before and read just
    after; fails if a kernel the path needs was never launched."""
    import numpy as np
    import torch

    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    tr = Trainer(ds, spec, cfg, device=dev)
    t_setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    st = tr.train_epoch(max_iters=steps)
    launches = read_launches()
    losses = [it.loss for it in st.iters]
    check(len(losses) == steps, f"{name}: {len(losses)} steps, expected {steps}")
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    for k in expect:
        check(launches[k] > 0, f"{name}: kernel {k} was never launched")
    emit("run", {
        "name": name, "plan_source": cfg.plan_source, "setup_s": t_setup,
        "presample_s": tr.t_presample, "partition_s": tr.t_partition,
        "losses": losses,
        "step_ms": [1e3 * (it.t_sample + it.t_split + it.t_load + it.t_compute)
                    for it in st.iters],
        "compute_ms": [1e3 * it.t_compute for it in st.iters],
        "sample_ms": [1e3 * it.t_sample for it in st.iters],
        "split_ms": [1e3 * it.t_split for it in st.iters],
        "load_ms": [1e3 * it.t_load for it in st.iters],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "source_stats": st.pipeline,
    })
    return launches, tr, st


def device_source_phase(papers, cfg, dev):
    """Phase 7: the main path's SAGE run on the device plan source, then the
    card's sample of the first batch against the CPU's, and one sampling
    call under the sync guard."""
    from dataclasses import replace

    import numpy as np
    import torch

    from repro_torch.models.gnn import GNNSpec
    from repro_torch.sampler import DeviceSampler
    from repro_torch.sampler.engine import _sample_device, to_host

    dcfg = replace(cfg, plan_source="device")
    launches, tr, st = run_trainer(
        papers, GNNSpec(model="sage"), dcfg, dev, 3, "sage, device source",
        ("gather_segsum_fwd", "gather_segsum_bwd_mixed", "wavefront_expand"),
    )
    stats = st.pipeline
    check(stats["sampler_batches"] - stats["sampler_fallbacks"] >= 1,
          f"device source: no batch sampled on the card without a fallback {stats}")
    # every device sampling run launches the kernel once per layer, also when
    # it overflows and the batch falls back to the host sampler
    check(launches["wavefront_expand"] == len(FANOUTS) * stats["sampler_batches"],
          f"device source: {launches['wavefront_expand']} wavefront launches "
          f"for {stats['sampler_batches']} sampled batches")

    card = tr.device_sampler
    card.refresh_caps()  # the epoch boundary: any flagged cap has grown
    cpu = DeviceSampler(papers.graph, tr.partition.assignment, dcfg.num_devices,
                        FANOUTS, dcfg.seed, host_sampler=tr.sampler, device="cpu")
    cpu._caps = dict(card._caps)
    targets = tr.sampler.epoch_targets(0)[0]
    a, b = card.sample_batch(targets, 0, 0), cpu.sample_batch(targets, 0, 0)
    check(card.stats()["sampler_epoch_fallbacks"] == 0,
          "device source: the card's check sample fell back to the host")
    for la, lb in zip(a.layers, b.layers, strict=True):
        for f in ("src", "dst", "edge_id"):
            check(np.array_equal(getattr(la, f), getattr(lb, f)),
                  f"device source: card and CPU samples differ in {f}")
    for fa, fb in zip(a.frontiers, b.frontiers, strict=True):
        check(np.array_equal(fa, fb), "device source: frontiers differ")

    # one sampling call under the sync guard, timed part by part on the
    # host clock: upload, enqueueing the loop, the device finishing it, the
    # one transfer back, and assembling the host sample
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t_dev, keys = card.device_inputs(targets, 0, 0)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = _sample_device(card._dev, t_dev, len(targets), keys,
                             caps=card.caps_tuple(), fanouts=FANOUTS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    t2 = time.perf_counter()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    fronts, counts, layers, flags = to_host(out)
    t4 = time.perf_counter()
    card._assemble(targets, fronts, counts, layers)
    t5 = time.perf_counter()
    # what the enqueue is made of: the loop's top-level torch calls (views
    # included), counted by the profiler on a further call
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _sample_device(card._dev, t_dev, len(targets), keys,
                       caps=card.caps_tuple(), fanouts=FANOUTS)
    n_calls = sum(1 for e in prof.events() if e.cpu_parent is None)
    emit("device_source", {
        "sampler": stats,
        "card_vs_cpu_sample": "bitwise equal",
        "sync_debug_mode_error": "no sync raised",
        "sample_breakdown_ms": {
            "upload": 1e3 * (t1 - t0), "enqueue": 1e3 * (t2 - t1),
            "device_after_enqueue": 1e3 * (t3 - t2),
            "transfer": 1e3 * (t4 - t3), "assemble": 1e3 * (t5 - t4),
        },
        "sample_device_torch_calls": n_calls,
        "transfer_bytes": 4 * sum(
            a.size for a in (*fronts, *counts, *(v for lay in layers
                                                  for v in lay.values()))),
        "edges_per_layer": [int(lay["valid"].sum()) for lay in layers],
        "frontier_sizes": [int(c.sum()) for c in counts],
        "overflow": sorted(k for k, f in flags.items() if f),
    })
    return launches


def _softmax_index_add(logits, dst, mask, num_out):
    """The torch backend's edge softmax as it was before its denominator was
    summed in a fixed order: the same body with ``index_add``, which adds
    with float atomics on the card. A yardstick of what the fixed order
    costs; the port never calls it."""
    import torch

    dst = dst.long()
    neg = torch.finfo(logits.dtype).min / 2
    masked = torch.where(mask[:, None], logits, torch.full_like(logits, neg))
    with torch.no_grad():
        seg_max = torch.full((num_out, logits.shape[1]), neg, dtype=logits.dtype,
                             device=logits.device)
        seg_max = seg_max.scatter_reduce(0, dst[:, None].expand_as(masked),
                                         masked, "amax")
    ex = torch.where(mask[:, None], torch.exp(masked - seg_max[dst]),
                     torch.zeros_like(logits))
    denom = torch.zeros_like(seg_max).index_add(0, dst, ex)
    return ex / denom[dst].clamp(min=torch.finfo(logits.dtype).tiny)


def determinism_phase(papers, cfg, dev, dst, mask, N):
    """Phase 8: two identical 2-step runs must be bitwise equal, for SAGE and
    GAT on the serial source and SAGE on the device source; then GAT's edge
    softmax alone, both backends, five calls each on the input layer's edges
    (H=4), must be bitwise equal. What the torch backend's fixed-order
    denominator costs: forward plus backward of the softmax at the input
    layer, timed against the same body with an ``index_add`` denominator."""
    from dataclasses import replace

    import torch

    from repro_torch.kernels import segment_ops
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import Trainer

    for name, model, c in (
        ("sage", "sage", cfg),
        ("gat", "gat", cfg),
        ("sage, device source", "sage", replace(cfg, plan_source="device")),
    ):
        spec = GNNSpec(model=model, num_heads=4)
        # two trainers built alike: seeded partition, sampler and weights
        runs = [Trainer(papers, spec, c, device=dev) for _ in range(2)]
        same_start = all(
            torch.equal(x, y) for x, y in zip(runs[0].params, runs[1].params)
        )
        losses = [[it.loss for it in tr.train_epoch(max_iters=2).iters]
                  for tr in runs]
        same_params = all(
            torch.equal(x, y) for x, y in zip(runs[0].params, runs[1].params)
        )
        equal = losses[0] == losses[1] and same_params
        emit("determinism", {"name": name, "same_start": same_start,
                             "losses_a": losses[0],
                             "losses_b": losses[1],
                             "bitwise_equal": equal})
        check(same_start and equal, f"determinism: two {name} runs differ")

    gen = torch.Generator(device=dev).manual_seed(3)
    d = torch.as_tensor(dst, device=dev)
    m = torch.as_tensor(mask, device=dev)
    logits = 3 * torch.randn(len(dst), 4, device=dev, generator=gen)
    for backend in segment_ops.BACKENDS:
        outs = [segment_ops.edge_softmax(logits, d, m, N, backend=backend)
                for _ in range(5)]
        equal = all(torch.equal(outs[0], o) for o in outs[1:])
        emit("determinism", {
            "name": f"segment_ops.edge_softmax, backend={backend!r}, input layer",
            "bitwise_equal": equal,
            "max_abs_diff": max(float((outs[0] - o).abs().max()) for o in outs[1:]),
        })
        check(equal, f"determinism: edge_softmax backend={backend!r} differs")

    lg = logits.clone().requires_grad_()
    cot = torch.randn(logits.shape, device=dev, generator=gen)
    torch.testing.assert_close(segment_ops.edge_softmax(lg, d, m, N),
                               _softmax_index_add(lg, d, m, N), **PACKED_TOL)

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(lg, d, m, N), lg, cot)

    emit("edge_softmax_cost", {
        "edges": len(dst), "heads": 4, "num_out": N,
        "fixed_order_fwd_bwd_ms": time_ms(fwd_bwd(segment_ops.edge_softmax)),
        "index_add_fwd_bwd_ms": time_ms(fwd_bwd(_softmax_index_add)),
    })


def serve_model(dev, seed=0):
    """SmolLM-135M at full width (bf16) with seeded random weights on the
    card, and the serve path's prompts: 8 requests of 1024 tokens."""
    import torch

    from repro_torch import serve
    from repro_torch.models.transformer.model import init_params

    cfg = serve.serve_config(SERVE_ARCH, reduced=False)
    model = init_params(cfg, torch.Generator(dev).manual_seed(seed))
    prompts = serve.make_prompts(cfg, SERVE_BATCH, SERVE_PROMPT, seed)
    return model, torch.as_tensor(prompts, device=dev)


def serve_determinism(model, prompts):
    """Phase 8: two identical full-width serve runs must give bitwise equal
    tokens and logits."""
    import torch

    from repro_torch import serve

    a, b = (serve.generate(model, prompts, SERVE_NEW) for _ in range(2))
    equal = (torch.equal(a["tokens"], b["tokens"])
             and torch.equal(a["step_logits"], b["step_logits"]))
    emit("determinism", {"name": f"serve {SERVE_ARCH}, full width",
                         "bitwise_equal": equal})
    check(equal, "determinism: two serve runs differ")


def serve_phase(model, prompts):
    """Phase 9: the serve path at full width, counts at 0 just before and
    read just after. Fails unless the logits are finite and the decode
    kernel launched once per layer and decode step."""
    import statistics

    import torch

    from repro_torch import serve

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    out = serve.generate(model, prompts, SERVE_NEW)
    launches = read_launches()
    cfg, steps = model.cfg, SERVE_NEW - 1
    check(tuple(out["tokens"].shape) == (SERVE_BATCH, SERVE_NEW),
          f"serve: tokens {tuple(out['tokens'].shape)}")
    check(bool(torch.isfinite(out["step_logits"]).all()), "serve: non-finite logits")
    check(launches["flash_decode"] == cfg.num_layers * steps,
          f"serve: {launches['flash_decode']} decode-kernel launches, expected "
          f"{cfg.num_layers} layers x {steps} steps")
    emit("serve", {
        "arch": cfg.name, "dtype": cfg.dtype, "batch": SERVE_BATCH,
        "prompt_len": SERVE_PROMPT, "new_tokens": SERVE_NEW,
        "prefill_ms": out["prefill_ms"],
        "decode_ms_per_step": statistics.median(out["step_ms"]),
        "step_ms": out["step_ms"],
        "decode_ms": out["decode_ms"],
        "tokens_per_s": SERVE_BATCH * steps / (out["decode_ms"] / 1e3),
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
        "tokens_0": out["tokens"][0, :16].tolist(),
    })
    serve_decode_profile(model, prompts)
    return launches


def _host_yardstick_ms() -> float:
    """The time of a fixed pure-Python loop on this thread: the host CPU's
    own speed, which no torch call or allocation changes."""
    t0 = time.perf_counter()
    sum(i * i for i in range(20000))
    return 1e3 * (time.perf_counter() - t0)


def serve_decode_profile(model, prompts, window=3):
    """Where a decode step's time goes, and whether it changes within a
    run. One step runs under ``torch.cuda.set_sync_debug_mode("error")``
    (fails if that prototype detector raises on a host sync). Then the
    serve loop's ``SERVE_NEW - 1`` decode steps run against a zero cache of
    the serve length; each records its host time (the decode call and the
    argmax, no sync) and, right after, ``_host_yardstick_ms``.
    ``torch.profiler`` traces the first and the last ``window`` steps: the
    device time per step by kernel, the decode kernel's share, the device
    idle share of the traced wall time, the top-level torch calls per step
    and their mean host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer.model import init_caches, make_decode_step

    cfg = model.cfg
    B = prompts.shape[0]
    steps = SERVE_NEW - 1
    caches = init_caches(cfg, B, SERVE_PROMPT + SERVE_NEW, prompts.device)
    decode = make_decode_step(cfg)
    tok = prompts[:, -1:]
    pos = torch.tensor(SERVE_PROMPT, device=prompts.device)
    host_ms, yard_ms, traced = [], [], {}
    with torch.inference_mode():
        decode(model, tok, pos, caches)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode(model, tok, pos, caches)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        for name, lo, hi in (("first", 0, window), ("middle", window, steps - window),
                             ("last", steps - window, steps)):
            tracer = (contextlib.nullcontext() if name == "middle" else
                      profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
            with tracer as prof:
                t0 = time.perf_counter()
                for t in range(lo, hi):
                    t1 = time.perf_counter()
                    logits, _ = decode(model, tok, pos + t, caches)
                    logits[:, -1].argmax(dim=-1)
                    host_ms.append(1e3 * (time.perf_counter() - t1))
                    yard_ms.append(_host_yardstick_ms())
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
            if prof is not None:
                traced[name] = _decode_trace(prof, wall, hi - lo)
    half = steps // 2
    emit("serve_profile", {
        "steps": steps, "traced_steps": window,
        "sync_debug_mode_error": "no sync raised",
        **{f"{name}_{key}": val for name, d in traced.items() for key, val in d.items()},
        "host_ms_per_step": host_ms,
        "yardstick_ms_per_step": yard_ms,
        "host_ms_median_first_half": statistics.median(host_ms[window:half]),
        "host_ms_median_second_half": statistics.median(host_ms[half:steps - window]),
        "yardstick_ms_median_first_half": statistics.median(yard_ms[window:half]),
        "yardstick_ms_median_second_half": statistics.median(yard_ms[half:steps - window]),
    })


def _decode_trace(prof, wall, steps):
    """A profiler trace of ``steps`` decode steps in ``wall`` seconds,
    reduced to per-step numbers."""
    import torch

    events = prof.key_averages()
    on_card = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_card)
    by_kernel = sorted(on_card, key=lambda e: -e.self_device_time_total)
    top = [e for e in prof.events() if e.cpu_parent is None
           and e.device_type == torch.autograd.DeviceType.CPU]
    return {
        "wall_ms_per_step": 1e3 * wall / steps,
        "device_ms_per_step": dev_us / 1e3 / steps,
        "device_idle_share": 1.0 - dev_us / 1e6 / wall,
        "flash_decode_device_ms_per_step": sum(
            e.self_device_time_total for e in on_card
            if "flash_decode" in e.key) / 1e3 / steps,
        "torch_calls_per_step": len(top) / steps,
        "host_us_per_torch_call": sum(e.cpu_time_total for e in top) / max(len(top), 1),
        "top_device_ms_per_step": [
            [e.key[:80], e.self_device_time_total / 1e3 / steps]
            for e in by_kernel[:8]],
    }


def serve_parity_phase(dev):
    """Phase 10: reduced SmolLM (2 layers, f32) from the same weights,
    prefill and 8 decode steps on the card (the kernel) and on the CPU (its
    plain version): every step's logits agree to rtol/atol 1e-4 and the
    greedy tokens are equal."""
    import numpy as np
    import torch

    from repro_torch import serve
    from repro_torch.models.transformer.model import init_params

    cfg = serve.serve_config(SERVE_ARCH, reduced=True)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(dev)
    prompts = serve.make_prompts(cfg, 4, 32, 0)
    reset_launches()
    card = serve.generate(card_model, torch.as_tensor(prompts, device=dev), 9)
    launches = read_launches()
    cpu = serve.generate(cpu_model, torch.as_tensor(prompts), 9)
    check(launches["flash_decode"] == cfg.num_layers * 8,
          f"serve parity: {launches['flash_decode']} decode-kernel launches")
    np.testing.assert_allclose(card["step_logits"].numpy(),
                               cpu["step_logits"].numpy(), rtol=1e-4, atol=1e-4)
    check(torch.equal(card["tokens"], cpu["tokens"]),
          "serve parity: greedy tokens differ between card and CPU")
    emit("card_vs_cpu", {
        "model": f"serve {cfg.name} reduced", "steps": 8,
        "max_abs_logit_diff": float(
            (card["step_logits"] - cpu["step_logits"]).abs().max()),
        "tokens_equal": True,
    })


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.graph.datasets import make_dataset
    from repro_torch.kernels import build
    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    # ---- 1. device ------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)

    # ---- 2. build: one nvcc per source, all together ----------------------
    t0 = time.perf_counter()
    build.load_libraries(LIBRARIES)
    emit("build", {
        "wall_s": time.perf_counter() - t0,
        "seconds": {n: build.build_seconds[n] for n in LIBRARIES},
        "ptxas": {n: [line.strip() for line in build.build_log.get(n, "").splitlines()
                      if "Compiling entry function" in line or "Used" in line]
                  for n in LIBRARIES},
    })

    # ---- 3. kernels -----------------------------------------------------
    first = papers_first_batch()
    results = {}
    kernel_phase(dev, first, results)
    wavefront_phase(dev, first, results)
    dst, mask, N = packed_phase(dev, first, results)
    flash_decode_phase(dev, results)
    total = {k: 0 for k in KERNELS}
    for k, v in packed_entry_points(dev, dst, mask, N).items():
        total[k] += v

    # ---- 4. main path at full width ------------------------------------
    papers = first.ds
    cfg = TrainConfig(num_devices=4, fanouts=FANOUTS, batch_size=1024,
                      presample_epochs=2)
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed")
    launches, _, _ = run_trainer(papers, GNNSpec(model="sage"), cfg, dev, 3,
                                 "sage", both)
    for k in total:
        total[k] += launches[k]

    # ---- 5. the other models -------------------------------------------
    for model, expect in (("gcn", both), ("gat", both + ("gather_segsum_bwd_w",))):
        launches, _, _ = run_trainer(papers, GNNSpec(model=model, num_heads=4), cfg,
                                     dev, 2, model, expect)
        for k in total:
            total[k] += launches[k]

    # ---- 6. card vs CPU on a small graph --------------------------------
    tiny = make_dataset("tiny")
    tcfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=16,
                       presample_epochs=2, lr=5e-3)
    for model in ("sage", "gcn", "gat"):
        spec = GNNSpec(model=model, in_dim=tiny.spec.feat_dim, hidden_dim=64,
                       out_dim=tiny.spec.num_classes, num_layers=2)
        model0 = GNN(spec, generator=torch.Generator().manual_seed(0))
        losses = {}
        for where in ("cpu", dev):
            tr = Trainer(tiny, spec, tcfg, device=where, model=copy.deepcopy(model0))
            losses[str(where)] = [it.loss for it in tr.train_epoch(max_iters=3).iters]
        np.testing.assert_allclose(losses[str(dev)], losses["cpu"], rtol=1e-4)
        emit("card_vs_cpu", {"model": model, "cuda": losses[str(dev)],
                             "cpu": losses["cpu"]})

    # ---- 7. the device plan source --------------------------------------
    for k, v in device_source_phase(papers, cfg, dev).items():
        total[k] += v

    # ---- 8. run-to-run determinism --------------------------------------
    determinism_phase(papers, cfg, dev, dst, mask, N)
    model, prompts = serve_model(dev)
    serve_determinism(model, prompts)

    # ---- 9. the serve path at full width --------------------------------
    for k, v in serve_phase(model, prompts).items():
        total[k] += v
    del model, prompts

    # ---- 10. serve, card vs CPU on a reduced model ----------------------
    serve_parity_phase(dev)

    for k, r in results.items():
        r["launches"] = total[k]
    check(sorted(results) == sorted(KERNELS), f"kernels held: {sorted(results)}")
    print(json.dumps({"kernels": [results[k] for k in KERNELS]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
