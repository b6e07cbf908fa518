#!/usr/bin/env python3
"""Drive the PyTorch port's split-parallel training path on one CUDA card.

    python3 chip_smoke.py        # from the repo root, on a machine with a card

Phases (any failure exits non-zero; nothing is caught and continued):

1. device  -- requires a CUDA card; prints the nvidia-smi name/power line.
2. build   -- compiles the CUDA kernels from ``src/repro_torch/csrc``.
3. kernels -- at the layer shapes of a real papers-s plan that the main path
              gives each kernel (the input layer; layer 1 for the
              unweighted row adjoint, which SAGE and GCN never launch at
              the input layer), holds each kernel against its plain torch
              version (forward 3e-5, adjoints 3e-4),
              checks it repeats bit for bit, and times it (CUDA events,
              median of 30 launches after warm-up) beside the plain version,
              a library call computing the same function where one exists,
              and the least time the card could take (``bound_ms``).
4. main    -- the trainer's main path at full width: papers-s, SAGE (128 ->
              256 -> 256 -> 16), fan-outs 15,15,15, batch 1024, P=4 splits in
              sim form; one epoch (3 steps). Presampling is cut to 2 epochs.
5. models  -- GCN and GAT (4 heads) take 2 steps each at the same widths.
6. parity  -- tiny graph, 2 layers, hidden 64: 3 steps on the card (kernels)
              and on the CPU (plain versions) from the same weights agree to
              rtol 1e-4, for all three models.
7. determinism -- two identical 2-step SAGE runs on papers-s, reported as
              bitwise equal or not (informational: the shuffle's backward is a
              library scatter with atomics; the kernels' own repeatability is
              enforced in phase 3).

Launch counts are set to 0 just before each trainer run and read just after;
a kernel of the run's path that was never launched fails the script. The
last lines are the ``kernels`` JSON, the nvidia-smi line and the result line.
"""
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
FWD_TOL = dict(rtol=3e-5, atol=3e-5)
ADJ_TOL = dict(rtol=3e-4, atol=3e-4)
SOURCE = "src/repro_torch/csrc/gather_segsum.cu"
REPLACES = {
    "gather_segsum_fwd": "src/repro/kernels/gather_segsum/kernel.py:190",
    "gather_segsum_bwd_mixed": "src/repro/kernels/gather_segsum/kernel.py:240",
    "gather_segsum_bwd_w": "src/repro/kernels/gather_segsum/kernel.py:293",
}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(tag, obj):
    print(json.dumps({tag: obj}), flush=True)


def time_ms(fn, iters=30, warmup=5):
    """Median device time of ``fn`` over ``iters`` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes, ops):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def papers_plan(seed=0):
    """The first batch of a papers-s plan as the trainer builds it (P=4,
    fan-outs 15,15,15, batch 1024, presample cut to 2 epochs)."""
    from repro_torch.core import build_split_plan, partition_graph, presample, repad_plan
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.graph.sampling import NeighborSampler

    ds = make_dataset("papers-s")
    fan = [15, 15, 15]
    w = presample(ds.graph, ds.train_ids, fan, 1024, num_epochs=2, seed=seed + 1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w, seed=seed)
    sampler = NeighborSampler(ds.graph, ds.train_ids, fan, 1024, seed=seed)
    targets = sampler.epoch_targets(0)[0]
    plan = build_split_plan(sampler.sample_batch(targets, 0, 0),
                            part.assignment, 4, pad_multiple=-1)
    return repad_plan(plan, {})


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


def kernel_phase(dev):
    """Phase 3: each kernel against its plain version at the shapes the main
    path gives it. The input layer (F=128 rows, no gradient) is SAGE's and
    GCN's largest forward; its rows get a gradient only under GAT (F=256 =
    4 heads x 64), so the unweighted row adjoint is held and timed at layer 1
    (F=256), the largest shape where SAGE and GCN launch it."""
    import torch

    from repro_torch.kernels.gather_segsum import kernel, ref

    plan = papers_plan()
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
    results = {}

    def record(name, lay, out, want, tol, fn, plain, library, row_bytes, nops):
        err = float((out - want).abs().max())
        torch.testing.assert_close(out, want, **tol)
        check(torch.equal(out, fn()), f"{name}: two launches differ")
        bound_ms, bound_by = bound(lay.index_bytes + row_bytes, nops)
        results[name] = dict(
            name=name, route="cuda", source=SOURCE, replaces=REPLACES[name],
            launches=0, max_abs_err=err, ms=time_ms(fn), plain_ms=time_ms(plain),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=time_ms(library) if library is not None else None,
        )
        emit("kernel", {k: v for k, v in results[name].items() if k != "launches"})

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
    record("gather_segsum_fwd", inp, out, plain(), FWD_TOL, fwd, plain, library,
           4 * F * (inp.src_rows + P * inp.num_out), inp.n_valid * F)

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
    record("gather_segsum_bwd_mixed", hid, out, plain(), ADJ_TOL, bwd, plain, library,
           4 * Fw * (hid.dst_rows + P * hid.M), hid.n_valid * Fw)

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
    record("gather_segsum_bwd_w", inp, out, plain(), ADJ_TOL, bw, plain, library,
           4 * Fw * (inp.src_rows + inp.dst_rows) + 4 * P * inp.DB * inp.EB * H,
           2 * inp.n_valid * Fw)
    return results


def run_trainer(ds, spec, cfg, dev, steps, name, expect):
    """One trainer run with launch counts set to 0 just before and read just
    after; fails if a kernel the path needs was never launched."""
    import numpy as np
    import torch

    from repro_torch.kernels.gather_segsum import kernel
    from repro_torch.train.trainer import Trainer

    t0 = time.perf_counter()
    tr = Trainer(ds, spec, cfg, device=dev)
    t_setup = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.reset_launches()
    st = tr.train_epoch(max_iters=steps)
    launches = dict(kernel.LAUNCHES)
    losses = [it.loss for it in st.iters]
    check(len(losses) == steps, f"{name}: {len(losses)} steps, expected {steps}")
    check(all(np.isfinite(losses)), f"{name}: non-finite loss {losses}")
    for k in expect:
        check(launches[k] > 0, f"{name}: kernel {k} was never launched")
    emit("run", {
        "name": name, "setup_s": t_setup, "presample_s": tr.t_presample,
        "partition_s": tr.t_partition, "losses": losses,
        "step_ms": [1e3 * (it.t_sample + it.t_split + it.t_load + it.t_compute)
                    for it in st.iters],
        "compute_ms": [1e3 * it.t_compute for it in st.iters],
        "sample_ms": [1e3 * it.t_sample for it in st.iters],
        "split_ms": [1e3 * it.t_split for it in st.iters],
        "load_ms": [1e3 * it.t_load for it in st.iters],
        "max_memory_allocated": torch.cuda.max_memory_allocated(),
        "launches": launches,
    })
    return launches, tr


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

    # ---- 2. build -------------------------------------------------------
    build.load_library("gather_segsum")
    ptxas = [line.strip() for line in build.build_log.get("gather_segsum", "").splitlines()
             if "Compiling entry function" in line or "Used" in line]
    emit("build", {"seconds": build.build_seconds["gather_segsum"], "ptxas": ptxas})

    # ---- 3. kernels -----------------------------------------------------
    results = kernel_phase(dev)

    # ---- 4. main path at full width ------------------------------------
    papers = make_dataset("papers-s")
    cfg = TrainConfig(num_devices=4, fanouts=(15, 15, 15), batch_size=1024,
                      presample_epochs=2)
    both = ("gather_segsum_fwd", "gather_segsum_bwd_mixed")
    total = {k: 0 for k in results}
    launches, _ = run_trainer(papers, GNNSpec(model="sage"), cfg, dev, 3,
                              "sage", both)
    for k in total:
        total[k] += launches[k]

    # ---- 5. the other models -------------------------------------------
    for model, expect in (("gcn", both), ("gat", both + ("gather_segsum_bwd_w",))):
        launches, _ = run_trainer(papers, GNNSpec(model=model, num_heads=4), cfg,
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

    # ---- 7. run-to-run determinism (reported) ---------------------------
    tr_a = Trainer(papers, GNNSpec(model="sage"), cfg, device=dev)
    tr_b = copy.deepcopy(tr_a)
    la = [it.loss for it in tr_a.train_epoch(max_iters=2).iters]
    lb = [it.loss for it in tr_b.train_epoch(max_iters=2).iters]
    same_params = all(
        torch.equal(a, b) for a, b in zip(tr_a.params, tr_b.params)
    )
    emit("determinism", {"losses_a": la, "losses_b": lb,
                         "bitwise_equal": la == lb and same_params})

    for k, r in results.items():
        r["launches"] = total[k]
    print(json.dumps({"kernels": list(results.values())}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
