"""Where the fused gather->segment-aggregate kernels' device time goes, kernel
by kernel, at the shapes ``chip_smoke.py``'s phase 3 holds them at.

    PYTHONPATH=src python -m repro_torch.profile_gather [--iters 20]

Builds the first papers-s batch as the trainer does (P=4, fan-outs 15,15,15,
batch 1024, presample cut to 2 epochs), then times with ``torch.profiler``
the forward at the input layer (F=128), the row adjoint's walk at layer 1
and at the input layer, the row adjoint on a prebuilt walk at layer 1
(F=256, unweighted) and at the input layer (F=256, GAT's four heads), and
the weight adjoint at the input layer, and beside it the packed segment
sum (F=128) and edge softmax (H=4) on the input layer's edges, all P splits
flattened as phase 3 packs them, the device sampler's wavefront expansion at
its largest launch (phase 3's shape), and the shuffle's forward and adjoint
at layer 1 (F=256; the tree's own ``sim_shuffle`` under autograd, so a tree
from before the shuffle kernel times torch's indexing adjoint). Prints one
JSON line per call: each kernel's name, its launches a call and its device
ms a call. Needs a card.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import build_split_plan, partition_graph, presample, repad_plan
from repro_torch.core.shuffle import sim_shuffle
from repro_torch.graph.datasets import make_dataset
from repro_torch.graph.sampling import NeighborSampler
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.gather_segsum import kernel, ops
from repro_torch.kernels.segsum import ops as ss_ops
from repro_torch.sampler import DeviceSampler
from repro_torch.sampler import kernel as wf
from repro_torch.sampler.engine import _sample_device, frontier_degrees

FANOUTS = [15, 15, 15]


def first_plan(seed=0):
    """The first papers-s batch's repadded split plan (``chip_smoke.py``'s
    ``papers_first_batch``), and the wavefront expansion's inputs at its
    largest launch (``chip_smoke.py``'s ``wavefront_phase``)."""
    ds = make_dataset("papers-s")
    w = presample(ds.graph, ds.train_ids, FANOUTS, 1024, num_epochs=2, seed=seed + 1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w, seed=seed)
    sampler = NeighborSampler(ds.graph, ds.train_ids, FANOUTS, 1024, seed=seed)
    targets = sampler.epoch_targets(0)[0]
    plan = build_split_plan(sampler.sample_batch(targets, 0, 0),
                            part.assignment, 4, pad_multiple=-1)
    eng = DeviceSampler(ds.graph, part.assignment, 4, tuple(FANOUTS), 0,
                        host_sampler=sampler, device="cuda")
    t_dev, keys = eng.device_inputs(targets, 0, 0)
    fronts, counts, _, _ = _sample_device(eng._dev, t_dev, len(targets), keys,
                                          caps=eng.caps_tuple(), fanouts=tuple(FANOUTS))
    layer = max(range(len(FANOUTS)), key=lambda l: fronts[l].numel())
    _, _, deg = frontier_degrees(eng._dev, fronts[layer], counts[layer])
    expand = (fronts[layer].reshape(-1), deg.reshape(-1), keys[layer],
              FANOUTS[layer])
    return repad_plan(plan, {}), expand


def layer_pack(lp, P, dev):
    """(pack_src, pack_dst, M, num_out) of one layer on the card."""
    num_out = lp.self_pos.shape[1]
    M = lp.n_local + P * lp.send_idx.shape[2]
    pack_dst = torch.as_tensor(lp.pack_dst, device=dev)
    pack_src = ops._pack_src(torch.as_tensor(lp.edge_src, device=dev),
                             torch.as_tensor(lp.pack_perm, device=dev), pack_dst, M)
    return pack_src, pack_dst, M, num_out


def packed_args(lp, P, dev, gen, width):
    """(rows in packed order, local_dst, R, EB) of the input layer's edges,
    all P splits flattened with dst offset by split (``chip_smoke.py``'s
    ``packed_phase``), ``width`` random columns an edge."""
    E = lp.edge_dst.shape[1]
    num_out = lp.self_pos.shape[1]
    dst = (np.arange(P)[:, None] * num_out + lp.edge_dst).reshape(-1)
    pack = ss_ops.pack_edges(dst.astype(np.int32), lp.edge_mask.reshape(-1),
                             P * num_out)
    x = 3 * torch.randn(P * E, width, device=dev, generator=gen)
    packed = ss_ops.gather_packed(x, pack["perm"]).contiguous()
    return (packed, torch.as_tensor(pack["local_dst"], device=dev),
            pack["rows"], pack["edge_block"])


def per_kernel(fn, iters):
    """{kernel name: [launches a call, device ms a call]} over ``iters``
    calls of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key[:90]: [e.count / iters, e.self_device_time_total / 1e3 / iters]
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_gather: needs a CUDA card")
    dev = torch.device("cuda:0")
    plan, expand = first_plan()
    P = plan.num_devices
    inp = layer_pack(plan.layers[-1], P, dev)
    hid = layer_pack(plan.layers[1], P, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    mixed = torch.randn(P, inp[2], 128, device=dev, generator=gen)
    mixed_w = torch.randn(P, inp[2], 256, device=dev, generator=gen)
    g_hid = torch.randn(P, hid[3], 256, device=dev, generator=gen)
    g_inp = torch.randn(P, inp[3], 256, device=dev, generator=gen)
    w = torch.randn(P, inp[1].shape[1] * inp[1].shape[2], 4, device=dev,
                    generator=gen)
    summed = packed_args(plan.layers[-1], P, dev, gen, 128)
    soft = packed_args(plan.layers[-1], P, dev, gen, 4)
    lp1 = plan.layers[1]
    send_idx = torch.as_tensor(lp1.send_idx, device=dev)
    send_count = torch.as_tensor(lp1.send_count, device=dev)
    h1 = torch.randn(P, lp1.n_local, 256, device=dev, generator=gen,
                     requires_grad=True)
    cot1 = torch.randn(P, hid[2], 256, device=dev, generator=gen)
    cot1[:, lp1.n_local:] *= (  # zero at the padding receive rows, as on the path
        torch.arange(send_idx.shape[2], device=dev)[None, None, :]
        < send_count.T[:, :, None]).reshape(P, -1, 1)

    def shuffle_fwd_bwd():
        try:
            mixed = sim_shuffle(h1, send_idx, send_count=send_count)
        except TypeError:  # a tree from before the shuffle kernel
            mixed = sim_shuffle(h1, send_idx)
        return torch.autograd.grad(mixed, h1, cot1)

    walk_hid = kernel.src_sorted_csr(hid[0], hid[1], hid[2], hid[3])
    walk_inp = kernel.src_sorted_csr(inp[0], inp[1], inp[2], inp[3])
    calls = {
        "fwd, input layer, F=128": lambda: kernel.gather_segsum_fwd(
            mixed, inp[0], inp[1], None, inp[3]),
        "fwd, input layer, F=256, H=4": lambda: kernel.gather_segsum_fwd(
            mixed_w, inp[0], inp[1], w, inp[3]),
        "walk, layer 1": lambda: kernel.src_sorted_csr(*hid),
        "walk, input layer": lambda: kernel.src_sorted_csr(*inp),
        "bwd_mixed, layer 1, F=256": lambda: kernel.gather_segsum_bwd_mixed(
            g_hid, hid[0], hid[1], None, hid[2], walk_hid),
        "bwd_mixed, input layer, F=256, H=4": lambda: kernel.gather_segsum_bwd_mixed(
            g_inp, inp[0], inp[1], w, inp[2], walk_inp),
        "bwd_w, input layer, F=256, H=4": lambda: kernel.gather_segsum_bwd_w(
            mixed_w, g_inp, inp[0], inp[1], 4),
        "segment_sum_packed, input layer, F=128": lambda: ss_ops.segment_sum_packed(
            *summed),
        "edge_softmax_packed, input layer, H=4": lambda: es_ops.edge_softmax_packed(
            *soft),
        "wavefront_expand, largest launch": lambda: wf.wavefront_expand(*expand),
        "shuffle fwd + bwd, layer 1, F=256": shuffle_fwd_bwd,
    }
    for name, fn in calls.items():
        print(json.dumps({"call": name, "kernels": per_kernel(fn, args.iters)}),
              flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
