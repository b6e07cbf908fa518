"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports no JAX, so it runs on a machine with a card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
Tolerances: forward 3e-5, adjoints 3e-4 (the plain versions scatter with
``index_add_``, in another order); the packed segment sum and softmax 3e-5;
the wavefront expansion bitwise. Each kernel must also repeat bit for bit.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core.splitting import pad_axis_fill
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.gather_segsum import kernel, layout, ops, ref
from repro_torch.kernels.segsum import ops as ss_ops
from repro_torch.sampler import kernel as wf_kernel
from repro_torch.sampler import ref as wf_ref

TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
R = layout.AGG_ROWS

CASES = [
    # seed, P, E, M, F, N, keep, grow
    (0, 4, 300, 80, 48, 200, 0.8, False),
    (1, 3, 37, 10, 130, 10, 0.8, False),  # F not a multiple of 32
    (2, 2, 500, 200, 1, 300, 0.5, False),  # one feature column
    (3, 4, 5, 8, 8, 513, 0.8, False),  # many empty dst blocks
    (4, 4, 400, 100, 32, 150, 0.3, True),  # repadded, sentinel-heavy
    (5, 2, 64, 30, 16, 700, 0.05, True),  # nearly empty: empty segments
    (6, 4, 20000, 8192, 128, 4096, 0.35, False),  # papers-s input-layer size
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _pack(seed, P, E, M, F, N, keep, grow, device):
    """Random (pack_src, pack_dst, num_out) from the port's layout; ``grow``
    grows the EB and DB axes with sentinel appends, as a repad does."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N, size=(P, E)).astype(np.int32)
    mask = rng.random((P, E)) < keep
    src = rng.integers(0, M, size=(P, E)).astype(np.int32)
    lay = layout.layer_layout(dst, mask, N)
    pp, pd = lay["pack_perm"], lay["pack_dst"]
    num_out = N
    if grow:
        eb2, db2 = pp.shape[2] * 2, pp.shape[1] + 2
        num_out = db2 * R - 5
        pp = pad_axis_fill(pad_axis_fill(pp, 2, eb2, E), 1, db2, E)
        pd = pad_axis_fill(pad_axis_fill(pd, 2, eb2, R), 1, db2, R)
    pd = torch.as_tensor(pd, device=device)
    pack_src = ops._pack_src(
        torch.as_tensor(src, device=device), torch.as_tensor(pp, device=device),
        pd, M,
    )
    return pack_src, pd, num_out


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,E,M,F,N,keep,grow", CASES)
def test_cuda_kernels_match_plain(cuda, seed, P, E, M, F, N, keep, grow):
    pack_src, pd, num_out = _pack(seed, P, E, M, F, N, keep, grow, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    H = 1 if F % 4 else 4
    mixed = torch.randn(P, M, F, device=cuda, generator=gen)
    w = torch.randn(P, pd.shape[1] * pd.shape[2], H, device=cuda, generator=gen)
    g = torch.randn(P, num_out, F, device=cuda, generator=gen)
    for weights in (None, w):
        out = kernel.gather_segsum_fwd(mixed, pack_src, pd, weights, num_out)
        want = ref.gather_segsum_fwd_packed(mixed, pack_src, pd, weights, num_out)
        torch.testing.assert_close(out, want, **TOL)
        assert torch.equal(
            out, kernel.gather_segsum_fwd(mixed, pack_src, pd, weights, num_out)
        )
        gm = kernel.gather_segsum_bwd_mixed(g, pack_src, pd, weights, M)
        want = ref.gather_segsum_bwd_mixed_packed(g, pack_src, pd, weights, M)
        torch.testing.assert_close(gm, want, **GRAD_TOL)
        assert torch.equal(
            gm, kernel.gather_segsum_bwd_mixed(g, pack_src, pd, weights, M)
        )
    gw = kernel.gather_segsum_bwd_w(mixed, g, pack_src, pd, H)
    want = ref.gather_segsum_bwd_w_packed(mixed, g, pack_src, pd, H)
    torch.testing.assert_close(gw, want, **GRAD_TOL)
    assert torch.equal(gw, kernel.gather_segsum_bwd_w(mixed, g, pack_src, pd, H))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_cuda_trainer_matches_cpu(cuda, model):
    """Three steps of the port on the card (kernels) and on the CPU (plain
    versions) from the same weights agree to rtol 1e-4 per step, and the
    card's run went through the kernels."""
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    ds = make_dataset("tiny")
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=64,
                   out_dim=ds.spec.num_classes, num_layers=2)
    cfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=16,
                      presample_epochs=2, lr=5e-3)
    model0 = GNN(spec, generator=torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        tr = Trainer(ds, spec, cfg, device=dev, model=copy.deepcopy(model0))
        kernel.reset_launches()
        losses[str(dev)] = [s.loss for s in tr.train_epoch(max_iters=3).iters]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert kernel.LAUNCHES["gather_segsum_fwd"] > 0
    assert kernel.LAUNCHES["gather_segsum_bwd_mixed"] > 0
    assert (kernel.LAUNCHES["gather_segsum_bwd_w"] > 0) == (model == "gat")


@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [1, 4, 15, 32, 33, 70])
def test_cuda_wavefront_expand_bitwise(cuda, fanout):
    rng = np.random.default_rng(fanout)
    B = 1000  # not a multiple of 128: the kernel needs no row padding
    vid = torch.as_tensor(rng.integers(0, 2**31 - 1, B).astype(np.int32),
                          device=cuda)
    deg = torch.as_tensor(rng.integers(-3, 3 * fanout + 5, B).astype(np.int32),
                          device=cuda)
    key = torch.as_tensor(rng.integers(0, 2**32, 2), dtype=torch.int64,
                          device=cuda)
    wf_kernel.reset_launches()
    out = wf_kernel.wavefront_expand(vid, deg, key, fanout)
    want = wf_ref.expand_codes(vid, deg, key[0], key[1], fanout)
    assert torch.equal(out, want)
    assert torch.equal(out, wf_kernel.wavefront_expand(vid, deg, key, fanout))
    assert wf_kernel.LAUNCHES["wavefront_expand"] == 2


PACKED_CASES = [
    # seed, E, W, N, keep
    (0, 1000, 64, 300, 0.9),
    (1, 37, 130, 10, 0.9),  # W not a multiple of 32
    (2, 5, 8, 513, 0.9),  # many empty blocks
    (3, 4096, 4, 700, 0.5),  # GAT's 4 heads
    (4, 82000, 128, 16384, 0.8),  # papers-s input-layer size
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("seed,E,W,N,keep", PACKED_CASES)
def test_cuda_packed_kernels_match_plain(cuda, seed, E, W, N, keep, dtype):
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N, size=E).astype(np.int32)
    mask = rng.random(E) < keep
    pack = ss_ops.pack_edges(dst, mask, N)
    R, EB = pack["rows"], pack["edge_block"]
    local = torch.as_tensor(pack["local_dst"], device=cuda)
    x = torch.as_tensor(rng.normal(size=(E, W)) * 3, dtype=dtype, device=cuda)
    packed = ss_ops.gather_packed(x, pack["perm"]).contiguous()
    tol = TOL if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-2)
    out = ss_ops.segment_sum_packed(packed, local, R, EB)
    want = ss_ops.segment_sum_packed_ref(packed, local, R, EB)
    torch.testing.assert_close(out.float(), want.float(), **tol)
    assert torch.equal(out, ss_ops.segment_sum_packed(packed, local, R, EB))
    alpha = es_ops.edge_softmax_packed(packed, local, R, EB)
    want = es_ops.edge_softmax_packed_ref(packed, local, R, EB)
    torch.testing.assert_close(alpha.float(), want.float(), **tol)
    assert torch.equal(alpha, es_ops.edge_softmax_packed(packed, local, R, EB))
    assert not alpha[local[:, 0] == R].any()  # padding slots: exact zeros


def _tiny_device_samplers(cuda):
    from repro_torch.core import partition_graph, presample
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.graph.sampling import NeighborSampler
    from repro_torch.sampler import DeviceSampler

    ds = make_dataset("tiny")
    fan = [4, 3]
    w = presample(ds.graph, ds.train_ids, fan, 32, num_epochs=1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    host = NeighborSampler(ds.graph, ds.train_ids, fan, 32, seed=7)
    return host, [
        DeviceSampler(ds.graph, part.assignment, 4, fan, 7, host, device=dev)
        for dev in (cuda, "cpu")
    ]


@pytest.mark.cuda
def test_cuda_device_sampler_matches_cpu(cuda):
    """The card's device sampler (wavefront kernel) draws bitwise what the
    CPU's (plain version) draws, one wavefront launch per layer."""
    host, (card, cpu) = _tiny_device_samplers(cuda)
    assert card.caps_tuple() == cpu.caps_tuple()
    for i, targets in enumerate(host.epoch_targets(0)[:2]):
        wf_kernel.reset_launches()
        a = card.sample_batch(targets, 0, i)
        assert wf_kernel.LAUNCHES["wavefront_expand"] == len(card.fanouts)
        b = cpu.sample_batch(targets, 0, i)
        for la, lb in zip(a.layers, b.layers):
            for f in ("src", "dst", "edge_id"):
                assert np.array_equal(getattr(la, f), getattr(lb, f))
        for fa, fb in zip(a.frontiers, b.frontiers):
            assert np.array_equal(fa, fb)
    assert card.fallbacks == cpu.fallbacks == 0


@pytest.mark.cuda
def test_cuda_device_source_trainer_matches_cpu(cuda):
    """Three steps of the device plan source on the card and on the CPU from
    the same weights agree to rtol 1e-4 per step."""
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    ds = make_dataset("tiny")
    spec = GNNSpec(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=64,
                   out_dim=ds.spec.num_classes, num_layers=2)
    cfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=16,
                      presample_epochs=2, lr=5e-3, plan_source="device")
    model0 = GNN(spec, generator=torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        tr = Trainer(ds, spec, cfg, device=dev, model=copy.deepcopy(model0))
        wf_kernel.reset_launches()
        st = tr.train_epoch(max_iters=3)
        losses[str(dev)] = [s.loss for s in st.iters]
        assert st.pipeline["sampler_batches"] == 3
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert wf_kernel.LAUNCHES["wavefront_expand"] == 3 * 2


# the decode kernel: SmolLM-135M's serve shape, then the other dense heads
DECODE_CASES = [
    # B, H, KV, D, S
    (8, 9, 3, 64, 1088),
    (8, 32, 32, 96, 4096),  # Phi-3-mini
    (8, 16, 16, 256, 4096),  # Gemma-7B
    (8, 48, 1, 128, 4096),  # Granite-20B, MQA
    (3, 4, 2, 32, 77),  # reduced configs' head dim, S not a multiple of 128
]
#: tests/test_kernels.py's flash-decode tolerance in f32
DECODE_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,S", DECODE_CASES)
def test_cuda_flash_decode_matches_plain(cuda, B, H, KV, D, S, dtype):
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref as fd_ref

    gen = torch.Generator(device=cuda).manual_seed(S + H)
    q = torch.randn(B, H, D, device=cuda, generator=gen).to(dtype)
    k = torch.randn(B, S, KV, D, device=cuda, generator=gen).to(dtype)
    v = torch.randn(B, S, KV, D, device=cuda, generator=gen).to(dtype)
    fd.reset_launches()
    for L in (1, S // 2 + 3, S):
        n = torch.tensor([L], dtype=torch.int32, device=cuda)
        out = fd.flash_decode(q, k, v, n)
        # the f32 result from the same inputs; in bf16 within the rounding
        # of p and of the output besides the f32 tolerance
        want, bound = fd_ref.decode_attention_bound(q, k, v, n.reshape(()),
                                                    **DECODE_TOL)
        diff = (out.float() - want).abs()
        assert bool((diff <= bound).all()), (L, float(diff.max()))
        assert torch.equal(out, fd.flash_decode(q, k, v, n))
    assert fd.LAUNCHES["flash_decode"] == 6


@pytest.mark.cuda
def test_cuda_flash_decode_reads_a_cache_view_and_checks_inputs(cuda):
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref as fd_ref

    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 6, 64, device=cuda, generator=gen)
    big = torch.randn(2, 300, 2, 64, device=cuda, generator=gen)
    k, v = big[:, :200], big[:, 100:]  # views: batch stride 300*2*64
    n = torch.tensor([150], dtype=torch.int32, device=cuda)
    torch.testing.assert_close(fd.flash_decode(q, k, v, n),
                               fd_ref.decode_attention_ref(q, k, v, 150),
                               **DECODE_TOL)
    v = v.contiguous()
    bad = [
        (ValueError, (q.cpu(), k, v, n)),  # wrong device
        (ValueError, (q, k, v, n.cpu())),
        (TypeError, (q.half(), k.half(), v.half(), n)),  # dtype
        (ValueError, (q[..., :60].contiguous(), k[..., :60].contiguous(),
                      v[..., :60].contiguous(), n)),  # D % 8
        (ValueError, (q, k.transpose(1, 2).contiguous().transpose(1, 2), v,
                      n)),  # heads not packed in a row
        (ValueError, (q, torch.randn(2 * 200 * 2 * 64 + 1, device=cuda)[1:]
                      .view(2, 200, 2, 64), v, n)),  # pointer not 16-byte aligned
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            fd.flash_decode(*args)


@pytest.mark.cuda
def test_cuda_reduced_decode_matches_cpu(cuda):
    """A reduced SmolLM's prefill and decode steps on the card (the decode
    kernel) and on the CPU (its plain version), from the same weights:
    logits rtol/atol 1e-4 at every step, equal greedy tokens."""
    from repro_torch import serve
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.models.transformer.model import init_params

    cfg = serve.serve_config("smollm-135m", reduced=True)
    cpu_model = init_params(cfg, torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(cuda)
    prompts = serve.make_prompts(cfg, 3, 20, 1)
    fd.reset_launches()
    card = serve.generate(card_model, torch.as_tensor(prompts, device=cuda), 6)
    assert fd.LAUNCHES["flash_decode"] == cfg.num_layers * 5
    cpu = serve.generate(cpu_model, torch.as_tensor(prompts), 6)
    torch.testing.assert_close(card["step_logits"], cpu["step_logits"],
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(card["tokens"], cpu["tokens"])


@pytest.mark.cuda
def test_cuda_torch_backend_edge_softmax_repeats_bitwise(cuda):
    """The model's edge softmax (torch backend) sums its denominator in a
    fixed order: five calls on the card are bitwise equal, and so are their
    gradients."""
    from repro_torch.kernels import segment_ops

    rng = np.random.default_rng(0)
    E, N = 131072, 16384
    dst = torch.as_tensor(rng.integers(0, N, size=E), device=cuda)
    mask = torch.as_tensor(rng.random(E) < 0.65, device=cuda)
    logits = torch.as_tensor(rng.normal(size=(E, 4)) * 3, dtype=torch.float32,
                             device=cuda).requires_grad_()
    cot = torch.randn(E, 4, device=cuda)
    outs, grads = [], []
    for _ in range(5):
        out = segment_ops.edge_softmax(logits, dst, mask, N)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, logits, cot)[0])
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    assert all(torch.equal(grads[0], g) for g in grads[1:])
    want = segment_ops.edge_softmax(logits.detach().cpu(), dst.cpu(), mask.cpu(), N)
    torch.testing.assert_close(outs[0].cpu(), want, **TOL)
