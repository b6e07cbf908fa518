"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA card and skips without one (the kernels have no
CPU mode). The file imports no JAX, so it runs on a machine with a card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
The gather_segsum forward and row adjoint (and the row adjoint's walk) are
held bitwise against their plain versions on a CPU copy, where
``index_add_`` adds in index order, the order the kernels sum in; so is the
weight adjoint, which sums each head in the tree order its plain version
states. The packed segment sum bitwise on a CPU copy, the packed softmax
3e-5, the wavefront expansion bitwise, the shuffle adjoint bitwise on a CPU
copy. Each kernel must also repeat bit for bit. The overlap schedule's edge
halves (the local rows, the recv region, a GAT head chunk) take the same
kernels, held the same way; a zero-width half launches nothing; the served
feature block equals the host gather. So do the replicated input layer
(``[local][recv][replicated]`` mixed rows) and the dp layout (S = 0, where
the self rows' adjoint is a step's only shuffle adjoint); dp, pushpull and
replicated trainers agree with the CPU, and so does an R = 2 mesh, whose
pipelined sources train bit for bit as its inline ones. The spmd path runs
in one NCCL rank spawned by ``launch`` at world size 1: its all-to-all is
the sim form's bit for bit, and its trainer trains bit for bit as the sim
one at one split.
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.core.splitting import pad_axis_fill
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.gather_segsum import kernel, layout, ops, ref
from repro_torch.kernels.segsum import ops as ss_ops
from repro_torch.kernels.shuffle import kernel as sh_kernel
from repro_torch.kernels.shuffle import send_gather
from repro_torch.kernels.shuffle import ref as sh_ref
from repro_torch.sampler import kernel as wf_kernel
from repro_torch.sampler import ref as wf_ref

TOL = dict(rtol=3e-5, atol=3e-5)
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
    # three source rows a split: hubs of about 5000 slots each, over all 32
    # pack blocks of every split
    (7, 4, 30000, 3, 16, 4096, 0.5, False),
    (8, 2, 4000, 500, 64, 1, 0.95, False),  # one dst row fills an EB of 4096
    (9, 3, 600, 50, 13, 300, 0.7, True),  # F = 13, repadded
    (10, 2, 50, 20, 130, 100, 0.0, False),  # no valid slot
    (11, 2, 3000, 30, 8, 500, 0.9, False),  # source runs of about 90 slots
    (12, 2, 2000, 300, 512, 600, 0.8, False),  # two column chunks; 2 heads
]


def _heads(F):
    """GAT's heads for a case: 4 (one for an F that 4 does not divide), and
    2 above 256 columns, whose 256-column heads take the weight adjoint's
    wide path."""
    return 1 if F % 4 else 2 if F > 256 else 4


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


def _on_cpu(fn, *args):
    """A plain version on CPU copies of ``args``."""
    return fn(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))


def _unaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    v = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return v.view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,E,M,F,N,keep,grow", CASES)
def test_cuda_kernels_match_plain(cuda, seed, P, E, M, F, N, keep, grow):
    """The forward, the row adjoint (weighted and not) and the weight
    adjoint equal their plain versions on a CPU copy bit for bit (also on
    rows that start off a 16-byte boundary), and so do the row adjoint's
    walk arrays; every kernel repeats bit for bit."""
    pack_src, pd, num_out = _pack(seed, P, E, M, F, N, keep, grow, cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    H = _heads(F)
    mixed = torch.randn(P, M, F, device=cuda, generator=gen)
    w = torch.randn(P, pd.shape[1] * pd.shape[2], H, device=cuda, generator=gen)
    g = torch.randn(P, num_out, F, device=cuda, generator=gen)
    csr = kernel.src_sorted_csr(pack_src, pd, M, num_out)
    want = _on_cpu(ref.src_sorted_csr_ref, pack_src, pd, M, num_out)
    for got, exp, again in zip(csr, want,
                               kernel.src_sorted_csr(pack_src, pd, M, num_out)):
        assert torch.equal(got.cpu(), exp)
        assert torch.equal(got, again)
    for weights in (None, w):
        out = kernel.gather_segsum_fwd(mixed, pack_src, pd, weights, num_out)
        want = _on_cpu(ref.gather_segsum_fwd_packed, mixed, pack_src, pd,
                       weights, num_out)
        assert torch.equal(out.cpu(), want)
        assert torch.equal(
            out, kernel.gather_segsum_fwd(mixed, pack_src, pd, weights, num_out)
        )
        assert torch.equal(out, kernel.gather_segsum_fwd(
            _unaligned(mixed), pack_src, pd, weights, num_out))
        gm = kernel.gather_segsum_bwd_mixed(g, pack_src, pd, weights, M)
        want = _on_cpu(ref.gather_segsum_bwd_mixed_packed, g, pack_src, pd,
                       weights, M)
        assert torch.equal(gm.cpu(), want)
        assert torch.equal(
            gm, kernel.gather_segsum_bwd_mixed(g, pack_src, pd, weights, M, csr)
        )
        assert torch.equal(gm, kernel.gather_segsum_bwd_mixed(
            _unaligned(g), pack_src, pd, weights, M))
    gw = kernel.gather_segsum_bwd_w(mixed, g, pack_src, pd, H)
    want = _on_cpu(ref.gather_segsum_bwd_w_packed, mixed, g, pack_src, pd, H)
    assert torch.equal(gw.cpu(), want)
    assert torch.equal(gw, kernel.gather_segsum_bwd_w(mixed, g, pack_src, pd, H))
    assert torch.equal(gw, kernel.gather_segsum_bwd_w(
        _unaligned(mixed), _unaligned(g), pack_src, pd, H))


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
        sh_kernel.reset_launches()
        losses[str(dev)] = [s.loss for s in tr.train_epoch(max_iters=3).iters]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    # a step's shuffle_bwd launches: the shuffle's (one: the input layer's
    # rows take no gradient) and the self rows' (SAGE: one; GAT: both
    # layers, whose weighted rows take a gradient)
    assert sh_kernel.LAUNCHES["shuffle_bwd"] == 3 * {"sage": 2, "gcn": 1, "gat": 3}[model]
    assert kernel.LAUNCHES["gather_segsum_fwd"] > 0
    assert kernel.LAUNCHES["gather_segsum_bwd_mixed"] > 0
    assert (kernel.LAUNCHES["gather_segsum_bwd_w"] > 0) == (model == "gat")


@pytest.mark.cuda
@pytest.mark.parametrize("fanout", [1, 4, 15, 16, 17, 31, 32, 33, 64, 70])
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


@pytest.mark.cuda
@pytest.mark.parametrize("B", [1, 37, 4133, "wrap"])
@pytest.mark.parametrize("fanout", [1, 4, 15, 16, 17, 31, 32, 33, 64])
def test_cuda_wavefront_expand_degree_edges(cuda, fanout, B):
    """Degrees at every branch of the expansion (invalid row, self-loop, one
    neighbour, take-all at the fan-out, sampling just above it and at the
    largest int32), B not a multiple of a block's rows (16 times the rows a
    warp takes, 32 // fanout; 8 rows above fan-out 32), and ("wrap") a few
    rows more than the persistent grid (8 blocks an SM) covers in one pass,
    so its grid-stride loop comes round."""
    if B == "wrap":
        sms = torch.cuda.get_device_properties(cuda).multi_processor_count
        B = sms * 8 * (16 * (32 // fanout) if fanout <= 32 else 8) + 5
    rng = np.random.default_rng(1000 * fanout + B)
    degs = np.array([-1, 0, 1, fanout, fanout + 1, 2**31 - 1], dtype=np.int64)
    deg = torch.as_tensor(rng.choice(degs, B).astype(np.int32), device=cuda)
    vid = torch.as_tensor(rng.integers(0, 2**31 - 1, B).astype(np.int32),
                          device=cuda)
    key = torch.as_tensor(rng.integers(0, 2**32, 2), dtype=torch.int64,
                          device=cuda)
    out = wf_kernel.wavefront_expand(vid, deg, key, fanout)
    assert torch.equal(out, wf_ref.expand_codes(vid, deg, key[0], key[1], fanout))
    assert torch.equal(out, wf_kernel.wavefront_expand(vid, deg, key, fanout))


SHUFFLE_CASES = [
    # seed, P, Q, N, S, F, padding (Q = P: the shuffle; Q = 1: self rows)
    (0, 4, 4, 4096, 1024, 256, "zero"),  # papers-s layer 1 at the hidden width
    (1, 4, 4, 1024, 256, 256, "random"),  # padding slots hold random rows
    (2, 4, 4, 1000, 300, 13, "zero"),  # F not a multiple of 4; N not of 32
    (14, 2, 2, 37, 5, 4, "random"),
    (4, 8, 8, 513, 64, 64, "zero"),  # 8 splits
    (5, 1, 1, 100, 20, 8, "zero"),  # one split: nothing is ever sent
    (6, 3, 3, 70, 0, 16, "zero"),  # S = 0
    (7, 4, 4, 64, 64, 130, "zero"),  # every row sent to every needer
    (8, 4, 1, 8192, 1024, 256, "zero"),  # self rows, papers-s layer 1
    (9, 3, 1, 300, 200, 16, "random"),  # self rows, GAT's last width
    (10, 2, 32, 100, 10, 8, "zero"),  # the most groups an owner may have
]


def _shuffle_case(seed, P, Q, N, S, F, padding, device):
    """(g, send_idx, send_count): each pair's valid slots hold distinct rows
    in ascending order; the diagonal and some other pairs send nothing;
    padding slots hold row 0 or random rows, and random cotangents."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, min(S, N) + 1, size=(P, Q)).astype(np.int32)
    count[rng.random((P, Q)) < 0.2] = 0
    if seed == 7:
        count[:] = S
    if Q == P:
        count[np.arange(P), np.arange(P)] = 0
    idx = (rng.integers(0, N, size=(P, Q, S)) if padding == "random"
           else np.zeros((P, Q, S))).astype(np.int32)
    for q in range(P):
        for p in range(Q):
            c = count[q, p]
            idx[q, p, :c] = np.sort(rng.choice(N, size=c, replace=False))
    g = rng.normal(size=(P, Q, S, F)).astype(np.float32)
    return (torch.as_tensor(g, device=device), torch.as_tensor(idx, device=device),
            torch.as_tensor(count, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("seed,P,Q,N,S,F,padding", SHUFFLE_CASES)
def test_cuda_shuffle_bwd_bitwise(cuda, seed, P, Q, N, S, F, padding):
    """The shuffle adjoint bitwise against its plain version on a CPU copy,
    repeating, and through the differentiable send gather."""
    g, idx, count = _shuffle_case(seed, P, Q, N, S, F, padding, cuda)
    sh_kernel.reset_launches()
    out = sh_kernel.shuffle_bwd(g, idx, count, N)
    want = sh_ref.shuffle_bwd(g.cpu(), idx.cpu(), count.cpu(), N)
    assert torch.equal(out.cpu(), want)
    assert torch.equal(out, sh_kernel.shuffle_bwd(g, idx, count, N))
    assert sh_kernel.LAUNCHES["shuffle_bwd"] == 2
    # unaligned rows take the kernel's scalar path
    g_off = torch.empty(g.numel() + 1, device=cuda)[1:].view(g.shape).copy_(g)
    assert torch.equal(out, sh_kernel.shuffle_bwd(g_off, idx, count, N))
    h = torch.randn(P, N, F, device=cuda, requires_grad=True)
    send = send_gather(h, idx, count)
    (gh,) = torch.autograd.grad(send, h, g)
    assert torch.equal(gh, out)


PACKED_CASES = [
    # seed, E, W, N, keep
    (0, 1000, 64, 300, 0.9),
    (1, 37, 130, 10, 0.9),  # W not a multiple of 32
    (2, 5, 8, 513, 0.9),  # many empty blocks
    (3, 4096, 4, 700, 0.5),  # GAT's 4 heads
    (4, 82000, 128, 16384, 0.8),  # papers-s input-layer size
    (5, 3000, 1, 900, 0.8),  # one head: 32 slots a step
    (6, 3000, 33, 900, 0.8),  # 33 heads: a second head chunk of one
    (7, 6000, 4, 2, 0.9),  # rows of about 2700 slots, EB = 8192: four tiles
    (8, 500, 4, 300, 0.0),  # no valid slot
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
    # the plain version on a CPU copy: on the card its index_add_ adds in the
    # order its atomics take, which moves a row of ~2700 slots by ~1e-5
    want = _on_cpu(ss_ops.segment_sum_packed_ref, packed, local, R, EB)
    torch.testing.assert_close(out.float().cpu(), want.float(), **tol)
    assert torch.equal(out, ss_ops.segment_sum_packed(packed, local, R, EB))
    alpha = es_ops.edge_softmax_packed(packed, local, R, EB)
    want = es_ops.edge_softmax_packed_ref(packed, local, R, EB)
    torch.testing.assert_close(alpha.float(), want.float(), **tol)
    assert torch.equal(alpha, es_ops.edge_softmax_packed(packed, local, R, EB))
    assert not alpha[local[:, 0] == R].any()  # padding slots: exact zeros


def _segsum_pack(kind, R, rng):
    """(local_dst, EB) of a pack whose layout ``pack_edges`` never makes:
    ``interleaved`` puts padding anywhere in a block (slots permuted within
    each block); ``skewed`` gives one row of a block most of its 6000 valid
    slots, over several 2048-slot tiles; ``empty`` has a block with no valid
    slot."""
    if kind == "interleaved":
        DB, EB = 3, 512
        local = np.where(rng.random((DB, EB)) < 0.4, R,
                         rng.integers(0, R, size=(DB, EB)))
    elif kind == "skewed":
        DB, EB = 2, 8192
        local = np.full((DB, EB), R)
        local[0, :5000] = 17
        local[0, 5000:6000] = rng.integers(0, R, size=1000)
        local[1, :3000] = rng.integers(0, R, size=3000)
    else:
        DB, EB = 3, 256
        local = np.where(rng.random((DB, EB)) < 0.3, R,
                         rng.integers(0, R, size=(DB, EB)))
        local[1] = R
    local = rng.permuted(local, axis=1)
    return local.reshape(-1, 1).astype(np.int32), EB


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,F", [(torch.float32, 128), (torch.float32, 37),
                                     (torch.bfloat16, 13), (torch.float16, 13),
                                     (torch.bfloat16, 256)])
@pytest.mark.parametrize("kind,R", [("interleaved", 128), ("interleaved", 64),
                                    ("skewed", 128), ("empty", 96)])
def test_cuda_segment_sum_packed_bitwise(cuda, kind, R, dtype, F):
    """The packed segment sum sums each output in f32 from 0 in packed slot
    order, as its plain version (``index_add_``) does on a CPU copy: equal
    bit for bit, also with padding anywhere in a block, a row holding most
    of a block's slots, an F that is no multiple of the 16-byte piece, and
    a block with no valid slot; and it repeats bit for bit."""
    rng = np.random.default_rng([R, F, *map(ord, kind)])
    local, EB = _segsum_pack(kind, R, rng)
    contrib = torch.as_tensor(rng.normal(size=(local.shape[0], F)) * 3,
                              dtype=dtype)
    want = ss_ops.segment_sum_packed_ref(contrib, torch.as_tensor(local), R, EB)
    ss_ops.reset_launches()
    args = (contrib.to(cuda), torch.as_tensor(local, device=cuda), R, EB)
    out = ss_ops.segment_sum_packed(*args)
    assert ss_ops.LAUNCHES["segment_sum_packed"] == 1
    assert torch.equal(out.cpu(), want)
    assert torch.equal(out, ss_ops.segment_sum_packed(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("H", [4, 33])
@pytest.mark.parametrize("kind,R", [("interleaved", 128), ("skewed", 128),
                                    ("empty", 96)])
def test_cuda_edge_softmax_packed_odd_packs(cuda, kind, R, H):
    """The packed softmax on packs ``pack_edges`` never makes: padding
    anywhere in a block, a row of 5000 slots over several 2048-slot tiles
    (its max and sum carried across tiles), a block with no valid slot:
    within 3e-5 of its plain version, padding slots exact zeros, and it
    repeats bit for bit."""
    rng = np.random.default_rng([R, H, *map(ord, kind)])
    local, EB = _segsum_pack(kind, R, rng)
    logits = torch.as_tensor(rng.normal(size=(local.shape[0], H)) * 3,
                             dtype=torch.float32)
    want = es_ops.edge_softmax_packed_ref(logits, torch.as_tensor(local), R, EB)
    es_ops.reset_launches()
    args = (logits.to(cuda), torch.as_tensor(local, device=cuda), R, EB)
    alpha = es_ops.edge_softmax_packed(*args)
    assert es_ops.LAUNCHES["edge_softmax_packed"] == 1
    torch.testing.assert_close(alpha.cpu(), want, **TOL)
    assert not alpha.cpu()[torch.as_tensor(local[:, 0] == R)].any()
    assert torch.equal(alpha, es_ops.edge_softmax_packed(*args))


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


#: query groups of 1, 3, 6, 48 and 20 heads, S no multiple of the chunk:
#: B, H, KV, D, S
DECODE_GROUP_CASES = [
    (2, 4, 4, 64, 300),
    (3, 9, 3, 64, 1000),
    (2, 12, 2, 128, 517),
    (2, 48, 1, 128, 1000),
    (2, 16, 16, 256, 333),
    (1, 40, 2, 64, 700),  # 20 heads a group: a partial 16-head tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KV,D,S", DECODE_GROUP_CASES)
def test_cuda_flash_decode_groups_lengths_and_strided_views(cuda, B, H, KV, D,
                                                            S, dtype):
    """The decode kernel on a cache view with batch and row strides (rows of
    KV + 1 heads, of a longer cache), at cache_len 1, a partial 16-row step
    and S: within ``decode_attention_bound`` of the f32 result, repeating
    bit for bit; bf16 takes the tensor-core path."""
    from repro_torch.kernels.build import typed_library
    from repro_torch.kernels.flash_decode import kernel as fd
    from repro_torch.kernels.flash_decode import ref as fd_ref

    gen = torch.Generator(device=cuda).manual_seed(B * H + S)
    q = torch.randn(B, H, D, device=cuda, generator=gen).to(dtype)
    k, v = (torch.randn(B, S + 7, KV + 1, D, device=cuda,
                        generator=gen).to(dtype)[:, 3:S + 3, 1:]
            for _ in range(2))
    assert k.stride(1) != KV * D and v.stride(1) != KV * D
    assert S % fd.decode_chunk(B, KV, S, H // KV)
    lib = typed_library("flash_decode", fd._SIGNATURES)
    assert lib.flash_decode_uses_mma(fd.DTYPES[dtype], D, D) == (
        dtype == torch.bfloat16)
    fd.reset_launches()
    for L in (1, 37, S):
        n = torch.tensor([L], dtype=torch.int32, device=cuda)
        out = fd.flash_decode(q, k, v, n)
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


def _tiny_trainer(cuda, source="serial", injector=None, **over):
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    ds = make_dataset("tiny")
    spec = GNNSpec(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=32,
                   out_dim=ds.spec.num_classes, num_layers=2)
    kw = dict(num_devices=4, fanouts=(4, 4), batch_size=16, presample_epochs=1,
              plan_source=source, plan_workers=2, pipeline_depth=2,
              stall_timeout_s=60.0)
    return Trainer(ds, spec, TrainConfig(**{**kw, **over}), device=cuda,
                   injector=injector)


@pytest.mark.cuda
def test_cuda_pinned_stage_batch_is_byte_equal(cuda):
    """``stage_batch`` on the card (one pinned, non-blocking copy of the
    packed plan and labels, one of the pinned feature block, padded on the
    card) gives tensors byte-equal to pageable per-array staging; a pageable
    feature block raises."""
    from repro_torch.core.splitting import pad_axis
    from repro_torch.train import plan_io

    tr = _tiny_trainer(cuda)
    for batch in tr.plan_source_for(0, 3):
        assert batch.feats.is_pinned()
        # a block gathered before the marks grew: the card pads it
        short = batch.feats[:, : batch.feats.shape[1] // 2].contiguous().pin_memory()
        for feats in (batch.feats, short):
            f_d, pa, l_d = plan_io.stage_batch(batch.plan, feats, batch.labels, cuda)
            want = plan_io.plan_to_device(batch.plan, cuda)
            rows = batch.plan.front_ids[-1].shape[1]
            torch.cuda.synchronize()
            assert torch.equal(f_d.cpu(), torch.as_tensor(
                pad_axis(feats.numpy(), 1, rows)))
            assert torch.equal(l_d.cpu(), torch.as_tensor(batch.labels))
            for a, b in zip([pa] + pa["layers"], [want] + want["layers"]):
                for k, t in b.items():
                    if k == "layers":
                        continue
                    assert a[k].device == t.device and a[k].dtype == t.dtype, k
                    assert a[k].is_contiguous() and a[k].data_ptr() % 256 == 0, k
                    assert torch.equal(a[k], t), k
    with pytest.raises(RuntimeError, match="pinned"):
        plan_io.stage_batch(batch.plan, batch.feats.clone(), batch.labels, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("serial,pipelined", [
    ("serial", "pipelined"),
    ("device", "device_pipelined"),
])
def test_cuda_pipelined_equals_serial_bitwise(cuda, serial, pipelined):
    """On the card, pipelined delivery (device sampling on the producers' own
    streams for ``device_pipelined``) trains bit for bit as serial does."""
    runs = []
    for source in (serial, pipelined):
        tr = _tiny_trainer(cuda, source)
        losses = [it.loss for _ in range(2) for it in tr.train_epoch(3).iters]
        runs.append((losses, [p.detach().cpu() for p in tr.params]))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.cuda
def test_cuda_guarded_step_freezes_params_on_poison(cuda):
    """With ``skip_nonfinite`` a poisoned batch leaves params and Adam state
    bitwise where the step before it left them."""
    from repro_torch.faults import FaultAction, FaultInjector

    inj = FaultInjector([FaultAction("poison", batch=1)])
    poisoned = _tiny_trainer(cuda, "pipelined", inj, skip_nonfinite=True)
    st = poisoned.train_epoch(2)
    once = _tiny_trainer(cuda, "pipelined", skip_nonfinite=True)
    once.train_epoch(1)
    assert poisoned.nonfinite_skips == 1 and not np.isfinite(st.iters[1].loss)
    assert poisoned.opt_state.step == once.opt_state.step == 1
    for a, b in zip(poisoned._opt_tensors(), once._opt_tensors(), strict=True):
        assert torch.equal(a, b)


# --------------------------------------------------------------------- #
# the overlap schedule's halves and cache serving
# --------------------------------------------------------------------- #
def _halves_plan(num_devices=4):
    """A tiny-graph plan with edge halves, repadded after a larger batch (so
    its half packs and its remote sources grew and were rebased), with the
    dataset."""
    from repro_torch.core import build_split_plan, partition_graph, presample
    from repro_torch.core import repad_plan
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.graph.sampling import sample_minibatch

    ds = make_dataset("tiny")
    w = presample(ds.graph, ds.train_ids, [4, 4], 32, num_epochs=1)
    part = partition_graph(ds.graph, num_devices, method="gsplit", weights=w)
    hwm, plan = {}, None
    for k, n in enumerate((96, 32)):
        mb = sample_minibatch(ds.graph, ds.train_ids[:n], [4, 4],
                              np.random.default_rng(k))
        plan = repad_plan(build_split_plan(mb, part.assignment, num_devices,
                                           with_halves=True), hwm)
    return plan, ds, part, w


@pytest.mark.cuda
@pytest.mark.parametrize("side", ["l", "r"])
@pytest.mark.parametrize("layer", [0, 1])
def test_cuda_half_kernels_match_plain(cuda, side, layer):
    """The gather_segsum kernels on an edge half's own pack: the local half
    over the split's rows, the remote half over the recv region (P*S rows,
    whose height is the pack's sentinel); forward and row adjoint, unweighted
    and weighted with a GAT head chunk (a strided slice of alpha, packed as
    ``ops.gather_weighted_segsum`` packs it), and the weight adjoint: each
    bitwise against its plain version on a CPU copy, each repeating."""
    from repro_torch.kernels.gather_segsum.ops import AGG_ROWS as _R

    plan, _, _, _ = _halves_plan()
    lp = plan.layers[layer]
    P = lp.edge_src.shape[0]
    M = lp.n_local if side == "l" else P * lp.send_idx.shape[2]
    num_out = lp.self_pos.shape[1]
    src = torch.as_tensor(getattr(lp, f"{side}edge_src"), device=cuda)
    perm = torch.as_tensor(getattr(lp, f"{side}pack_perm"), device=cuda)
    pd = torch.as_tensor(getattr(lp, f"{side}pack_dst"), device=cuda)
    assert src.shape[1] > 0 and M > 0
    pack_src = ops._pack_src(src, perm, pd, M)
    gen = torch.Generator(device=cuda).manual_seed(layer)
    H, dh = 4, 8
    rows = torch.randn(P, M, 2 * dh, device=cuda, generator=gen)  # 2 heads
    g = torch.randn(P, num_out, 2 * dh, device=cuda, generator=gen)
    alpha = torch.randn(P, src.shape[1], H, device=cuda, generator=gen)
    chunk = alpha[:, :, 1:3]  # heads 1 and 2: a strided view
    flat = perm.reshape(P, -1).long().clamp(0, src.shape[1] - 1)
    valid = (pd.reshape(P, -1) < _R).float()
    w = (torch.gather(chunk, 1, flat[:, :, None].expand(-1, -1, 2))
         * valid[:, :, None]).contiguous()
    for weights in (None, w):
        out = kernel.gather_segsum_fwd(rows, pack_src, pd, weights, num_out)
        assert torch.equal(out.cpu(), _on_cpu(
            ref.gather_segsum_fwd_packed, rows, pack_src, pd, weights, num_out))
        assert torch.equal(out, kernel.gather_segsum_fwd(
            rows, pack_src, pd, weights, num_out))
        gm = kernel.gather_segsum_bwd_mixed(g, pack_src, pd, weights, M)
        assert torch.equal(gm.cpu(), _on_cpu(
            ref.gather_segsum_bwd_mixed_packed, g, pack_src, pd, weights, M))
        assert torch.equal(gm, kernel.gather_segsum_bwd_mixed(
            g, pack_src, pd, weights, M))
    gw = kernel.gather_segsum_bwd_w(rows, g, pack_src, pd, 2)
    assert torch.equal(gw.cpu(), _on_cpu(
        ref.gather_segsum_bwd_w_packed, rows, g, pack_src, pd, 2))
    assert torch.equal(gw, kernel.gather_segsum_bwd_w(rows, g, pack_src, pd, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sage", "gat"])
def test_cuda_zero_width_half_gives_zeros_and_launches_nothing(cuda, model):
    """P=1: every layer's remote half has width 0. Its partial sums are exact
    zeros, no kernel launches for them, and the overlap forward equals the
    blocking one within 5e-5."""
    from dataclasses import replace

    from repro_torch.models.gnn import GNN, GNNSpec, gnn_forward
    from repro_torch.models.gnn.layers import _half_sum, _half_weighted
    from repro_torch.train import plan_io

    plan, ds, _, _ = _halves_plan(num_devices=1)
    pa = plan_io.plan_to_device(plan, cuda, with_halves=True)
    lp = pa["layers"][0]
    assert lp["redge_src"].shape[1] == 0
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                   out_dim=ds.spec.num_classes, num_layers=2, num_heads=2)
    rows = torch.randn(1, 10, 8, device=cuda)
    kernel.reset_launches()
    for got in (_half_sum(spec, rows, lp, "r", 7),
                _half_weighted(spec, rows, rows[:, :0, :2], lp, "r", 7, 4)):
        assert got.shape == (1, 7, 8) and not got.any()
    assert all(v == 0 for v in kernel.LAUNCHES.values())
    gnn = GNN(spec, generator=torch.Generator().manual_seed(0)).to(cuda)
    feats = torch.as_tensor(plan_io.load_features(plan, ds.features), device=cuda)
    with torch.no_grad():
        want = gnn_forward(spec, list(gnn.layers), feats, pa)
        got = gnn_forward(replace(spec, overlap=True, shuffle_chunks=2),
                          list(gnn.layers), feats, pa)
    torch.testing.assert_close(got, want, rtol=5e-5, atol=5e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,capacity", [("partitioned", 24),
                                           ("distributed", 12),
                                           ("distributed", 1_000_000)])
def test_cuda_serve_features_equals_load_features(cuda, mode, capacity):
    """The served block on the card (index_add_'s atomics in whatever order
    they take) equals the host gather; a repeat is byte-equal."""
    from repro_torch.core.shuffle import sim_serve_features
    from repro_torch.graph.cache import FeatureCache
    from repro_torch.train import plan_io

    plan, ds, part, w = _halves_plan()
    cache = FeatureCache(ds.graph.num_nodes, 4, capacity,
                         ranking=w.vertex_weight, mode=mode,
                         partition_assignment=part.assignment)
    cp = cache.build_plan(plan)
    assert (cp.breakdown().remote_hit > 0) == (mode == "distributed")
    block = torch.as_tensor(cache.build_resident(ds.features), device=cuda)
    miss = plan_io.gather_miss_features(cp, ds.features, pin=True).to(cuda)
    cpd = plan_io.cache_plan_to_device(cp, cuda)
    got = sim_serve_features(block, cpd, miss)
    want = torch.as_tensor(plan_io.load_features(plan, ds.features))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, sim_serve_features(block, cpd, miss))


def _overlap_cache_trainer(cuda, model, source, device=None, model0=None):
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    ds = make_dataset("tiny")
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=32,
                   out_dim=ds.spec.num_classes, num_layers=2, num_heads=4)
    cfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=16,
                      presample_epochs=1, plan_source=source, plan_workers=2,
                      pipeline_depth=2, stall_timeout_s=60.0, lr=5e-3,
                      shuffle_overlap=True, shuffle_chunks=2,
                      cache_mode="partitioned", cache_capacity_per_device=24)
    return Trainer(ds, spec, cfg, device=device or cuda,
                   model=copy.deepcopy(model0) if model0 is not None else None)


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_cuda_overlap_cache_trainer_matches_cpu(cuda, model):
    """Three steps with overlap (2 chunks) and the partitioned cache on the
    card and on the CPU from the same weights agree to rtol 1e-4, and the
    card's run launched the kernels, the shuffle adjoint once a chunked
    send (SAGE: the send and the self rows of layer 0; GCN: the send; GAT:
    send, scores and self rows of both layers)."""
    from repro_torch.models.gnn import GNN

    tr = _overlap_cache_trainer(cuda, model, "serial", device="cpu")
    model0 = GNN(tr.spec, generator=torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        tr = _overlap_cache_trainer(cuda, model, "serial", dev, model0)
        kernel.reset_launches()
        sh_kernel.reset_launches()
        losses[str(dev)] = [s.loss for s in tr.train_epoch(max_iters=3).iters]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert sh_kernel.LAUNCHES["shuffle_bwd"] == 3 * {"sage": 2, "gcn": 1, "gat": 6}[model]
    assert kernel.LAUNCHES["gather_segsum_fwd"] > 0
    assert kernel.LAUNCHES["gather_segsum_bwd_mixed"] > 0
    assert (kernel.LAUNCHES["gather_segsum_bwd_w"] > 0) == (model == "gat")


@pytest.mark.cuda
@pytest.mark.parametrize("serial,pipelined", [
    ("serial", "pipelined"),
    ("device", "device_pipelined"),
])
def test_cuda_overlap_cache_pipelined_equals_serial_bitwise(cuda, serial,
                                                            pipelined):
    runs = []
    for source in (serial, pipelined):
        tr = _overlap_cache_trainer(cuda, "gat", source)
        runs.append([it.loss for _ in range(2) for it in tr.train_epoch(3).iters])
    assert runs[0] == runs[1]


@pytest.mark.cuda
def test_cuda_cached_overlap_window_stays_at_two_pinned_copies(cuda):
    """``profile_step`` (a process of its own) over two pipelined steps with
    overlap and the partitioned cache on the tiny graph: no pageable
    host-to-device copy, two pinned ones a step (the packed plan with its
    halves, cache plan and labels; the miss block)."""
    import json
    import os
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.profile_step", "--dataset", "tiny",
         "--plan-source", "pipelined", "--overlap-chunks", "2",
         "--cache-mode", "partitioned", "--cache-capacity", "24"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(root / "src")),
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    prof = json.loads(proc.stdout.strip().splitlines()[-1])["profile"]
    copies = prof["h2d_copies"]
    assert "pageable" not in copies, copies
    assert copies["pinned"]["count"] == 2 * prof["steps"], copies
    assert prof["resident_bytes"] > 0


# --------------------------------------------------------------------- #
# hot-vertex replication and the dp layout
# --------------------------------------------------------------------- #
def _rep_and_dp_plans():
    """A tiny-graph split plan built with a replication set (its input
    layer's mixed rows are [local][recv][replicated]) and a dp plan of four
    keyed micro-batches, each repadded after a larger batch; with the
    dataset and the replication set."""
    from repro_torch.core import (
        build_dp_plan,
        build_split_plan,
        partition_graph,
        presample,
        repad_plan,
    )
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.graph.sampling import NeighborSampler, sample_minibatch

    ds = make_dataset("tiny")
    w = presample(ds.graph, ds.train_ids, [4, 4], 32, num_epochs=1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w,
                           replication_budget=0.1)
    hwm, plan = {}, None
    for k, n in enumerate((96, 32)):
        mb = sample_minibatch(ds.graph, ds.train_ids[:n], [4, 4],
                              np.random.default_rng(k))
        plan = repad_plan(build_split_plan(mb, part.assignment, 4,
                                           replication=part.replication), hwm)
    sampler = NeighborSampler(ds.graph, ds.train_ids, [4, 4], 32, seed=1)
    hwm, dp = {}, None
    for k, n in enumerate((64, 32)):
        dp = repad_plan(build_dp_plan(sampler.sample_micro_batch(
            ds.train_ids[:n], 4, 0, k)), hwm)
    return {"replicated": plan, "dp": dp}, ds, part.replication


@pytest.mark.cuda
@pytest.mark.parametrize("which,layer", [("replicated", 1), ("dp", 0),
                                         ("dp", 1)])
def test_cuda_kernels_match_plain_on_replicated_and_dp_layouts(cuda, which,
                                                               layer):
    """The gather_segsum kernels at the replicated input layer (M = N + P*S
    + R mixed rows) and at a dp layout (S = 0): the walk, the forward and
    the row adjoint (unweighted and weighted) and the weight adjoint, each
    bitwise against its plain version on a CPU copy, each repeating."""
    plans, _, rep = _rep_and_dp_plans()
    lp = plans[which].layers[layer]
    P = lp.edge_src.shape[0]
    M = lp.n_local + P * lp.send_idx.shape[2] + lp.num_replicated
    if which == "replicated":
        assert lp.num_replicated == rep.num_replicated > 0
        assert int(lp.edge_src[lp.edge_mask].max()) >= M - lp.num_replicated
    else:
        assert lp.send_idx.shape[2] == 0 and M == lp.n_local
    num_out = lp.self_pos.shape[1]
    pd = torch.as_tensor(lp.pack_dst, device=cuda)
    pack_src = ops._pack_src(torch.as_tensor(lp.edge_src, device=cuda),
                             torch.as_tensor(lp.pack_perm, device=cuda), pd, M)
    gen = torch.Generator(device=cuda).manual_seed(layer)
    H = 4
    mixed = torch.randn(P, M, 32, device=cuda, generator=gen)
    g = torch.randn(P, num_out, 32, device=cuda, generator=gen)
    w = torch.randn(P, pd.shape[1] * pd.shape[2], H, device=cuda, generator=gen)
    csr = kernel.src_sorted_csr(pack_src, pd, M, num_out)
    for got, exp in zip(csr, _on_cpu(ref.src_sorted_csr_ref, pack_src, pd, M,
                                     num_out), strict=True):
        assert torch.equal(got.cpu(), exp)
    for weights in (None, w):
        out = kernel.gather_segsum_fwd(mixed, pack_src, pd, weights, num_out)
        assert torch.equal(out.cpu(), _on_cpu(
            ref.gather_segsum_fwd_packed, mixed, pack_src, pd, weights, num_out))
        assert torch.equal(out, kernel.gather_segsum_fwd(
            mixed, pack_src, pd, weights, num_out))
        gm = kernel.gather_segsum_bwd_mixed(g, pack_src, pd, weights, M, csr)
        assert torch.equal(gm.cpu(), _on_cpu(
            ref.gather_segsum_bwd_mixed_packed, g, pack_src, pd, weights, M))
        assert torch.equal(gm, kernel.gather_segsum_bwd_mixed(
            g, pack_src, pd, weights, M))
    gw = kernel.gather_segsum_bwd_w(mixed, g, pack_src, pd, H)
    assert torch.equal(gw.cpu(), _on_cpu(
        ref.gather_segsum_bwd_w_packed, mixed, g, pack_src, pd, H))
    assert torch.equal(gw, kernel.gather_segsum_bwd_w(mixed, g, pack_src, pd, H))


@pytest.mark.cuda
@pytest.mark.parametrize("layer", [0, 1])
def test_cuda_shuffle_bwd_at_dp_self_rows(cuda, layer):
    """A dp step's only shuffle adjoint, the self rows' (one group a split):
    bitwise against its plain version on a CPU copy, through the
    differentiable ``self_gather``, one launch."""
    from repro_torch.kernels.shuffle import self_gather

    plans, _, _ = _rep_and_dp_plans()
    dp = plans["dp"]
    lp = dp.layers[layer]
    P, N = lp.self_pos.shape[0], lp.n_local
    self_pos = torch.as_tensor(lp.self_pos, device=cuda)
    count = torch.as_tensor(dp.node_count[layer], device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(7)
    h = torch.randn(P, N, 24, device=cuda, generator=gen, requires_grad=True)
    g = torch.randn(P, lp.self_pos.shape[1], 24, device=cuda, generator=gen)
    sh_kernel.reset_launches()
    (got,) = torch.autograd.grad(self_gather(h, self_pos, count), h, g)
    assert sh_kernel.LAUNCHES["shuffle_bwd"] == 1
    live = (torch.arange(g.shape[1], device=cuda)[None] < count[:, None])
    want = sh_ref.shuffle_bwd((g * live[:, :, None])[:, None].cpu(),
                              self_pos[:, None].cpu(), count[:, None].cpu(), N)
    assert torch.equal(got.cpu(), want)


#: a 2-layer step's ``shuffle_bwd`` launches: split as in
#: ``test_cuda_trainer_matches_cpu`` (replication changes none); dp and
#: pushpull (S = 0) only the self rows' (SAGE 1, GCN 0, GAT 2)
_SHUFFLE_BWD = {"split": {"sage": 2, "gcn": 1, "gat": 3},
                "dp": {"sage": 1, "gcn": 0, "gat": 2}}


@pytest.mark.cuda
@pytest.mark.parametrize("mode,budget", [("split", 0.1), ("dp", 0.0),
                                         ("pushpull", 0.0)])
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_cuda_dp_and_replicated_trainers_match_cpu(cuda, mode, budget, model):
    """Three steps on the card and on the CPU from the same weights agree to
    rtol 1e-4, with replication in split mode and in dp and pushpull; the
    card's shuffle adjoint launches follow the mode's table."""
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    ds = make_dataset("tiny")
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=64,
                   out_dim=ds.spec.num_classes, num_layers=2)
    cfg = TrainConfig(mode=mode, num_devices=4, fanouts=(4, 4), batch_size=16,
                      presample_epochs=2, lr=5e-3, replication_budget=budget)
    model0 = GNN(spec, generator=torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        tr = Trainer(ds, spec, cfg, device=dev, model=copy.deepcopy(model0))
        assert (tr.rep_block is not None) == (mode == "split")
        kernel.reset_launches()
        sh_kernel.reset_launches()
        losses[str(dev)] = [s.loss for s in tr.train_epoch(max_iters=3).iters]
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    table = _SHUFFLE_BWD["split" if mode == "split" else "dp"]
    assert sh_kernel.LAUNCHES["shuffle_bwd"] == 3 * table[model]
    assert kernel.LAUNCHES["gather_segsum_fwd"] > 0
    assert (kernel.LAUNCHES["gather_segsum_bwd_w"] > 0) == (model == "gat")


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_cuda_mesh_trainer_matches_cpu(cuda, model):
    """An R = 2 mesh (2 replica groups of P = 4) on the card and on the CPU
    from the same weights: 2 epochs of 2 steps agree to rtol 1e-4; a mesh
    step launches the shuffle adjoint R times a 1-D step's count."""
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.models.gnn import GNN, GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    ds = make_dataset("tiny")
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=64,
                   out_dim=ds.spec.num_classes, num_layers=2)
    cfg = TrainConfig(num_devices=4, fanouts=(4, 4), batch_size=32,
                      presample_epochs=2, lr=5e-3, num_replicas=2)
    model0 = GNN(spec, generator=torch.Generator().manual_seed(0))
    losses = {}
    for dev in ("cpu", cuda):
        tr = Trainer(ds, spec, cfg, device=dev, model=copy.deepcopy(model0))
        sh_kernel.reset_launches()
        losses[str(dev)] = [s.loss for _ in range(2)
                            for s in tr.train_epoch(max_iters=2).iters]
    assert len(losses["cpu"]) == 4
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    assert sh_kernel.LAUNCHES["shuffle_bwd"] == 4 * 2 * _SHUFFLE_BWD["split"][model]


@pytest.mark.cuda
@pytest.mark.parametrize("serial,pipelined", [
    ("serial", "pipelined"),
    ("device", "device_pipelined"),
])
def test_cuda_mesh_pipelined_equals_serial_bitwise(cuda, serial, pipelined):
    """At R = 2 on the card, pipelined delivery trains bit for bit as serial
    does: the keyed per-replica draws (the device sampler's flattened
    counter on the producers' own streams) and the shared-mark repad."""
    runs = []
    for source in (serial, pipelined):
        tr = _tiny_trainer(cuda, source, num_replicas=2, batch_size=32)
        losses = [it.loss for _ in range(2) for it in tr.train_epoch(3).iters]
        runs.append((losses, [p.detach().cpu() for p in tr.params]))
    assert len(runs[0][0]) > 2 and runs[0][0] == runs[1][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


@pytest.mark.cuda
def test_cuda_checkpoint_resume_is_the_clean_suffix(cuda, tmp_path):
    """On ``device_pipelined``, a run killed at (epoch 1, batch 2) with a
    checkpoint every step, resumed on the card by a fresh trainer, trains
    the clean run's remaining steps bit for bit and ends in its params and
    Adam slots."""
    from repro_torch.faults import FaultAction, FaultInjected, FaultInjector

    clean = _tiny_trainer(cuda, "device_pipelined")
    traj = [it.loss for _ in range(2) for it in clean.train_epoch(4).iters]
    over = dict(ckpt_dir=str(tmp_path), ckpt_every=1)
    inj = FaultInjector([FaultAction("kill", epoch=1, batch=2)])
    tr = _tiny_trainer(cuda, "device_pipelined", injector=inj, **over)
    tr.train_epoch(4)
    with pytest.raises(FaultInjected):
        tr.train_epoch(4)
    tr = _tiny_trainer(cuda, "device_pipelined", **over)
    ck = tr.resume()
    assert ck is not None and (tr._epoch, tr._start_iter) == (1, 2)
    assert tr.params[0].device.type == "cuda"
    assert tr.device_sampler.export_state() == ck.cursor["sampler"]
    assert [it.loss for it in tr.train_epoch(4).iters] == traj[6:]
    assert all(torch.equal(a, b) for a, b in zip(tr._opt_tensors(),
                                                 clean._opt_tensors(),
                                                 strict=True))


@pytest.mark.cuda
def test_cuda_checkpoint_resumes_on_cpu(cuda, tmp_path):
    """A checkpoint written on the card resumes in a CPU trainer: the next
    epoch's losses agree with the card run's within rtol 1e-4."""
    over = dict(ckpt_dir=str(tmp_path), ckpt_every=3)
    card = _tiny_trainer(cuda, "device_pipelined", **over)
    card.train_epoch(3)
    host = _tiny_trainer("cpu", "device_pipelined", **over)
    ck = host.resume()
    assert ck.step == 3 and (host._epoch, host._start_iter) == (1, 0)
    assert host.params[0].device.type == "cpu"
    got = [it.loss for it in host.train_epoch(3).iters]
    want = [it.loss for it in card.train_epoch(3).iters]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_cuda_spmd_alltoall_and_replica_mean_world1(cuda, wire):
    """One rank on the card over NCCL (``launch`` at world size 1):
    ``spmd_alltoall`` at a full-width block is the sim form bit for bit,
    forward and adjoint, and ``replica_grad_mean`` at R = 1 the identity."""
    from repro_torch.core.shuffle import sim_alltoall
    from repro_torch.launch import spmd
    from test_torch_spmd_ranks import exchange_rank

    gen = torch.Generator().manual_seed(0)
    send = torch.randn(1, 1, 4096, 256, generator=gen)
    cot = torch.randn(1, 1, 4096, 256, generator=gen)
    grads = [torch.randn(64, 64, generator=gen), torch.randn(64, generator=gen)]
    cases = [{"op": "alltoall", "wire": wire,
              "inputs": [{"send": send, "cot": cot}]},
             {"op": "replica_mean", "wire": None, "inputs": [{"grads": grads}]}]
    (res,) = spmd.launch([(exchange_rank, (1, 1, cases))], world=1,
                         timeout_s=300.0)
    got, mean = res[0]
    s = send.to(cuda, copy=True).requires_grad_(True)
    want = sim_alltoall(s, wire)
    (want * cot.to(cuda)).sum().backward()
    assert np.array_equal(got["out"], want.detach().cpu().numpy())
    assert np.array_equal(got["grads"]["send"], s.grad.cpu().numpy())
    assert all(np.array_equal(a, b.numpy())
               for a, b in zip(mean["out"], grads, strict=True))


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["sage", "gat"])
def test_cuda_spmd_trainer_world1_matches_sim_bitwise(cuda, model):
    """``SpmdTrainer`` in one NCCL rank on the card (``train_rank``, one
    split): three steps bitwise the sim ``Trainer`` at ``num_devices=1``
    on the card, the kernels on both paths."""
    from repro_torch.graph.datasets import make_dataset
    from repro_torch.launch import spmd
    from repro_torch.models.gnn import GNNSpec
    from repro_torch.train.trainer import TrainConfig, Trainer

    ds = make_dataset("tiny")
    spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=64,
                   out_dim=ds.spec.num_classes, num_layers=2)
    cfg = TrainConfig(num_devices=1, fanouts=(4, 4), batch_size=16,
                      presample_epochs=2, lr=5e-3)
    (res,) = spmd.launch([(spmd.train_rank, (ds, spec, cfg, 1, 3))], world=1,
                         timeout_s=300.0)
    sim = Trainer(ds, spec, cfg, device=cuda)
    assert res[0]["losses"] == [it.loss for it in
                                sim.train_epoch(max_iters=3).iters]
    assert all(np.array_equal(a, p.detach().cpu().numpy())
               for a, p in zip(res[0]["params"], sim.params, strict=True))
