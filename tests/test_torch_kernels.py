"""The port's fused gather->segment ops against the JAX package's.

The same seeded numpy inputs go through ``repro``'s fused ops (Pallas in
interpret mode, one split at a time, as ``tests/test_gather_segsum.py`` runs
them) and through ``repro_torch``'s (all P splits at once; on CPU tensors the
kernels' plain versions). Tolerances are those of
``tests/test_gather_segsum.py``: forward 3e-5, gradients 3e-4 — the sums visit
the slots in another order (index_add vs one-hot matmul).

The CUDA kernels themselves are held against their plain versions in
``tests/test_torch_cuda.py`` (marked ``cuda``; that file imports no JAX, so it
also runs on a machine with a card and without JAX).
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment_ops as jax_segment_ops
from repro.kernels.gather_segsum import ops as jax_ops
from repro.kernels.gather_segsum import ref as jax_ref
from repro_torch.kernels import segment_ops
from repro_torch.kernels.gather_segsum import kernel, layout, ops, ref
from repro_torch.core.splitting import pad_axis_fill

TOL = dict(rtol=3e-5, atol=3e-5)
GRAD_TOL = dict(rtol=3e-4, atol=3e-4)
R = layout.AGG_ROWS


def _case(seed, P, E, M, F, N, keep=0.8, grow=False):
    """P splits of random edges laid out by the port's layout copy.

    ``grow`` repads the layout like a high-water-mark repad does: the edge
    axis grows (stale perm sentinels now point at masked edge slots), and the
    EB and DB axes grow with sentinel appends — a sentinel-heavy pack.
    """
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, N, size=(P, E)).astype(np.int32)
    mask = rng.random((P, E)) < keep
    src = rng.integers(0, M, size=(P, E)).astype(np.int32)
    mixed = rng.normal(size=(P, M, F)).astype(np.float32)
    lay = layout.layer_layout(dst, mask, N)
    pp, pd = lay["pack_perm"], lay["pack_dst"]
    num_out = N
    if grow:
        E2 = E + 37
        dst = np.pad(dst, ((0, 0), (0, E2 - E)))
        src = np.pad(src, ((0, 0), (0, E2 - E)))
        mask = np.pad(mask, ((0, 0), (0, E2 - E)))
        eb2, db2 = pp.shape[2] * 2, pp.shape[1] + 2
        num_out = db2 * R - 5
        pp = pad_axis_fill(pad_axis_fill(pp, 2, eb2, E2), 1, db2, E2)
        pd = pad_axis_fill(pad_axis_fill(pd, 2, eb2, R), 1, db2, R)
    seg = np.pad(lay["seg_offsets"], ((0, 0), (0, num_out - N)), mode="edge")
    return dict(mixed=mixed, src=src, dst=dst, mask=mask, pp=pp, pd=pd,
                seg=seg, num_out=num_out, rng=rng)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _jax_per_split(fn, c, *per_split):
    """Run a JAX fused op split by split and stack the results."""
    return np.stack([
        np.asarray(fn(*(jnp.asarray(a[p]) for a in per_split)))
        for p in range(c["mixed"].shape[0])
    ])


CASES = [
    # seed, P, E, M, F, N, keep, grow
    (0, 4, 300, 80, 48, 200, 0.8, False),
    (1, 3, 37, 10, 130, 10, 0.8, False),  # F not a multiple of 32
    (2, 2, 500, 200, 1, 300, 0.5, False),  # one feature column
    (3, 4, 5, 8, 8, 513, 0.8, False),  # many empty dst blocks
    (4, 4, 400, 100, 32, 150, 0.3, True),  # repadded, sentinel-heavy
    (5, 2, 64, 30, 16, 700, 0.05, True),  # nearly empty: empty segments
]


@pytest.mark.parametrize("seed,P,E,M,F,N,keep,grow", CASES)
def test_fused_sum_and_mean_match_jax(seed, P, E, M, F, N, keep, grow):
    c = _case(seed, P, E, M, F, N, keep, grow)
    num_out = c["num_out"]
    args = (c["src"], c["pp"], c["pd"])
    out = ops.gather_segment_sum(_t(c["mixed"]), *map(_t, args), num_out)
    j_out = _jax_per_split(
        lambda m, s, pp, pd: jax_ops.gather_segment_sum(m, s, pp, pd, num_out),
        c, c["mixed"], *args,
    )
    np.testing.assert_allclose(out.numpy(), j_out, **TOL)
    # the port's own edge-order oracle agrees, and rows without edges are 0
    for p in range(P):
        r = ref.gather_segment_sum_ref(
            _t(c["mixed"][p]), _t(c["src"][p]), _t(c["dst"][p]),
            _t(c["mask"][p]), num_out,
        )
        np.testing.assert_allclose(out[p].numpy(), r.numpy(), **TOL)
    counts = np.diff(c["seg"], axis=1)
    assert not out.numpy()[counts == 0].any()

    mean = ops.gather_segment_mean(
        _t(c["mixed"]), *map(_t, args), _t(c["seg"]), num_out
    )
    j_mean = _jax_per_split(
        lambda m, s, pp, pd, so: jax_ops.gather_segment_mean(
            m, s, pp, pd, so, num_out
        ),
        c, c["mixed"], *args, c["seg"],
    )
    np.testing.assert_allclose(mean.numpy(), j_mean, **TOL)
    assert not mean.numpy()[counts == 0].any()
    for p in range(P):
        r = ref.gather_segment_mean_ref(
            _t(c["mixed"][p]), _t(c["src"][p]), _t(c["dst"][p]),
            _t(c["mask"][p]), num_out,
        )
        np.testing.assert_allclose(mean[p].numpy(), r.numpy(), **TOL)


@pytest.mark.parametrize("seed,P,E,M,F,N,keep,grow", CASES[:2] + CASES[4:])
def test_fused_sum_grad_matches_jax(seed, P, E, M, F, N, keep, grow):
    c = _case(seed, P, E, M, F, N, keep, grow)
    num_out = c["num_out"]
    args = (c["src"], c["pp"], c["pd"])
    m = _t(c["mixed"], requires_grad=True)
    (ops.gather_segment_sum(m, *map(_t, args), num_out) ** 2).sum().backward()
    j_grad = _jax_per_split(
        lambda mm, s, pp, pd: jax.grad(
            lambda x: (jax_ops.gather_segment_sum(x, s, pp, pd, num_out) ** 2).sum()
        )(mm),
        c, c["mixed"], *args,
    )
    np.testing.assert_allclose(m.grad.numpy(), j_grad, **GRAD_TOL)


@pytest.mark.parametrize("grow", [False, True])
def test_fused_weighted_matches_jax_with_grads(grow):
    P, E, M, H, dh, N = 3, 300, 80, 4, 16, 120
    c = _case(3, P, E, M, H * dh, N, 0.8, grow)
    num_out = c["num_out"]
    w_np = c["rng"].normal(size=(P, c["src"].shape[1], H)).astype(np.float32)
    args = (c["src"], c["pp"], c["pd"])
    m = _t(c["mixed"], requires_grad=True)
    w = _t(w_np, requires_grad=True)
    out = ops.gather_weighted_segsum(m, w, *map(_t, args), num_out)
    (out ** 2).sum().backward()

    def jax_one(mm, ww, s, pp, pd):
        f = lambda x, y: jax_ops.gather_weighted_segsum(  # noqa: E731
            x, y, s, pp, pd, num_out
        )
        o = f(mm, ww)
        gm, gw = jax.grad(lambda x, y: (f(x, y) ** 2).sum(), argnums=(0, 1))(
            mm, ww
        )
        return o, gm, gw

    res = [
        jax_one(*(jnp.asarray(a[p]) for a in (c["mixed"], w_np, *args)))
        for p in range(P)
    ]
    for k, got in enumerate((out.detach(), m.grad, w.grad)):
        tol = TOL if k == 0 else GRAD_TOL
        np.testing.assert_allclose(
            got.numpy(), np.stack([np.asarray(r[k]) for r in res]), **tol
        )
    # and against both edge-order oracles, split by split
    for p in range(P):
        r = jax_ref.gather_weighted_segsum_ref(
            jnp.asarray(c["mixed"][p]), jnp.asarray(w_np[p]),
            jnp.asarray(c["src"][p]), jnp.asarray(c["dst"][p]),
            jnp.asarray(c["mask"][p]), num_out,
        )
        np.testing.assert_allclose(out[p].detach().numpy(), np.asarray(r), **TOL)
        rt = ref.gather_weighted_segsum_ref(
            _t(c["mixed"][p]), _t(w_np[p]), _t(c["src"][p]), _t(c["dst"][p]),
            _t(c["mask"][p]), num_out,
        )
        np.testing.assert_allclose(rt.numpy(), np.asarray(r), **TOL)


def _lanes_head_sum(m, g, dh):
    """One head's dot, added as the CUDA kernel's lanes add it, in float32
    scalars: unit partials (4 columns left to right, or 1 column when
    dh % 4 != 0); for n2 <= 32 padded units a group of n2 lanes, lane u
    added to lane u + off at offsets n2/2, ..., 1 (the kernel's
    reduce-scatter pairs them so); beyond, each of 32 lanes streams its
    units l + 32k in bit-reversed k order through a pairwise stack, then the
    same pairing over the 32 lanes."""
    f32 = np.float32
    u = 4 if dh % 4 == 0 else 1
    n = dh // u
    n2 = 1 << (n - 1).bit_length()

    def unit(i):
        if i >= n:
            return f32(0.0)
        s = f32(m[i * u] * g[i * u])
        for e in range(1, u):
            s = f32(s + f32(m[i * u + e] * g[i * u + e]))
        return s

    def butterfly(lanes):
        off = len(lanes) // 2
        while off:
            lanes = [f32(lanes[l] + lanes[l ^ off]) for l in range(len(lanes))]
            off //= 2
        return lanes[0]

    if n2 <= 32:
        return butterfly([unit(i) for i in range(n2)])
    lg_k = (n2 // 32).bit_length() - 1
    lanes = []
    for lane in range(32):
        stack = {}
        for t in range(1 << lg_k):
            k = int(format(t, f"0{lg_k}b")[::-1], 2)
            v, lv = unit(lane + 32 * k), 0
            while (t >> lv) & 1:
                v = f32(stack[lv] + v)
                lv += 1
            stack[lv] = v
        lanes.append(v)
    return butterfly(lanes)


@pytest.mark.parametrize("dh", [1, 3, 8, 16, 64, 96, 130, 256])
def test_bwd_w_plain_version_sums_in_the_stated_order(dh):
    """The weight adjoint's plain version adds each head in one stated order
    (``ref.head_tree_sum``): bitwise equal to a slot-by-slot evaluation as
    the kernel's lanes add it, within 1e-6 of a float64 dot (relative to the
    sum of the products' magnitudes), and padding slots exact zeros."""
    H = 2
    c = _case(dh, 2, 60, 20, H * dh, 40, 0.7)
    g = c["rng"].normal(size=(2, c["num_out"], H * dh)).astype(np.float32)
    pd = _t(c["pd"])
    pack_src = ops._pack_src(_t(c["src"]), _t(c["pp"]), pd, 20)
    dw = kernel.gather_segsum_bwd_w(_t(c["mixed"]), _t(g), pack_src, pd, H)
    dw = dw.numpy().reshape(-1, H)
    P, DB, EB = c["pd"].shape
    flat_dst, flat_src = c["pd"].reshape(-1), pack_src.numpy().reshape(-1)
    valid = flat_dst < R
    assert valid.any() and not dw[~valid].any()
    for s in np.flatnonzero(valid):
        p, db = s // (DB * EB), (s // EB) % DB
        m_row = c["mixed"][p, flat_src[s]]
        g_row = g[p, db * R + flat_dst[s]]
        for h in range(H):
            cols = slice(h * dh, (h + 1) * dh)
            prod = m_row[cols].astype(np.float64) * g_row[cols]
            assert dw[s, h] == _lanes_head_sum(m_row[cols], g_row[cols], dh)
            assert abs(dw[s, h] - prod.sum()) <= 1e-6 * np.abs(prod).sum()


def test_repadded_plan_matches_jax():
    """On a real plan repadded to larger high-water marks (edge_src rebased,
    every pack axis grown), the port's fused mean equals the JAX fused mean
    on the JAX package's own plan, split by split."""
    from repro.core import build_split_plan, partition_graph, presample
    from repro.core.splitting import repad_plan
    from repro.graph.datasets import make_dataset
    from repro.graph.sampling import sample_minibatch
    from repro_torch.core.splitting import repad_plan as t_repad_plan
    from repro_torch.train.plan_io import plan_to_device

    ds = make_dataset("tiny")
    mb = sample_minibatch(ds.graph, ds.train_ids[:24], [4, 4],
                          np.random.default_rng(0))
    w = presample(ds.graph, ds.train_ids, [4, 4], 24, num_epochs=1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    plan = copy.deepcopy(build_split_plan(mb, part.assignment, 4))
    hwm = {"N0": 64, "N1": 192, "N2": 512, "E0": 1024, "E1": 1024,
           "S0": 48, "S1": 48, "EB0": 128, "EB1": 128}
    repad_plan(plan, dict(hwm))
    t_plan = copy.deepcopy(plan)  # same arrays; the port's repad is a no-op
    t_repad_plan(t_plan, dict(hwm))
    pa = plan_to_device(t_plan, "cpu")
    for li, lp in enumerate(plan.layers):
        num_out = lp.self_pos.shape[1]
        width = lp.n_local + plan.num_devices * lp.send_idx.shape[2]
        mixed = np.random.default_rng(li).normal(
            size=(plan.num_devices, width, 12)
        ).astype(np.float32)
        tl = pa["layers"][li]
        got = ops.gather_segment_mean(
            _t(mixed), tl["edge_src"], tl["pack_perm"], tl["pack_dst"],
            tl["seg_offsets"], num_out,
        )
        for p in range(plan.num_devices):
            want = jax_ops.gather_segment_mean(
                jnp.asarray(mixed[p]), jnp.asarray(lp.edge_src[p]),
                jnp.asarray(lp.pack_perm[p]), jnp.asarray(lp.pack_dst[p]),
                jnp.asarray(lp.seg_offsets[p]), num_out,
            )
            np.testing.assert_allclose(got[p].numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("E,H,N,keep", [(200, 4, 50, 0.8), (64, 2, 300, 0.1)])
def test_edge_softmax_matches_jax(E, H, N, keep):
    rng = np.random.default_rng(E)
    logits = (rng.normal(size=(E, H)) * 3).astype(np.float32)
    dst = rng.integers(0, N, size=E).astype(np.int32)
    mask = rng.random(E) < keep
    cot = rng.normal(size=(E, H)).astype(np.float32)
    lt = _t(logits, requires_grad=True)
    a = segment_ops.edge_softmax(lt, _t(dst), _t(mask), N)
    (a * _t(cot)).sum().backward()

    def jax_softmax(x):
        return jax_segment_ops.edge_softmax(
            x, jnp.asarray(dst), jnp.asarray(mask), N
        )

    j, vjp = jax.vjp(jax.jit(jax_softmax), jnp.asarray(logits))
    np.testing.assert_allclose(a.detach().numpy(), np.asarray(j), **TOL)
    assert not a.detach().numpy()[~mask].any()
    np.testing.assert_allclose(
        lt.grad.numpy(), np.asarray(vjp(jnp.asarray(cot))[0]), **GRAD_TOL
    )


def test_segment_ops_empty_segments_exact_zeros():
    contrib = torch.randn(6, 3)
    dst = torch.tensor([0, 0, 2, 2, 2, 4])
    mask = torch.tensor([True, True, False, False, False, True])
    assert not segment_ops.segment_sum(contrib, dst, mask, 5)[[1, 2, 3]].any()
    mean = segment_ops.segment_mean(contrib, dst, mask, 5)
    assert torch.isfinite(mean).all() and not mean[[1, 2, 3]].any()
    sm = segment_ops.edge_softmax(torch.randn(6, 2), dst, mask, 5)
    assert torch.isfinite(sm).all() and not sm[~mask].any()


def test_plain_versions_do_not_count_launches():
    kernel.reset_launches()
    c = _case(0, 2, 50, 20, 8, 30)
    ops.gather_segment_sum(_t(c["mixed"]), _t(c["src"]), _t(c["pp"]),
                           _t(c["pd"]), 30)
    assert sum(kernel.LAUNCHES.values()) == 0


def test_wrapper_rejects_bad_inputs():
    c = _case(0, 2, 50, 20, 8, 30)
    mixed, pp, pd = _t(c["mixed"]), _t(c["pp"]), _t(c["pd"])
    with pytest.raises(TypeError):
        kernel.gather_segsum_fwd(mixed.double(), pp, pd, None, 30)
    with pytest.raises(TypeError):
        kernel.gather_segsum_fwd(mixed, pp.long(), pd, None, 30)
    with pytest.raises(ValueError):
        kernel.gather_segsum_fwd(mixed.transpose(1, 2), pp, pd, None, 30)
    with pytest.raises(ValueError):
        kernel.gather_segsum_fwd(mixed, pp[:1], pd[:1], None, 30)


def test_index_walks_match_the_layout():
    """The index structures the CUDA kernels walk, built on device by the
    wrappers, agree with the layout: each row's run of slots in its block
    (forward) and the src-sorted walk over all valid slots (row adjoint)."""
    c = _case(4, 3, 400, 100, 8, 150, 0.3, grow=True)
    pd = _t(c["pd"])
    P, DB, EB = pd.shape
    off = kernel.block_row_offsets(pd).numpy().reshape(P, DB, R + 1)
    counts = np.stack([
        [np.bincount(c["pd"][p, b][c["pd"][p, b] < R], minlength=R)
         for b in range(DB)] for p in range(P)
    ])
    np.testing.assert_array_equal(np.diff(off, axis=-1), counts)
    assert (off[..., 0] == 0).all()

    M, num_out = 100, c["num_out"]
    pack_src = ops._pack_src(_t(c["src"]), _t(c["pp"]), pd, M)
    offsets, grow, slot = (t.numpy() for t in kernel.src_sorted_csr(
        pack_src, pd, M, num_out))
    flat_src, flat_dst = pack_src.numpy().reshape(-1), c["pd"].reshape(-1)
    valid = np.flatnonzero(flat_dst < R)
    key = valid // (DB * EB) * M + flat_src[valid]
    np.testing.assert_array_equal(
        np.diff(offsets), np.bincount(key, minlength=P * M)
    )
    n = offsets[-1]
    np.testing.assert_array_equal(slot[:n], valid[np.argsort(key, kind="stable")])
    s = slot[:n]
    np.testing.assert_array_equal(
        grow[:n],
        s // (DB * EB) * num_out + (s // EB) % DB * R + flat_dst[s],
    )


def test_layer_layout_matches_per_split_packing():
    """``layer_layout``'s shared-EB pack is, split by split, exactly what
    ``pack_dst_blocks`` materializes for that split alone."""
    rng = np.random.default_rng(9)
    P, E, N = 3, 500, 300
    dst = rng.integers(0, N, size=(P, E)).astype(np.int32)
    mask = rng.random((P, E)) < 0.6
    lay = layout.layer_layout(dst, mask, N)
    for p in range(P):
        pp, pd = layout.pack_dst_blocks(dst[p], mask[p], N, lay["pack_perm"].shape[2])
        np.testing.assert_array_equal(pp, lay["pack_perm"][p])
        np.testing.assert_array_equal(pd, lay["pack_dst"][p])
