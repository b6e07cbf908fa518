"""The port's packed segment ops (``segment_ops``'s ``backend="packed"``)
against the JAX package's ``backend="pallas"`` (interpret mode), on the CPU,
where the wrappers run their kernels' plain versions.

The pack is bitwise equal. Float results use the JAX tests' own tolerances
(``tests/test_kernels.py``): the packed sum f32 rtol/atol 2e-5, bf16 rtol
1e-2, atol 0.3 against an f32 oracle (the sum accumulates in f32 and rounds
once); the packed softmax rtol 2e-5, atol 2e-6, rows normalise to 1 within
1e-5, and empty segments are exact zeros. Inputs come from seeded numpy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import segment_ops as j_segment_ops
from repro.kernels.edge_softmax.ref import edge_softmax_ref
from repro.kernels.segsum.ops import pack_edges
from repro.kernels.segsum.ref import segment_sum_ref
from repro_torch.kernels import segment_ops
from repro_torch.kernels.edge_softmax import ops as es_ops
from repro_torch.kernels.segsum import ops as ss_ops

SHAPES = [
    (64, 16, 32),
    (1000, 64, 300),
    (37, 130, 10),  # feature dim not a multiple of 32
    (4096, 256, 1024),
    (5, 8, 513),  # tiny edges, many segments
    (513, 1, 127),  # single feature
]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}


def _edges(E, N, seed, keep=0.9):
    rng = np.random.default_rng(seed)
    return rng, rng.integers(0, N, size=E).astype(np.int32), rng.random(E) < keep


@pytest.mark.parametrize("E,N,rows", [(777, 130, 128), (64, 16, 32),
                                      (5000, 3000, 128), (3, 1, 64)])
def test_pack_edges_bitwise_equal(E, N, rows):
    _, dst, mask = _edges(E, N, E)
    want = pack_edges(dst, mask, N, rows=rows)
    got = ss_ops.pack_edges(dst, mask, N, rows=rows)
    assert want.keys() == got.keys()
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert want[k].dtype == got[k].dtype
        assert np.array_equal(want[k], got[k]), k


@pytest.mark.parametrize("E,F,N", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_packed_segment_sum_matches_jax(E, F, N, dtype):
    rng, dst, mask = _edges(E, N, E + F)
    contrib = rng.normal(size=(E, F)).astype(np.float32)
    tdt, jdt = DTYPES[dtype]
    got = segment_ops.segment_sum(torch.as_tensor(contrib).to(tdt),
                                  torch.as_tensor(dst), torch.as_tensor(mask),
                                  N, backend="packed")
    assert got.dtype == tdt and got.shape == (N, F)
    oracle = np.asarray(segment_sum_ref(
        jnp.asarray(contrib, jnp.float32 if dtype == "bfloat16" else jdt),
        jnp.asarray(dst), jnp.asarray(mask), N,
    ))
    tol = dict(rtol=2e-5, atol=2e-5) if dtype == "float32" else dict(
        rtol=1e-2, atol=0.3)
    np.testing.assert_allclose(got.float().numpy(), oracle, **tol)
    pallas = j_segment_ops.segment_sum(jnp.asarray(contrib, jdt), dst, mask, N,
                                       backend="pallas")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pallas, np.float32), **tol)


@pytest.mark.parametrize("E,H,N", [(1000, 4, 300), (64, 8, 16), (7, 1, 129),
                                   (2048, 3, 700)])
def test_packed_edge_softmax_matches_jax(E, H, N):
    rng, dst, _ = _edges(E, N, E + H)
    logits = (rng.normal(size=(E, H)) * 3).astype(np.float32)
    mask = rng.random(E) > 0.15
    got = segment_ops.edge_softmax(torch.as_tensor(logits), torch.as_tensor(dst),
                                   torch.as_tensor(mask), N, backend="packed")
    want = edge_softmax_ref(jnp.asarray(logits), jnp.asarray(dst),
                            jnp.asarray(mask), N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)
    pallas = j_segment_ops.edge_softmax(jnp.asarray(logits), dst, mask, N,
                                        backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5,
                               atol=2e-6)


def test_packed_edge_softmax_normalizes():
    rng, dst, _ = _edges(500, 100, 0)
    logits = rng.normal(size=(500, 4)).astype(np.float32)
    alpha = segment_ops.edge_softmax(torch.as_tensor(logits), torch.as_tensor(dst),
                                     torch.ones(500, dtype=torch.bool), 100,
                                     backend="packed").numpy()
    sums = np.zeros((100, 4))
    np.add.at(sums, dst, alpha)
    present = np.bincount(dst, minlength=100) > 0
    np.testing.assert_allclose(sums[present], 1.0, rtol=1e-5)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("backend", list(segment_ops.BACKENDS))
def test_empty_segments_exact_zeros(dtype, backend):
    """Destinations whose edges are all masked aggregate to exact zeros, in
    every dtype and both backends (the packed softmax included at float16:
    it computes in float32)."""
    E, N, F, H = 64, 20, 8, 4
    rng = np.random.default_rng(0)
    dst = rng.integers(0, N // 2, size=E).astype(np.int32)
    dst[:10] = 13  # segment 13 exists but every one of its edges is masked
    mask = np.ones(E, bool)
    mask[:10] = False
    tdt, _ = DTYPES[dtype]
    contrib = torch.as_tensor(rng.normal(size=(E, F)) * 5).to(tdt)
    logits = torch.as_tensor(rng.normal(size=(E, H)) * 5).to(tdt)
    d, m = torch.as_tensor(dst), torch.as_tensor(mask)
    mean = segment_ops.segment_mean(contrib, d, m, N, backend=backend).float()
    assert torch.isfinite(mean).all()
    assert not mean[13].any() and not mean[N // 2:].any()
    total = segment_ops.segment_sum(contrib, d, m, N, backend=backend).float()
    assert torch.isfinite(total).all() and not total[13].any()
    alpha = segment_ops.edge_softmax(logits, d, m, N, backend=backend).float()
    assert alpha.dtype == torch.float32 and torch.isfinite(alpha).all()
    assert not alpha[:10].any()  # masked edges carry exactly zero weight
    sums = np.zeros((N, H))
    np.add.at(sums, dst, alpha.numpy())
    present = np.bincount(dst[mask], minlength=N) > 0
    rtol = 2e-5 if dtype == "float32" else 2e-2  # alpha is quantized
    np.testing.assert_allclose(sums[present], 1.0, rtol=rtol)


def test_packed_mean_matches_jax():
    rng, dst, mask = _edges(900, 200, 5)
    contrib = rng.normal(size=(900, 24)).astype(np.float32)
    got = segment_ops.segment_mean(torch.as_tensor(contrib), torch.as_tensor(dst),
                                   torch.as_tensor(mask), 200, backend="packed")
    want = j_segment_ops.segment_mean(jnp.asarray(contrib), dst, mask, 200,
                                      backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_packed_wrappers_check_inputs_and_count_only_kernel_launches():
    rng, dst, mask = _edges(300, 150, 1)
    pack = ss_ops.pack_edges(dst, mask, 150)
    R, EB = pack["rows"], pack["edge_block"]
    local = torch.as_tensor(pack["local_dst"])
    x = torch.as_tensor(rng.normal(size=(len(pack["perm"]), 6)),
                        dtype=torch.float32)
    ss_ops.reset_launches()
    es_ops.reset_launches()
    ss_ops.segment_sum_packed(x, local, R, EB)  # CPU: the plain versions
    es_ops.edge_softmax_packed(x, local, R, EB)
    assert ss_ops.LAUNCHES["segment_sum_packed"] == 0
    assert es_ops.LAUNCHES["edge_softmax_packed"] == 0
    for fn in (ss_ops.segment_sum_packed, es_ops.edge_softmax_packed):
        with pytest.raises(TypeError):
            fn(x.double(), local, R, EB)
        with pytest.raises(TypeError):
            fn(x, local.long(), R, EB)
        with pytest.raises(ValueError):
            fn(x[:-1], local[:-1], R, EB)  # not whole blocks
        with pytest.raises(ValueError):
            fn(x, local, 48, EB)  # rows not a multiple of 32
        with pytest.raises(ValueError):
            fn(x.t().contiguous().t(), local, R, EB)
    with pytest.raises(ValueError, match="backend"):
        segment_ops.segment_sum(x, local[:, 0], local[:, 0] < R, 150,
                                backend="pallas")


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean", "edge_softmax"])
def test_packed_backend_raises_when_input_needs_grad(op):
    """The packed kernels have no adjoint: an input that needs a gradient
    raises (the wrapper checks this before it picks the CPU plain version or
    the card's kernel), instead of a result without a gradient; under
    ``torch.no_grad()`` the same call runs."""
    rng, dst, mask = _edges(200, 50, 2)
    x = torch.as_tensor(rng.normal(size=(200, 4)), dtype=torch.float32)
    d, m = torch.as_tensor(dst), torch.as_tensor(mask)
    fn = getattr(segment_ops, op)
    with pytest.raises(RuntimeError, match="forward only"):
        fn(x.clone().requires_grad_(), d, m, 50, backend="packed")
    with torch.no_grad():
        got = fn(x.clone().requires_grad_(), d, m, 50, backend="packed")
    assert torch.equal(got, fn(x, d, m, 50, backend="packed"))
    # the torch backend, what the model calls, keeps its gradient
    assert fn(x.clone().requires_grad_(), d, m, 50).requires_grad
