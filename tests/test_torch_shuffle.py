"""The sim shuffle's adjoint: the port's plain version against JAX.

The port's ``sim_shuffle`` runs its send gather through
``kernels/shuffle/ops.send_gather``, whose adjoint is the CUDA kernel
``csrc/shuffle_bwd.cu`` on a card and its plain version
(``kernels/shuffle/ref.shuffle_bwd``) on a CPU tensor. The plain version
sums each local row's cotangent over the needers in ascending order from
+0.0 and skips the padding slots. The GNN layers' self-row gather
(``ops.self_gather``) is the same op with one group, and is held the same
way against JAX's ``mixed[self_pos]`` per split. Here, on the CPU, the same seeded numpy
inputs go through ``jax.vjp`` of the JAX package's ``sim_shuffle`` and
through torch autograd of the port's; the two gradients must be bitwise
equal (``torch.equal``), on plans from ``build_split_plan`` (the tiny graph,
and papers-s at 15,15 fan-outs) and on a papers-s-shaped random plan with
S = 1024. The padding rows of the received block get zero cotangents, as on
every training path: the row adjoint never addresses them. The kernel itself
is held bitwise against the plain version in ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_split_plan
from repro.core.shuffle import sim_shuffle as jax_sim_shuffle
from repro.graph.datasets import make_dataset
from repro.graph.sampling import sample_minibatch
from repro_torch.core.shuffle import sim_shuffle
from repro_torch.kernels.shuffle import kernel, ref, self_gather


def _plans():
    """(name, send_idx, send_count, n_local, self_pos, dst_count) of every
    layer of two real plans: the tiny graph at fan-outs 4,4 and papers-s at
    15,15 (256 targets), split over 4 devices by a seeded random
    assignment."""
    out = []
    for name, fan, batch in (("tiny", [4, 4], 32), ("papers-s", [15, 15], 256)):
        ds = make_dataset(name)
        rng = np.random.default_rng(0)
        mb = sample_minibatch(ds.graph, ds.train_ids[:batch], fan, rng)
        assign = rng.integers(0, 4, ds.graph.num_nodes).astype(np.int32)
        plan = build_split_plan(mb, assign, 4)
        for li, lp in enumerate(plan.layers):
            out.append((f"{name}, layer {li}", lp.send_idx, lp.send_count,
                        lp.n_local, lp.self_pos, plan.node_count[li]))
    return out


@pytest.fixture(scope="module")
def plans():
    return _plans()


def _random_plan(seed, P=4, N=4096, S=1024, padding="zero"):
    """A papers-s-shaped plan: each pair's valid slots hold distinct rows in
    ascending order; the diagonal and a random off-diagonal pair send
    nothing; ``padding`` fills the padding slots with row 0 (as the plan
    does) or with random rows."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, S + 1, size=(P, P)).astype(np.int32)
    count[np.arange(P), np.arange(P)] = 0
    count[0, P - 1] = 0
    count[1, 2] = S  # a full pair
    idx = np.zeros((P, P, S), dtype=np.int32)
    if padding == "random":
        idx = rng.integers(0, N, size=(P, P, S)).astype(np.int32)
    for q in range(P):
        for p in range(P):
            c = count[q, p]
            rows = np.sort(rng.choice(N, size=c, replace=False))
            if c and q == 2:
                rows[0] = 0  # a valid slot whose row is 0
                rows = np.unique(rows)
                while rows.size < c:
                    rows = np.unique(np.append(rows, rng.integers(1, N)))
            idx[q, p, :c] = rows
    return idx, count, N


def _inputs(send_idx, send_count, n_local, F, seed):
    """h (P, N, F) and a cotangent of the mixed buffer whose padding receive
    rows are zero."""
    P, _, S = send_idx.shape
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(P, n_local, F)).astype(np.float32)
    cot = rng.normal(size=(P, n_local + P * S, F)).astype(np.float32)
    for p in range(P):
        for q in range(P):
            lo = n_local + q * S + send_count[q, p]
            cot[p, lo:n_local + (q + 1) * S] = 0.0
    return h, cot


def _jax_grad(h, send_idx, cot, wire_dtype=None):
    _, vjp = jax.vjp(
        lambda x: jax_sim_shuffle(x, jnp.asarray(send_idx), wire_dtype), jnp.asarray(h)
    )
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _port_grad(h, send_idx, send_count, cot, wire_dtype=None):
    ht = torch.tensor(h, requires_grad=True)
    mixed = sim_shuffle(ht, torch.as_tensor(send_idx), wire_dtype,
                        send_count=torch.as_tensor(send_count))
    mixed.backward(torch.as_tensor(cot))
    return ht.grad


def _assert_bitwise(got: torch.Tensor, want: np.ndarray):
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.as_tensor(want)), float(
        (got - torch.as_tensor(want)).abs().max())


def test_plans_send_ascending_rows(plans):
    """The kernel's precondition: within each (owner, needer) pair the valid
    slots hold distinct rows in ascending order, and every padding slot
    holds row 0."""
    for name, idx, count, *_ in plans:
        P = idx.shape[0]
        assert count.sum() > 0, name
        for q in range(P):
            for p in range(P):
                c = count[q, p]
                assert np.all(np.diff(idx[q, p, :c]) > 0), (name, q, p)
                assert np.all(idx[q, p, c:] == 0), (name, q, p)


@pytest.mark.parametrize("F", [64, 13])
def test_plain_adjoint_equals_jax_vjp_on_split_plans(plans, F):
    for li, (name, idx, count, n_local, *_) in enumerate(plans):
        h, cot = _inputs(idx, count, n_local, F, seed=li)
        _assert_bitwise(_port_grad(h, idx, count, cot), _jax_grad(h, idx, cot))


def test_plans_self_rows_ascending(plans):
    """``self_gather``'s precondition: each split's valid destinations (the
    first ``dst_count`` rows) sit at distinct ascending mixed rows, and the
    padding destinations at row 0."""
    for name, _, _, _, self_pos, dst_count in plans:
        for p in range(self_pos.shape[0]):
            c = dst_count[p]
            assert c > 0, name
            assert np.all(np.diff(self_pos[p, :c]) > 0), (name, p)
            assert np.all(self_pos[p, c:] == 0), (name, p)


@pytest.mark.parametrize("F", [64, 13])
def test_self_gather_adjoint_equals_jax_vjp(plans, F):
    """The self rows' adjoint against ``jax.vjp`` of the reference layers'
    ``mixed[self_pos]`` (one split at a time), with the padding
    destinations' cotangents zero, as on every training path."""
    for li, (name, _, _, n_local, self_pos, dst_count) in enumerate(plans):
        P, N = self_pos.shape
        rng = np.random.default_rng(10 + li)
        M = n_local + 7  # receive rows beyond the local block take nothing
        mixed = rng.normal(size=(P, M, F)).astype(np.float32)
        cot = rng.normal(size=(P, N, F)).astype(np.float32)
        cot[np.arange(N)[None, :] >= dst_count[:, None]] = 0.0
        want = np.stack([
            np.asarray(jax.vjp(lambda m: m[jnp.asarray(self_pos[p])],
                               jnp.asarray(mixed[p]))[1](jnp.asarray(cot[p]))[0])
            for p in range(P)])
        mt = torch.tensor(mixed, requires_grad=True)
        out = self_gather(mt, torch.as_tensor(self_pos), torch.as_tensor(dst_count))
        assert torch.equal(out, torch.as_tensor(mixed[np.arange(P)[:, None], self_pos]))
        out.backward(torch.as_tensor(cot))
        _assert_bitwise(mt.grad, want)


@pytest.mark.parametrize("padding", ["zero", "random"])
def test_plain_adjoint_equals_jax_vjp_on_a_papers_shaped_plan(padding):
    idx, count, N = _random_plan(1, padding=padding)
    h, cot = _inputs(idx, count, N, 64, seed=2)
    _assert_bitwise(_port_grad(h, idx, count, cot), _jax_grad(h, idx, cot))


def test_plain_adjoint_on_the_bf16_wire():
    """The wire cast stays outside the send gather: its adjoint rounds the
    cotangent to bf16 in both packages."""
    idx, count, N = _random_plan(3, N=512, S=128)
    h, cot = _inputs(idx, count, N, 32, seed=4)
    _assert_bitwise(_port_grad(h, idx, count, cot, "bfloat16"),
                    _jax_grad(h, idx, cot, "bfloat16"))


def test_plain_adjoint_against_torch_autograd_of_the_gather():
    """The plain adjoint against torch's own adjoint of the same gather
    (``index_put_`` with accumulate, every padding slot included) on a
    zero-padded cotangent. Torch on the CPU sums the duplicates of a row in
    another order than the needers' ascending order, so the two agree to
    rtol 1e-6 rather than bit for bit."""
    idx, count, N = _random_plan(5)
    P, _, S = idx.shape
    rng = np.random.default_rng(6)
    g = rng.normal(size=(P, P, S, 48)).astype(np.float32)
    g[np.arange(S)[None, None, :] >= count[:, :, None]] = 0.0
    h = torch.zeros(P, N, 48, requires_grad=True)
    owner = torch.arange(P)[:, None, None]
    h[owner, torch.as_tensor(idx).long()].backward(torch.as_tensor(g))
    got = ref.shuffle_bwd(torch.as_tensor(g), torch.as_tensor(idx),
                          torch.as_tensor(count), N)
    torch.testing.assert_close(got, h.grad, rtol=1e-6, atol=1e-6)


def test_plain_adjoint_edge_cases():
    """A pair that sends nothing, a valid slot whose row is 0 beside
    padding slots that also hold 0, a row sent to every needer, and a
    cotangent of -0.0 (the sum starts at +0.0)."""
    P, N, S, F = 3, 5, 4, 2
    idx = np.zeros((P, P, S), dtype=np.int32)
    count = np.zeros((P, P), dtype=np.int32)
    idx[0, 1, :2], count[0, 1] = [0, 3], 2  # row 0 valid; slots 2, 3 padding
    idx[0, 2, :1], count[0, 2] = [3], 1
    idx[1, 0, :4], count[1, 0] = [0, 1, 2, 4], 4  # a full pair
    idx[2, 0, :1], count[2, 0] = [1], 1
    g = np.arange(P * P * S * F, dtype=np.float32).reshape(P, P, S, F) + 1
    g[0, 2, 0] = -0.0
    g[2, 0, 0] = -0.0  # row 1 of owner 2 gets only a -0.0
    got = kernel.shuffle_bwd(torch.as_tensor(g), torch.as_tensor(idx),
                             torch.as_tensor(count), N)
    want = np.zeros((P, N, F), dtype=np.float32)
    want[0, 0] = g[0, 1, 0]
    want[0, 3] = g[0, 1, 1] + 0.0  # + the -0.0 from needer 2
    want[1, [0, 1, 2, 4]] = g[1, 0]
    want[2, 1] = 0.0
    assert torch.equal(got, torch.as_tensor(want))
    assert not torch.signbit(got).any()  # no -0.0: sums start at +0.0
    assert kernel.LAUNCHES["shuffle_bwd"] == 0  # the CPU ran the plain version


def test_empty_send_passes_the_gradient_through():
    h = torch.randn(2, 6, 3, requires_grad=True)
    out = sim_shuffle(h, torch.zeros(2, 2, 0, dtype=torch.int32),
                      send_count=torch.zeros(2, 2, dtype=torch.int32))
    assert out is h


def test_send_count_is_required():
    h = torch.randn(2, 6, 3, requires_grad=True)
    idx = torch.zeros(2, 2, 4, dtype=torch.int32)
    with pytest.raises(TypeError, match="send_count"):
        sim_shuffle(h, idx)
    with torch.no_grad():
        out = sim_shuffle(h, idx, send_count=torch.zeros(2, 2, dtype=torch.int32))
    assert out.shape == (2, 6 + 8, 3)


def test_wrapper_checks_its_inputs():
    g = torch.zeros(2, 2, 4, 3)
    idx = torch.zeros(2, 2, 4, dtype=torch.int32)
    count = torch.zeros(2, 2, dtype=torch.int32)
    with pytest.raises(TypeError):
        kernel.shuffle_bwd(g.double(), idx, count, 5)
    with pytest.raises(TypeError):
        kernel.shuffle_bwd(g, idx.long(), count, 5)
    with pytest.raises(ValueError):
        kernel.shuffle_bwd(g, idx[:, :, :3].contiguous(), count, 5)
    with pytest.raises(ValueError):
        kernel.shuffle_bwd(g.transpose(0, 1), idx, count, 5)
