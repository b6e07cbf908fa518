"""The plain reference of a GNN training step: keyed neighbour sampling in
numpy, the unsplit mini-batch's GraphSAGE or GAT forward in plain torch, the
mean cross-entropy over the batch's targets, autograd, and Adam.

It imports neither JAX nor anything of the program. What it shares with the
program is the statement of the work: the graph's arrays, the initial
weights, the seed, and the sampling contract the program documents (draws
keyed by ``(seed, salt, epoch, batch[, micro])``; GraphSAGE sampling: every
in-edge of a vertex whose degree is at most the fan-out, else ``fanout``
uniform draws with replacement, de-duplicated; a self loop for a vertex
with no in-edge). A split step computes what this unsplit mini-batch
computes; a dp step is ``P`` independent micro-batches whose losses are
averaged over all their targets.

``precision="tf32"`` rounds both operands of every dense product to TF32
(10 mantissa bits, round to nearest, ties away) in the forward and the
backward, as a TF32 tensor-core product does: the control that has to come
out as not correct. ``precision="float64"`` computes everything in double,
a witness of which of two float32 results lies nearer the exact one.
"""
from __future__ import annotations

import numpy as np
import torch

EPOCH_SALT = 0x9E7
SAMPLE_SALT = 0x5A3


# ---- sampling -------------------------------------------------------------
def epoch_targets(train_ids, batch_size: int, seed: int, epoch: int) -> list:
    """The epoch's target batches: a keyed permutation of the train ids cut
    into full batches (the remainder dropped)."""
    ids = np.random.default_rng((seed, EPOCH_SALT, epoch)).permutation(
        np.asarray(train_ids, dtype=np.int64))
    if ids.shape[0] <= batch_size:
        return [ids]
    stop = ids.shape[0] - ids.shape[0] % batch_size
    return [ids[i:i + batch_size] for i in range(0, stop, batch_size)]


def _sample_hop(indptr, indices, frontier, fanout, rng):
    """(src, dst) global ids of the sampled in-edges of ``frontier``."""
    srcs, dsts = [], []
    deg = indptr[frontier + 1] - indptr[frontier]
    whole = frontier[(deg > 0) & (deg <= fanout)]
    if whole.size:
        d = deg[(deg > 0) & (deg <= fanout)]
        first = np.repeat(indptr[whole], d)
        offs = np.arange(int(d.sum())) - np.repeat(np.cumsum(d) - d, d)
        srcs.append(indices[first + offs].astype(np.int64))
        dsts.append(np.repeat(whole, d))
    big = deg > fanout
    if big.any():
        v = frontier[big]
        slots = (rng.random((v.size, fanout)) * deg[big][:, None]).astype(np.int64)
        edge = (indptr[v][:, None] + slots).reshape(-1)
        dst = np.repeat(v, fanout)
        keep = np.unique(dst * (indices.shape[0] + 1) + edge, return_index=True)[1]
        srcs.append(indices[edge[keep]].astype(np.int64))
        dsts.append(dst[keep])
    lone = frontier[deg == 0]
    srcs.append(lone.astype(np.int64))
    dsts.append(lone.astype(np.int64))
    return np.concatenate(srcs), np.concatenate(dsts)


def sample(indptr, indices, targets, fanouts, rng) -> dict:
    """A k-hop sample: ``frontiers[0]`` the sorted targets, ``frontiers[k]``
    the vertices k hops down, ``hops[k]`` the (src, dst) edges from depth
    k + 1 into depth k."""
    frontiers = [np.unique(np.asarray(targets, dtype=np.int64))]
    hops = []
    for fanout in fanouts:
        src, dst = _sample_hop(indptr, indices, frontiers[-1], fanout, rng)
        hops.append((src, dst))
        frontiers.append(np.unique(np.concatenate([frontiers[-1], src])))
    return {"frontiers": frontiers, "hops": hops}


def step_samples(graph, traffic: dict, seed: int, epoch: int, index: int,
                 targets) -> list:
    """The samples one step trains on: one for a split step, ``P``
    micro-batches for a dp step."""
    fanouts = list(traffic["fanouts"])
    if traffic["mode"] == "split":
        rng = np.random.default_rng((seed, SAMPLE_SALT, epoch, index))
        return [sample(graph.indptr, graph.indices, targets, fanouts, rng)]
    return [
        sample(graph.indptr, graph.indices, part, fanouts,
               np.random.default_rng((seed, SAMPLE_SALT, epoch, index, i)))
        for i, part in enumerate(np.array_split(targets, traffic["num_devices"]))
    ]


# ---- the model ------------------------------------------------------------
def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _TF32Product(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        a, b = _round_tf32(a), _round_tf32(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_tf32(g)
        return g @ b.T, a.T @ g


def product(a, b, precision: str):
    """``a @ b`` for 2-d operands, in float32 or in TF32."""
    if precision == "tf32":
        return _TF32Product.apply(a, b)
    return a @ b


def _positions(sorted_ids, ids, device):
    return torch.as_tensor(np.searchsorted(sorted_ids, ids), device=device)


def forward(model: dict, params: dict, smp: dict, features: torch.Tensor,
            precision: str = "float32") -> torch.Tensor:
    """Logits of ``smp``'s sorted targets. ``features`` holds the rows of the
    sample's input vertices (``frontiers[-1]``)."""
    L = len(smp["hops"])
    fr = smp["frontiers"]
    h = features
    dev, dt = h.device, h.dtype
    for k in range(L):
        depth = L - k  # sources at this depth, destinations one above
        src, dst = smp["hops"][depth - 1]
        s = _positions(fr[depth], src, dev)
        d = _positions(fr[depth - 1], dst, dev)
        me = _positions(fr[depth], fr[depth - 1], dev)
        n_out = fr[depth - 1].shape[0]
        p = {name: params[f"layers.{k}.{name}"] for name in model["leaves"][k]}
        if model["kind"] == "sage":
            count = torch.zeros(n_out, device=dev, dtype=dt).index_add_(
                0, d, torch.ones_like(d, dtype=dt))
            agg = torch.zeros(n_out, h.shape[1], device=dev, dtype=dt).index_add(
                0, d, h[s]) / count[:, None]
            out = (product(h[me], p["w_self"], precision)
                   + product(agg, p["w_neigh"], precision) + p["b"])
        else:  # gat
            w = p["w"]
            heads, dh = w.shape[1], w.shape[2]
            wh = product(h, w.reshape(w.shape[0], heads * dh), precision)
            wh = wh.reshape(-1, heads, dh)
            score_src = (wh * p["a_src"]).sum(-1)
            score_dst = (wh[me] * p["a_dst"]).sum(-1)
            e = torch.nn.functional.leaky_relu(score_src[s] + score_dst[d], 0.2)
            top = torch.full((n_out, heads), -torch.inf, device=dev, dtype=dt)
            top = top.scatter_reduce(0, d[:, None].expand(-1, heads), e, "amax")
            x = torch.exp(e - top[d])
            total = torch.zeros(n_out, heads, device=dev, dtype=dt).index_add(0, d, x)
            alpha = x / total[d]
            agg = torch.zeros(n_out, heads, dh, device=dev, dtype=dt).index_add(
                0, d, alpha[:, :, None] * wh[s])
            out = agg.reshape(n_out, heads * dh) + p["b"]
        h = torch.relu(out) if k < L - 1 else out
    return h


def loss_of(model, params, samples, graph, precision, device):
    """Mean cross-entropy over every target of the step's samples."""
    dtype = torch.float64 if precision == "float64" else torch.float32
    total = torch.zeros((), device=device, dtype=dtype)
    count = 0
    for smp in samples:
        feats = torch.as_tensor(graph.features[smp["frontiers"][-1]], device=device,
                                dtype=dtype)
        logits = forward(model, params, smp, feats, precision)
        labels = torch.as_tensor(graph.labels[smp["frontiers"][0]],
                                 device=device).long()
        nll = torch.nn.functional.cross_entropy(logits, labels, reduction="none")
        total = total + nll.sum()
        count += nll.shape[0]
    return total / count


def train_steps(model: dict, init: dict, graph, traffic: dict, seed: int,
                keys: list, device, precision: str = "float32") -> dict:
    """Adam steps from ``init`` on the batches ``keys`` ((epoch, index)
    pairs), the reference's side of the check. Returns each step's loss, each
    leaf's first gradient and the leaves' change after the last step (all
    float64 norms), and the leaves' names."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    lr, b1, b2, eps = traffic["lr"], 0.9, 0.999, 1e-8
    names = list(init)
    dtype = torch.float64 if precision == "float64" else torch.float32
    params = {n: init[n].detach().to(device, dtype).clone().requires_grad_(True)
              for n in names}
    m = {n: torch.zeros_like(params[n]) for n in names}
    v = {n: torch.zeros_like(params[n]) for n in names}
    batch_size = traffic["batch_size"]
    orders: dict = {}
    losses, first_grad = [], None
    for t, (epoch, index) in enumerate(keys, start=1):
        if epoch not in orders:
            orders[epoch] = epoch_targets(graph.train_ids, batch_size, seed, epoch)
        samples = step_samples(graph, traffic, seed, epoch, index,
                               orders[epoch][index])
        loss = loss_of(model, params, samples, graph, precision, device)
        grads = torch.autograd.grad(loss, [params[n] for n in names])
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = [float(g.double().norm()) for g in grads]
        with torch.no_grad():
            for n, g in zip(names, grads):
                m[n].mul_(b1).add_((1 - b1) * g)
                v[n].mul_(b2).add_((1 - b2) * g * g)
                m_hat = m[n] / (1 - b1 ** t)
                v_hat = v[n] / (1 - b2 ** t)
                params[n] -= lr * m_hat / (v_hat.sqrt() + eps)
    change = [float((params[n].detach() - init[n].to(device, dtype)).double().norm())
              for n in names]
    return {"names": names, "losses": losses, "first_grad": first_grad,
            "change": change}
