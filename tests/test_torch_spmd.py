"""The spmd form of split parallelism in the port (``repro_torch.launch``),
held on the CPU with gloo against the port's sim form and the JAX package.

Everything that needs ranks runs in ONE launch of four gloo ranks (a module
fixture, with its own time limit): the 1-D mesh at P = 4 and the 2 x 2
(replica, split) mesh, whose split groups exchange at P = 2. Beside it, in
one subprocess with four forced XLA host devices (as ``tests/test_spmd.py``
runs them), the JAX package's ``gnn_forward_spmd`` and
``sample_minibatch_spmd`` under ``shard_map``, on the same arrays.

* Primitives: ``spmd_alltoall`` (fp32, int32 ids), ``spmd_shuffle`` (with
  its ``send_count``), ``spmd_append_replicated`` and
  ``spmd_serve_features`` on each rank equal split p of the sim form bit
  for bit in fp32, forward and adjoint; a bf16 wire within 5e-2;
  ``replica_grad_mean`` at R = 2 is the sim mesh's ``(g0 + g1) / 2`` bit
  for bit (a sum of two terms has one order).
* ``gnn_forward_spmd`` (through ``spmd_step_grads``): SAGE, GCN and GAT,
  blocking and overlap at 1 and 3 chunks, with the cache and with the
  replicated block. Logits within rtol 1e-6 of the port's ``gnn_forward``
  and of the JAX spmd forward, with an atol of 1e-6 of the reference's
  largest logit (the port's own sim forward lies 2e-6 to 6e-6 off JAX's
  in absolute terms, at logits of 6 to 29); the masked-xent gradients
  within 3e-4 of the JAX sim gradients (jax 0.9.0 cannot differentiate
  through ``shard_map``).
* Trajectories: 3 steps of ``SpmdTrainer`` within 1e-4 of the port's sim
  ``Trainer`` at P = 4 and on the 2 x 2 mesh (``num_replicas=2``); every
  rank ends with the same parameters. They need not be bitwise: the
  P-way sum of per-rank gradient terms reassociates the sim form's
  batched sum (the replica mean of two terms is bitwise, above; SAGE on
  the 2 x 2 mesh came out bitwise here, SAGE at P = 4 and GAT did not).
* Sampler: ``sample_minibatch_spmd``'s fronts, counts and edges bitwise the
  sim ``_sample_device``'s split p, and the JAX spmd sampler's; a forced
  overflow on one rank makes every rank discard the batch, and the next
  batch runs (no hang).
"""
import os
import subprocess
import sys
import tempfile
import textwrap
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.core.shuffle import sim_shuffle as j_sim_shuffle
from repro.models.gnn import GNNSpec as JGNNSpec
from repro.models.gnn import init_gnn_params
from repro.models.gnn.layers import gnn_forward as j_gnn_forward
from repro.models.gnn.layers import gnn_forward_cached as j_gnn_forward_cached
from repro.train.loss import masked_softmax_xent as j_xent
from repro_torch.core import build_split_plan, partition_graph, presample
from repro_torch.core import repad_plan
from repro_torch.core.shuffle import (
    SimComm,
    sim_alltoall,
    sim_append_replicated,
    sim_serve_features,
    sim_shuffle,
)
from repro_torch.graph.cache import FeatureCache
from repro_torch.graph.datasets import make_dataset
from repro_torch.graph.sampling import NeighborSampler, sample_minibatch
from repro_torch.launch import spmd
from repro_torch.launch.sharding import make_split_mesh, split_slice
from repro_torch.models.gnn import GNNSpec, gnn_forward, gnn_forward_cached
from repro_torch.models.gnn import params_from_jax
from repro_torch.models.gnn.layers import _gnn_layer_overlap
from repro_torch.runtime.plan_source import PlanBatch
from repro_torch.sampler import DeviceSampler
from repro_torch.sampler.engine import _sample_device, to_host
from repro_torch.train import plan_io
from repro_torch.train.loss import masked_softmax_xent
from repro_torch.train.trainer import TrainConfig, Trainer
from test_torch_spmd_ranks import PRIMITIVE_LEAVES, exchange_rank, grads_rank

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
FANOUTS = [3, 3]
MODELS = ("sage", "gcn", "gat")
#: the forward variants at P = 4: (overlap chunks or 0 for blocking, cache,
#: replicated block)
VARIANTS = {
    "blocking": (0, False, False),
    "overlap1": (1, False, False),
    "overlap3": (3, False, False),
    "cache": (0, True, False),
    "cache_overlap3": (3, True, False),
    "rep": (0, False, True),
    "rep_overlap3": (3, False, True),
}
FWD_CASES = [f"p4-{m}-{v}" for m in MODELS for v in VARIANTS] + [
    f"mesh-{m}-{v}" for m in MODELS for v in ("blocking", "overlap3")]
#: the cases held against the JAX package (its spmd forward, its sim
#: gradients): each model blocking and overlapped at 3 chunks, the cache and
#: the replicated block blocking (SAGE) and overlapped (GAT), the mesh
JAX_CASES = [f"p4-{m}-{v}" for m in MODELS for v in ("blocking", "overlap3")
             ] + ["p4-sage-cache", "p4-gat-cache_overlap3", "p4-sage-rep",
                  "p4-gat-rep_overlap3", "mesh-sage-blocking",
                  "mesh-gcn-blocking", "mesh-gat-blocking",
                  "mesh-gat-overlap3"]
GRAD_TOL = dict(rtol=3e-4, atol=3e-5)
WIRE_TOL = dict(rtol=5e-2, atol=5e-2)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-6)
#: each launch's and subprocess's own limit (s)
LIMIT_S = 240


def fwd_close(got, want):
    """rtol 1e-6, atol 1e-6 of the reference's largest entry."""
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))


# --------------------------------------------------------------------- #
# inputs
# --------------------------------------------------------------------- #
def _spec(ds, model, chunks=0):
    return GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                   out_dim=4, num_layers=2, num_heads=2,
                   overlap=chunks > 0, shuffle_chunks=max(chunks, 1))


def _plans(ds, assignment, P, replication=None, parts=1):
    """``parts`` plans (a mesh's replica parts) of 16 targets each,
    repadded (twice, to shared marks) after a larger one: grown, rebased
    layouts."""
    big = sample_minibatch(ds.graph, ds.train_ids[:48], FANOUTS,
                           np.random.default_rng(3))
    small = [sample_minibatch(ds.graph,
                              ds.train_ids[16 * r:16 * (r + 1)], FANOUTS,
                              np.random.default_rng(r)) for r in range(parts)]
    plans = [build_split_plan(mb, assignment, P, with_halves=True,
                              replication=replication)
             for mb in [big] + small]
    hwm: dict = {}
    for _ in range(2):
        for p in plans:
            repad_plan(p, hwm)
    return plans[1:]


def _part(ds, plan, cache=None):
    cp = None if cache is None else cache.build_plan(plan)
    feats = (plan_io.gather_features(plan, ds.features) if cp is None
             else plan_io.gather_miss_features(cp, ds.features))
    return PlanBatch(index=0, epoch=0, plan=plan, feats=feats,
                     labels=plan_io.load_labels(plan, ds.labels), t_sample=0.0,
                     t_split=0.0, t_load=0.0, cache_plan=cp)


def _jax_params(ds, model):
    params = init_gnn_params(jax.random.PRNGKey(0), JGNNSpec(
        model=model, in_dim=ds.spec.feat_dim, hidden_dim=16, out_dim=4,
        num_layers=2, num_heads=2))
    return [{k: np.asarray(v) for k, v in d.items()} for d in params]


def _sim(spec, np_params, parts, cache_block=None, rep_block=None):
    """The port's sim form on each part: logits, and the masked-xent
    gradients averaged over the parts (the sim mesh step's)."""
    gnn = params_from_jax(np_params, spec, "cpu")
    logits, grads = [], None
    R = len(parts)
    for part in parts:
        feats, pa, labels = plan_io.stage_batch(
            part.plan, part.feats, part.labels, "cpu", part.cache_plan,
            with_halves=spec.overlap,
            num_replicated=0 if rep_block is None else rep_block.shape[0])
        if part.cache_plan is not None:
            out = gnn_forward_cached(spec, list(gnn.layers), cache_block,
                                     feats, pa, rep_block=rep_block)
        else:
            out = gnn_forward(spec, list(gnn.layers), feats, pa,
                              rep_block=rep_block)
        loss = masked_softmax_xent(out, labels, pa["target_mask"])
        g = torch.autograd.grad(loss, list(gnn.parameters()))
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        logits.append(out.detach().numpy())
    if R > 1:
        grads = [g / R for g in grads]
    return logits, [g.numpy() for g in grads]


def _staged_np(part, spec, rep_block):
    """The staged plan dict, features and labels as numpy, for JAX."""
    feats, pa, labels = plan_io.stage_batch(
        part.plan, part.feats, part.labels, "cpu", part.cache_plan,
        with_halves=spec.overlap,
        num_replicated=0 if rep_block is None else rep_block.shape[0])
    flat = {"feats": feats.numpy(), "labels": labels.numpy(),
            "target_mask": pa["target_mask"].numpy()}
    for i, lp in enumerate(pa["layers"]):
        for k, v in lp.items():
            flat[f"layers/{i}/{k}"] = v.numpy()
    for k, v in pa.get("cache", {}).items():
        flat[f"cache/{k}"] = v.numpy()
    return flat


def _unflat(flat, num_layers):
    pa = {"layers": [{} for _ in range(num_layers)], "cache": {}}
    for k, v in flat.items():
        head, _, rest = k.partition("/")
        if head == "layers":
            i, _, key = rest.partition("/")
            pa["layers"][int(i)][key] = jnp.asarray(v)
        elif head == "cache":
            pa["cache"][rest] = jnp.asarray(v)
        else:
            pa[k] = jnp.asarray(v)
    if not pa["cache"]:
        del pa["cache"]
    return pa


# --------------------------------------------------------------------- #
# the JAX spmd subprocess
# --------------------------------------------------------------------- #
JAX_SCRIPT = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import PartitionSpec as P
    from jax.experimental.shard_map import shard_map
    from repro.graph.datasets import make_dataset
    from repro.graph.sampling import NeighborSampler
    from repro.launch.sharding import make_split_mesh, sampler_shard_specs
    from repro.models.gnn import GNNSpec
    from repro.models.gnn.layers import gnn_forward_spmd
    from repro.sampler import DeviceSampler, sample_minibatch_spmd

    inp = np.load(sys.argv[1], allow_pickle=True)
    meta = inp["meta"].item()
    out = {}

    def tree(prefix):
        pa = {"layers": [{}, {}], "cache": {}}
        n = len(prefix)
        for k in inp.files:
            if not k.startswith(prefix):
                continue
            rest = k[n:]
            head, _, tail = rest.partition("/")
            if head == "layers":
                i, _, key = tail.partition("/")
                pa["layers"][int(i)][key] = jnp.asarray(inp[k])
            elif head == "cache":
                pa["cache"][tail] = jnp.asarray(inp[k])
            elif head in ("target_mask",):
                pa[head] = jnp.asarray(inp[k])
        if not pa["cache"]:
            del pa["cache"]
        return pa

    for case, c in meta["cases"].items():
        spec = GNNSpec(model=c["model"], in_dim=c["in_dim"], hidden_dim=16,
                       out_dim=4, num_layers=2, num_heads=2,
                       agg_backend="jnp", overlap=c["chunks"] > 0,
                       shuffle_chunks=max(c["chunks"], 1))
        params = [{k: jnp.asarray(inp[f"{case}/params/{i}/{k}"])
                   for k in c["param_keys"][i]} for i in range(2)]
        rep = (jnp.asarray(inp[f"{case}/rep_block"]) if c["rep"] else None)
        cached = c["cache"]
        if c["mesh"]:
            pas = [tree(f"{case}/part{r}/") for r in range(2)]
            feats = jnp.stack([jnp.asarray(inp[f"{case}/part{r}/feats"])
                               for r in range(2)])
            pa = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pas)
            mesh = make_split_mesh(2, 2)
            def body(f, p):
                p = jax.tree_util.tree_map(lambda x: x[0, 0], p)
                return gnn_forward_spmd(spec, params, f[0, 0], p, "split",
                                        rep_block=rep)[None, None]
            fn = shard_map(body, mesh=mesh,
                           in_specs=(P("replica", "split"),
                                     P("replica", "split")),
                           out_specs=P("replica", "split"),
                           check_rep=False)
            got = jax.jit(fn)(feats, pa)
        else:
            pa = tree(f"{case}/part0/")
            feats = jnp.asarray(inp[f"{case}/part0/feats"])
            cache = (jnp.asarray(inp[f"{case}/cache_block"]) if cached
                     else jnp.zeros((4, 1, 1), jnp.float32))
            mesh = jax.make_mesh((4,), ("model",))
            def body(f, p, cb):
                p = jax.tree_util.tree_map(lambda x: x[0], p)
                return gnn_forward_spmd(
                    spec, params, f[0], p, "model",
                    cache_local=cb[0] if cached else None,
                    rep_block=rep)[None]
            fn = shard_map(body, mesh=mesh,
                           in_specs=(P("model"), P("model"), P("model")),
                           out_specs=P("model"), check_rep=False)
            got = jax.jit(fn)(feats, pa, cache)
        out[case] = np.asarray(got)

    # the spmd sampler on the same graph, partition, seed and caps
    s = meta["sampler"]
    ds = make_dataset("tiny")
    host = NeighborSampler(ds.graph, ds.train_ids, s["fanouts"], 32,
                           seed=s["seed"])
    eng = DeviceSampler(ds.graph, inp["sampler/assignment"], 4, s["fanouts"],
                        s["seed"], host, backend="jnp")
    caps = tuple((k, int(v)) for k, v in s["caps"])
    mesh = jax.make_mesh((4,), ("model",))
    specs = sampler_shard_specs(eng._dev)
    tpad = jnp.asarray(inp["sampler/targets"])
    keys = jnp.asarray(inp["sampler/keys"])
    def body(dev):
        dev_local = {k: (v[0] if specs[k][0] == "model" else v)
                     for k, v in dev.items()}
        fronts, counts, layers, flags = sample_minibatch_spmd(
            dev_local, tpad, jnp.int32(s["n_targets"]), keys, caps=caps,
            fanouts=tuple(s["fanouts"]), axis_name="model", num_parts=4,
            backend="jnp")
        return ([f[None] for f in fronts], [c[None] for c in counts],
                [{k: v[None] for k, v in l.items()} for l in layers])
    L = len(s["fanouts"])
    fn = shard_map(body, mesh=mesh, in_specs=(specs,),
                   out_specs=([P("model")] * (L + 1), [P("model")] * (L + 1),
                              [{k: P("model") for k in
                                ("dst", "src", "eid", "valid")}] * L),
                   check_rep=False)
    fronts, counts, layers = jax.jit(fn)(eng._dev)
    for d in range(L + 1):
        out[f"sampler/front{d}"] = np.asarray(fronts[d])
        out[f"sampler/count{d}"] = np.asarray(counts[d])
    for l in range(L):
        for k in ("dst", "src", "eid", "valid"):
            out[f"sampler/layer{l}/{k}"] = np.asarray(layers[l][k])
    np.savez(sys.argv[2], **out)
    print("OK")
""")


def _jax_sim(ds, model, spec, np_params, staged, cache_block, rep_block):
    """The JAX package's sim form on the staged parts: the masked-xent
    gradients averaged over the parts, in the port's parameter order."""
    jspec = JGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                     out_dim=4, num_layers=2, num_heads=2, agg_backend="jnp",
                     overlap=spec.overlap, shuffle_chunks=spec.shuffle_chunks)
    params = [{k: jnp.asarray(v) for k, v in d.items()} for d in np_params]
    rep = None if rep_block is None else jnp.asarray(rep_block)

    def loss(p):
        total = 0.0
        for flat in staged:
            pa = _unflat({k: v for k, v in flat.items()
                          if k not in ("feats", "labels")}, 2)
            if "cache" in pa:
                out = j_gnn_forward_cached(jspec, p, jnp.asarray(cache_block),
                                           jnp.asarray(flat["feats"]), pa,
                                           j_sim_shuffle, rep_block=rep)
            else:
                out = j_gnn_forward(jspec, p, jnp.asarray(flat["feats"]), pa,
                                    j_sim_shuffle, rep_block=rep)
            total = total + j_xent(out, jnp.asarray(flat["labels"]),
                                   pa["target_mask"])
        return total / len(staged)

    g = jax.jit(jax.grad(loss))(params)
    # the port's parameter order: ``GNN.parameters()``, layer by layer
    order = [list(layer.keys())
             for layer in params_from_jax(np_params, spec, "cpu").layers]
    return [np.asarray(layer[k]) for layer, ks in zip(g, order) for k in ks]


def _sim_primitive(op, x, wire):
    """A primitive's sim form on one replica's inputs: its output, and with
    ``x["cot"]`` the adjoint of <output, cot> w.r.t. its float inputs (the
    ones ``exchange_rank`` differentiates)."""
    x = {k: (v.detach().clone().requires_grad_(True)
             if k in PRIMITIVE_LEAVES and v.is_floating_point() else v)
         for k, v in x.items()}
    if op == "alltoall":
        y = sim_alltoall(x["send"], wire)
    elif op == "shuffle":
        y = sim_shuffle(x["h"], x["send_idx"], wire,
                        send_count=x["send_count"])
    elif op == "append":
        y = sim_append_replicated(x["rows"], x["rep"])
    else:
        y = sim_serve_features(x["cache_block"], x["cplan"], x["miss"], wire)
    grads = {}
    if x.get("cot") is not None:
        (y * x["cot"]).sum().backward()
        grads = {k: v.grad for k, v in x.items()
                 if isinstance(v, torch.Tensor) and v.requires_grad}
    return y.detach(), grads


def _primitive_cases(ds, plans, P, rep_block, cache=None, cache_block=None):
    """Sim-form inputs of every primitive, one set a replica (one plan
    each), each with a cotangent of its sim output. Named cases:
    ``(name, op, wire)``."""
    rng = np.random.default_rng(11 + P)
    specs = [("alltoall", "alltoall", None), ("alltoall_ids", "alltoall", None),
             ("alltoall_bf16", "alltoall", "bfloat16"),
             ("shuffle", "shuffle", None), ("shuffle_bf16", "shuffle",
                                            "bfloat16"),
             ("append", "append", None)]
    if cache is not None:
        specs.append(("serve", "serve", None))
    cases = []
    for name, op, wire in specs:
        inputs = []
        for plan in plans:
            lp = plan.layers[0]
            if name == "alltoall_ids":
                x = {"send": torch.as_tensor(rng.integers(
                    0, 1000, size=(P, P, 7)).astype(np.int32))}
            elif op == "alltoall":
                x = {"send": torch.as_tensor(rng.normal(
                    size=(P, P, 5, 6)).astype(np.float32))}
            elif op == "shuffle":
                x = {"h": torch.as_tensor(rng.normal(
                         size=(P, lp.n_local, 8)).astype(np.float32)),
                     "send_idx": torch.as_tensor(lp.send_idx),
                     "send_count": torch.as_tensor(lp.send_count)}
            elif op == "append":
                x = {"rows": torch.as_tensor(rng.normal(
                         size=(P, 9, 8)).astype(np.float32)),
                     "rep": rep_block[:5, :8].clone()}
            else:
                cp = cache.build_plan(plan)
                x = {"cache_block": cache_block.clone(),
                     "cplan": plan_io.cache_plan_to_device(cp, "cpu"),
                     "miss": plan_io.pad_rows(
                         plan_io.gather_miss_features(cp, ds.features),
                         cp.max_miss)}
            y, _ = _sim_primitive(op, x, wire)
            if y.is_floating_point():
                x["cot"] = torch.as_tensor(
                    rng.normal(size=tuple(y.shape)).astype(np.float32))
            inputs.append(x)
        cases.append({"name": name, "op": op, "wire": wire, "inputs": inputs})
    if len(plans) == 2:
        cases.append({"name": "replica_mean", "op": "replica_mean",
                      "wire": None, "inputs": [
                          {"grads": [torch.as_tensor(rng.normal(size=s).astype(
                              np.float32)) for s in ((3, 4), (4,), (2, 2, 5))]}
                          for _ in plans]})
    return cases


# --------------------------------------------------------------------- #
# the fixture: one launch of four gloo ranks and one JAX subprocess
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs():
    ds = make_dataset("tiny")
    w = presample(ds.graph, ds.train_ids, FANOUTS, 16, num_epochs=1)
    part4 = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    rep4 = partition_graph(ds.graph, 4, method="gsplit", weights=w,
                           replication_budget=0.1)
    part2 = partition_graph(ds.graph, 2, method="gsplit", weights=w)
    cache = FeatureCache(ds.graph.num_nodes, 4, 24, ranking=w.vertex_weight,
                         mode="distributed",
                         partition_assignment=part4.assignment)
    cache_block = torch.as_tensor(cache.build_resident(ds.features))
    rep_block = torch.as_tensor(
        ds.features[rep4.replication.vertices].astype(np.float32))
    plain4 = _plans(ds, part4.assignment, 4)[0]
    reped4 = _plans(ds, rep4.assignment, 4, replication=rep4.replication)[0]
    mesh_plans = _plans(ds, part2.assignment, 2, parts=2)

    # the forward cases: the port's and JAX's sim results here, the JAX spmd
    # forward's inputs for the subprocess
    cases, expect, jax_in, meta = [], {}, {}, {"cases": {}}
    for name in FWD_CASES:
        form, model, variant = name.split("-")
        np_params = _jax_params(ds, model)
        if form == "mesh":
            chunks, use_cache, use_rep = (3 if variant == "overlap3" else 0,
                                          False, False)
            parts = [_part(ds, p) for p in mesh_plans]
        else:
            chunks, use_cache, use_rep = VARIANTS[variant]
            parts = [_part(ds, reped4 if use_rep else plain4,
                           cache if use_cache else None)]
        spec = _spec(ds, model, chunks)
        cb = cache_block if use_cache else None
        rb = rep_block if use_rep else None
        logits, grads = _sim(spec, np_params, parts, cb, rb)
        expect[name] = {"logits": logits, "grads": grads}
        cases.append({"name": name, "spec": spec,
                      "model": params_from_jax(np_params, spec, "cpu"),
                      "parts": parts, "cache_block": cb, "rep_block": rb,
                      "with_halves": spec.overlap})
        if name not in JAX_CASES:
            continue
        staged = [_staged_np(p, spec, rb) for p in parts]
        expect[name]["jax_grads"] = _jax_sim(
            ds, model, spec, np_params, staged,
            None if cb is None else cb.numpy(),
            None if rb is None else rb.numpy())
        for r, flat in enumerate(staged):
            for k, v in flat.items():
                jax_in[f"{name}/part{r}/{k}"] = v
        for i, layer in enumerate(np_params):
            for k, v in layer.items():
                jax_in[f"{name}/params/{i}/{k}"] = v
        if cb is not None:
            jax_in[f"{name}/cache_block"] = cb.numpy()
        if rb is not None:
            jax_in[f"{name}/rep_block"] = rb.numpy()
        meta["cases"][name] = {
            "model": model, "in_dim": ds.spec.feat_dim, "chunks": chunks,
            "cache": use_cache, "rep": use_rep, "mesh": form == "mesh",
            "param_keys": [sorted(d) for d in np_params]}

    # the sampler: the port's device sampler on the CPU at P = 4; then a
    # C0 cap of 1 on rank 1 alone, then the first case again
    host = NeighborSampler(ds.graph, ds.train_ids, FANOUTS, 32, seed=7)
    eng = DeviceSampler(ds.graph, part4.assignment, 4, FANOUTS, 7, host,
                        device="cpu")
    targets = host.epoch_targets(0)[0]
    t_dev, keys = eng.device_inputs(targets, 0, 0)
    caps = eng.caps_tuple()
    sim_blocks = to_host(_sample_device(eng._dev, t_dev, len(targets), keys,
                                        caps=caps, fanouts=tuple(FANOUTS)))
    tight = tuple((k, 1 if k == "C0" else v) for k, v in caps)
    sample_case = {"shards": eng.shards, "targets": t_dev.numpy(),
                   "n_targets": len(targets), "layer_keys": keys.numpy(),
                   "fanouts": FANOUTS, "caps": caps}
    sample_cases = [sample_case,
                    {**sample_case, "caps": [caps, tight, caps, caps]},
                    sample_case]
    meta["sampler"] = {"fanouts": FANOUTS, "seed": 7, "caps": list(caps),
                       "n_targets": len(targets)}
    jax_in["sampler/assignment"] = part4.assignment
    jax_in["sampler/targets"] = t_dev.numpy()
    jax_in["sampler/keys"] = keys.numpy().astype(np.uint32)

    prim4 = _primitive_cases(ds, [plain4], 4, rep_block, cache, cache_block)
    prim22 = _primitive_cases(ds, mesh_plans, 2, rep_block)

    # the trajectories, and the port's sim Trainer on each
    traj = {}
    for key, R, P, model in (("p4", 0, 4, "sage"), ("mesh", 2, 2, "sage"),
                             ("mesh", 2, 2, "gat")):
        spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                       out_dim=ds.spec.num_classes, num_layers=2, num_heads=2)
        cfg = TrainConfig(num_devices=P, fanouts=(4, 4), batch_size=16,
                          presample_epochs=2, lr=5e-3, num_replicas=R)
        sim = Trainer(ds, spec, cfg, device="cpu")
        traj[f"{key}-{model}"] = (spec, cfg, [
            it.loss for it in sim.train_epoch(max_iters=3).iters])

    p4 = [c for c in cases if c["name"].startswith("p4")]
    mesh = [c for c in cases if c["name"].startswith("mesh")]
    tasks = [
        (exchange_rank, (1, 4, prim4)),
        (exchange_rank, (2, 2, prim22)),
        (grads_rank, (1, 4, p4)),
        (grads_rank, (2, 2, mesh)),
        (spmd.sample_rank, (4, sample_cases)),
    ] + [(spmd.train_rank, ("tiny", spec, cfg, 1, 3))
         for spec, cfg, _ in traj.values()]
    with tempfile.TemporaryDirectory() as tmp:
        inp, outp = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, meta=np.asarray(meta, dtype=object), **jax_in)
        env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
                   XLA_FLAGS="--xla_force_host_platform_device_count=4")
        jax_proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT, inp, outp], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = spmd.launch(tasks, world=4, device="cpu",
                                timeout_s=LIMIT_S)
            stdout, stderr = jax_proc.communicate(timeout=LIMIT_S)
        finally:
            jax_proc.kill()
            jax_proc.wait()
        assert jax_proc.returncode == 0, f"{stdout}\n{stderr}"
        jax_out = dict(np.load(outp))
    got = {}
    for rank, res in enumerate(ranks):
        for group, results in ((p4, res[2]), (mesh, res[3])):
            for case, r in zip(group, results, strict=True):
                got.setdefault(case["name"], []).append(r)
    return {
        "expect": expect, "got": got, "jax": jax_out,
        "prim": {4: (prim4, [r[0] for r in ranks]),
                 2: (prim22, [r[1] for r in ranks])},
        "sample": ([r[4] for r in ranks], sim_blocks),
        "traj": {k: (v[2], [r[5 + i] for r in ranks])
                 for i, (k, v) in enumerate(traj.items())},
    }


def _rank_place(rank, case_name):
    """(replica, split, P) of a rank in a forward case's mesh."""
    if case_name.startswith("mesh"):
        return rank // 2, rank % 2, 2
    return 0, rank, 4


# --------------------------------------------------------------------- #
# primitives
# --------------------------------------------------------------------- #
PRIM_NAMES = {4: ["alltoall", "alltoall_ids", "alltoall_bf16", "shuffle",
                  "shuffle_bf16", "append", "serve"],
              2: ["alltoall", "alltoall_ids", "alltoall_bf16", "shuffle",
                  "shuffle_bf16", "append"]}


@pytest.mark.parametrize("P,name", [(P, n) for P in (4, 2)
                                    for n in PRIM_NAMES[P]])
def test_spmd_primitive_matches_sim_bitwise(runs, P, name):
    """Each rank's output and adjoint are split p's of the sim form on its
    replica's inputs, bit for bit (a bf16 wire too, against the sim form's
    bf16 wire); a bf16 wire lies within 5e-2 of the fp32 one."""
    cases, by_rank = runs["prim"][P]
    i = [c["name"] for c in cases].index(name)
    case = cases[i]
    for rank, res in enumerate(by_rank):
        r, p = divmod(rank, P)
        x = case["inputs"][r]
        want, want_g = _sim_primitive(case["op"], x, case["wire"])
        got = res[i]
        assert np.array_equal(got["out"], want[p:p + 1].numpy()), rank
        assert set(got["grads"]) == set(want_g)
        for k, g in want_g.items():
            assert np.array_equal(got["grads"][k], g[p:p + 1].numpy()), k
        if case["wire"] == "bfloat16":
            fp32, _ = _sim_primitive(case["op"], x, None)
            np.testing.assert_allclose(got["out"], fp32[p:p + 1].numpy(),
                                       **WIRE_TOL)


def test_spmd_replica_grad_mean_is_the_sim_mean_bitwise(runs):
    """At R = 2 the replica mean is the sim mesh's ``(g0 + g1) / 2`` bit for
    bit on every rank: a sum of two terms has one order."""
    cases, by_rank = runs["prim"][2]
    case = cases[[c["name"] for c in cases].index("replica_mean")]
    g0, g1 = (x["grads"] for x in case["inputs"])
    want = [((a + b) / 2).numpy() for a, b in zip(g0, g1)]
    for res in by_rank:
        got = res[-1]["out"]
        assert all(np.array_equal(a, b) for a, b in zip(got, want,
                                                        strict=True))


# --------------------------------------------------------------------- #
# the forward and its gradients
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", FWD_CASES)
def test_spmd_forward_matches_port_sim(runs, name):
    """Each rank's logits are split p of the port's sim forward (its
    replica's part) within rtol 1e-6; the loss, accuracy and gradients are
    the same on every rank."""
    want = runs["expect"][name]["logits"]
    got = runs["got"][name]
    for rank, res in enumerate(got):
        r, p, _ = _rank_place(rank, name)
        fwd_close(res["logits"], want[r][p:p + 1])
        assert res["loss"] == got[0]["loss"]
        assert res["accuracy"] == got[0]["accuracy"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(res["grads"], got[0]["grads"], strict=True))


@pytest.mark.parametrize("name", FWD_CASES)
def test_spmd_grads_match_port_sim(runs, name):
    """The masked-xent parameter gradients (all-reduced over the split
    group, averaged over replicas) within 3e-4 of the port's sim
    gradients."""
    got = runs["got"][name][0]["grads"]
    for a, b in zip(got, runs["expect"][name]["grads"], strict=True):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("name", JAX_CASES)
def test_spmd_grads_match_jax_sim(runs, name):
    """The same gradients within 3e-4 of the JAX package's sim gradients
    (jax 0.9.0 cannot differentiate through ``shard_map``)."""
    got = runs["got"][name][0]["grads"]
    for a, b in zip(got, runs["expect"][name]["jax_grads"], strict=True):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("name", JAX_CASES)
def test_spmd_forward_matches_jax_spmd(runs, name):
    """Each rank's logits against the JAX ``gnn_forward_spmd`` under
    ``shard_map`` on four host devices, on the same arrays (under jax 0.9.0
    the forward runs; only its gradients raise)."""
    want = runs["jax"][name]
    want = [want[r] for r in range(2)] if name.startswith("mesh") else [want]
    for rank, res in enumerate(runs["got"][name]):
        r, p, _ = _rank_place(rank, name)
        fwd_close(res["logits"], np.asarray(want[r])[p:p + 1])


# --------------------------------------------------------------------- #
# trajectories
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("key", ["p4-sage", "mesh-sage", "mesh-gat"])
def test_spmd_trajectory_matches_sim_trainer(runs, key):
    """Three ``SpmdTrainer`` steps within 1e-4 of the port's sim
    ``Trainer`` (P = 4; the 2 x 2 mesh against ``num_replicas=2``), the
    same losses on every rank, and every rank's parameters equal at the
    end (the all-reduced gradients and the update are the same bits)."""
    sim, by_rank = runs["traj"][key]
    np.testing.assert_allclose(by_rank[0]["losses"], sim, **TRAJ_TOL)
    for res in by_rank[1:]:
        assert res["losses"] == by_rank[0]["losses"]
        assert all(np.array_equal(a, b) for a, b in
                   zip(res["params"], by_rank[0]["params"], strict=True))


# --------------------------------------------------------------------- #
# the sampler
# --------------------------------------------------------------------- #
def _assert_blocks_equal(got, want, p):
    fronts, counts, layers, _ = got
    wf, wc, wl, _ = want
    for d in range(len(wf)):
        assert np.array_equal(fronts[d], wf[d][p:p + 1]), d
        assert np.array_equal(counts[d], wc[d][p:p + 1]), d
    for l in range(len(wl)):
        for k in wl[l]:
            assert np.array_equal(layers[l][k], wl[l][k][p:p + 1]), (l, k)


def test_spmd_sampler_matches_sim_and_jax(runs):
    """Each rank's fronts, counts and edges are split p of the sim
    ``_sample_device``'s bit for bit, and the JAX spmd sampler's; the
    rank's targets (``sorted_unique_capped`` under its owner mask) are the
    sim form's ``bucket_by_owner`` row. No cap overflowed."""
    by_rank, sim = runs["sample"]
    jax_out = runs["jax"]
    L = len(FANOUTS)
    jax_blocks = (
        [jax_out[f"sampler/front{d}"] for d in range(L + 1)],
        [jax_out[f"sampler/count{d}"] for d in range(L + 1)],
        [{k: jax_out[f"sampler/layer{l}/{k}"]
          for k in ("dst", "src", "eid", "valid")} for l in range(L)],
        {},
    )
    for p, res in enumerate(by_rank):
        assert res[0]["overflow"] == []
        assert not any(res[0]["blocks"][3].values())
        _assert_blocks_equal(res[0]["blocks"], sim, p)
        _assert_blocks_equal(res[0]["blocks"], jax_blocks, p)


def test_spmd_sampler_overflow_on_one_rank_discards_everywhere(runs):
    """A C0 cap of 1 on rank 1 alone: only its own flag is set, and the
    reduced flags (``spmd_overflow``) name C0 on every rank, so every rank
    discards the batch; the next batch then runs on all ranks (no rank
    waits alone) and equals the first."""
    by_rank, sim = runs["sample"]
    for p, res in enumerate(by_rank):
        assert res[1]["blocks"][3]["C0"] == (p == 1)
        assert res[1]["overflow"] == ["C0"]
        assert res[2]["overflow"] == []
        _assert_blocks_equal(res[2]["blocks"], sim, p)


# --------------------------------------------------------------------- #
# the sim path's bits, and the slicers
# --------------------------------------------------------------------- #
def test_sim_comm_is_the_pre_refactor_exchange():
    """``SimComm().exchange`` is the inline exchange the overlap schedule
    made before it took a ``comm`` (a transpose, then the recv region's
    reshape), bit for bit; so is an overlap layer through either, forward
    and adjoint, for all three models."""

    class Inline:
        def exchange(self, send, wire_dtype=None):
            P, _, S, Fc = send.shape
            return sim_alltoall(send, wire_dtype).reshape(P, P * S, Fc)

    ds = make_dataset("tiny")
    w = presample(ds.graph, ds.train_ids, FANOUTS, 16, num_epochs=1)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    plan = _plans(ds, part.assignment, 4)[0]
    pa = plan_io.plan_to_device(plan, "cpu", with_halves=True)
    feats = plan_io.pad_rows(plan_io.gather_features(plan, ds.features),
                             plan.front_ids[-1].shape[1])
    send = torch.randn(4, 4, 3, 5, generator=torch.Generator().manual_seed(0))
    for wire in (None, "bfloat16"):
        assert torch.equal(SimComm().exchange(send, wire),
                           Inline().exchange(send, wire))
    lp = pa["layers"][1]
    for model in MODELS:
        spec = _spec(ds, model, chunks=3)
        outs = []
        for comm in (SimComm(), Inline()):
            gnn = params_from_jax(_jax_params(ds, model), spec, "cpu")
            h = feats.clone().requires_grad_(True)
            out = _gnn_layer_overlap(spec, gnn.layers[0], h, lp,
                                     lp["self_pos"].shape[-1], False, comm)
            out.square().sum().backward()
            outs.append((out.detach(), h.grad,
                         [p.grad for p in gnn.layers[0].values()]))
        (o1, h1, g1), (o2, h2, g2) = outs
        assert torch.equal(o1, o2) and torch.equal(h1, h2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2, strict=True))


def test_split_slice_refuses_an_array_without_the_split_axis():
    from repro_torch.launch.sharding import SplitMesh

    mesh = SplitMesh(1, 4, 0, 2, None, None)
    a = np.arange(12).reshape(4, 3)
    assert np.array_equal(split_slice(a, mesh), a[2:3])
    for bad in (np.arange(3), np.zeros((3, 4)), np.float32(1.0)):
        with pytest.raises(ValueError, match="no leading split axis"):
            split_slice(np.asarray(bad), mesh)


def test_make_split_mesh_checks_the_world():
    with pytest.raises(ValueError, match="mesh axes must be >= 1"):
        make_split_mesh(0, 4)


# --------------------------------------------------------------------- #
# the launcher's limits
# --------------------------------------------------------------------- #
def _tiny_split(**over):
    ds = make_dataset("tiny")
    spec = GNNSpec(in_dim=ds.spec.feat_dim, hidden_dim=8,
                   out_dim=ds.spec.num_classes, num_layers=2)
    cfg = TrainConfig(num_devices=2, fanouts=(3, 3), batch_size=16,
                      presample_epochs=1, **over)
    return spec, cfg


def test_launch_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec, cfg = _tiny_split()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmd.launch([(spmd.train_rank, ("tiny", spec, cfg))], world=2)


def test_launch_fails_when_a_rank_raises():
    """Every rank refuses a dp config; the launcher raises the ranks' error
    and stops them."""
    spec, cfg = _tiny_split(mode="dp")
    t0 = time.monotonic()
    with pytest.raises(mp.ProcessRaisedException, match="mode='split' only"):
        spmd.launch([(spmd.train_rank, ("tiny", spec, cfg, 1, 1))], world=2,
                    device="cpu", timeout_s=LIMIT_S)
    assert time.monotonic() - t0 < LIMIT_S


def test_launch_stops_every_rank_past_its_limit():
    """A run longer than the launcher's limit raises ``TimeoutError`` at
    the limit, with every rank stopped."""
    spec, cfg = _tiny_split()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="did not finish in 1.0 s"):
        spmd.launch([(spmd.train_rank, ("tiny", spec, cfg, 1, 1))], world=2,
                    device="cpu", timeout_s=1.0)
    assert time.monotonic() - t0 < 30
    assert not mp.active_children()
