"""Model-level parity: the port's ``gnn_forward`` against the JAX package's.

One plan and one set of weights (``init_gnn_params``, carried over with
``params_from_jax``) go through JAX ``gnn_forward`` with
``agg_backend="pallas"`` (interpret mode) and through the port's, with its
"fused" backend (on CPU: the kernels' plain versions) and its "torch" backend.
Tolerances as in ``tests/test_gather_segsum.py``: loss rtol 2e-5 atol 1e-6,
gradients rtol 5e-4 atol 5e-5.
"""
import copy
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build_split_plan, partition_graph, presample, sim_shuffle
from repro.graph.datasets import make_dataset
from repro.graph.sampling import sample_minibatch
from repro.models.gnn import GNNSpec, init_gnn_params
from repro.models.gnn.layers import gnn_forward
from repro.train.loss import masked_softmax_xent
from repro.train.plan_io import load_features, load_labels, plan_to_device
from repro_torch.core.splitting import repad_plan as t_repad_plan
from repro_torch.models.gnn import GNNSpec as TGNNSpec
from repro_torch.models.gnn import params_from_jax
from repro_torch.train import plan_io as t_plan_io
from repro_torch.train.loss import masked_softmax_xent as t_xent

LOSS_TOL = dict(rtol=2e-5, atol=1e-6)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def batch():
    ds = make_dataset("tiny")
    mb = sample_minibatch(ds.graph, ds.train_ids[:32], [4, 4],
                          np.random.default_rng(7))
    w = presample(ds.graph, ds.train_ids, [4, 4], 32, num_epochs=2)
    part = partition_graph(ds.graph, 4, method="gsplit", weights=w)
    return ds, build_split_plan(mb, part.assignment, 4)


_JAX_CACHE = {}


def _jax_reference(ds, plan, model):
    """JAX loss and grads on the Pallas path (interpret mode), per model."""
    if model not in _JAX_CACHE:
        spec = GNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                       out_dim=8, num_layers=2, num_heads=2,
                       agg_backend="pallas")
        params = init_gnn_params(jax.random.PRNGKey(0), spec)
        pa = plan_to_device(plan)
        feats = jnp.asarray(load_features(plan, ds.features))
        labels = jnp.asarray(load_labels(plan, ds.labels))
        loss, grads = jax.jit(jax.value_and_grad(lambda p: masked_softmax_xent(
            gnn_forward(spec, p, feats, pa, sim_shuffle), labels,
            pa["target_mask"],
        )))(params)
        np_params = [{k: np.asarray(v) for k, v in d.items()} for d in params]
        np_grads = [{k: np.asarray(v) for k, v in d.items()} for d in grads]
        _JAX_CACHE[model] = (float(loss), np_params, np_grads)
    return _JAX_CACHE[model]


def _port_loss_and_grads(ds, plan, model, backend, np_params):
    spec = TGNNSpec(model=model, in_dim=ds.spec.feat_dim, hidden_dim=16,
                    out_dim=8, num_layers=2, num_heads=2, agg_backend=backend)
    gnn = params_from_jax(np_params, spec, "cpu")
    pa = t_plan_io.plan_to_device(plan, "cpu")
    feats = torch.as_tensor(t_plan_io.load_features(plan, ds.features))
    labels = torch.as_tensor(t_plan_io.load_labels(plan, ds.labels))
    loss = t_xent(gnn(feats, pa), labels, pa["target_mask"])
    loss.backward()
    grads = [{k: p.grad.numpy() for k, p in layer.items()} for layer in gnn.layers]
    return float(loss.detach()), grads


@pytest.mark.parametrize("backend", ["fused", "torch"])
@pytest.mark.parametrize("model", ["sage", "gcn", "gat"])
def test_gnn_forward_matches_jax_pallas(batch, model, backend):
    ds, plan = batch
    loss_j, np_params, grads_j = _jax_reference(ds, plan, model)
    loss_t, grads_t = _port_loss_and_grads(ds, plan, model, backend, np_params)
    np.testing.assert_allclose(loss_t, loss_j, **LOSS_TOL)
    for gj, gt in zip(grads_j, grads_t):
        assert gj.keys() == gt.keys()
        for k in gj:
            np.testing.assert_allclose(gt[k], gj[k], err_msg=k, **GRAD_TOL)


@pytest.mark.parametrize("model", ["sage", "gat"])
def test_repadded_plan_is_inert(batch, model):
    """The same batch repadded to larger high-water marks (rebased edge_src,
    grown pack axes) gives the JAX loss on the unpadded plan."""
    ds, plan = batch
    loss_j, np_params, _ = _jax_reference(ds, plan, model)
    plan2 = copy.deepcopy(plan)
    t_repad_plan(plan2, {"N0": 48, "N1": 160, "N2": 300, "E0": 640,
                         "E1": 640, "S0": 32, "S1": 32, "EB0": 64, "EB1": 64})
    loss_t, _ = _port_loss_and_grads(ds, plan2, model, "fused", np_params)
    np.testing.assert_allclose(loss_t, loss_j, **LOSS_TOL)


def test_params_from_jax_checks_names_and_shapes(batch):
    ds, plan = batch
    _, np_params, _ = _jax_reference(ds, plan, "sage")
    spec = TGNNSpec(model="sage", in_dim=ds.spec.feat_dim, hidden_dim=16,
                    out_dim=8, num_layers=2)
    bad = [dict(d) for d in np_params]
    bad[0]["w_self"] = bad[0]["w_self"][:, :4]
    with pytest.raises(ValueError):
        params_from_jax(bad, spec, "cpu")
    with pytest.raises(ValueError):
        params_from_jax(np_params, replace(spec, model="gcn"), "cpu")
