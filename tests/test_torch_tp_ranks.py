"""Rank functions for the launches of the transformer across ranks in
``tests/test_torch_tp.py`` and ``tests/test_torch_tp_train.py``
(``repro_torch.launch.spmd.launch``); this module holds no tests and
imports no JAX, so the spawned ranks can import it.

``serve_cases_rank`` serves each case on a (data, model) mesh
(``serve.serve_rank``); ``moe_cases_rank`` runs the expert-local dispatch
(``moe_apply_shard_map``) and the global one on the rank's slices;
``train_cases_rank`` trains each case on its mesh
(``launch/shapes.py::train_rank``).
"""
import numpy as np
import torch

from repro_torch import serve
from repro_torch.launch import shapes
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharding import batch_slice, param_slice
from repro_torch.models.transformer import moe
from repro_torch.models.transformer.model import _flatten, _unflatten


def serve_cases_rank(device, mesh_shape, cases: list) -> list:
    """Per case (``cfg``, ``np_params`` or None for the weights drawn from
    seed 0, ``prompts``, ``patches``, ``new``), ``serve.serve_rank``'s
    results on this rank, its flops counted."""
    return [serve.serve_rank(device, c["cfg"], mesh_shape, c["new"],
                             prompts=c["prompts"], patches=c["patches"],
                             np_params=c["np_params"], count_flops=True)
            for c in cases]


def train_cases_rank(device, cases: list, steps: int) -> list:
    """Per case (``cfg``, ``mesh``, ``data`` (the whole batch, numpy),
    ``np_params`` or None for the weights drawn from seed 0, ``terms``, the
    gradient terms to keep, ``record``: whether to build the roofline
    record): ``shapes.train_rank``'s results on this rank after ``steps``
    AdamW steps, its slices kept, its first step's flops counted."""
    return [shapes.train_rank(device, c["cfg"], c["mesh"], steps,
                              data=c["data"], np_params=c["np_params"],
                              grad_terms=c["terms"], keep_params=True,
                              record=c["record"], count_flops=True)
            for c in cases]


def moe_cases_rank(device, mesh_shape, cases: list) -> list:
    """Per case (``cfg``, ``params`` a nested dict of numpy arrays, ``x``
    (B, S, d)): the rank's rows of ``moe_apply_shard_map`` and of the
    global dispatch (``moe_apply`` on the mesh), each with its aux, and the
    rows' [start, stop)."""
    mesh = make_mesh(mesh_shape)
    out = []
    for c in cases:
        cfg = c["cfg"]
        flat = {k: torch.as_tensor(v, device=device)
                for k, v in _flatten(c["params"]).items()}
        params = _unflatten(param_slice(cfg, flat, mesh))
        x = batch_slice(cfg, {"x": torch.as_tensor(c["x"], device=device)},
                        mesh)["x"]
        with torch.no_grad():
            y, aux = moe.moe_apply_shard_map(params, x, cfg, mesh)
            g, g_aux = moe.moe_apply(params, x, cfg, mesh)
        B = x.shape[0]
        out.append({"y": y.cpu().numpy(), "aux": float(aux),
                    "global": g.cpu().numpy(), "global_aux": float(g_aux),
                    "rows": (mesh.data_index * B, (mesh.data_index + 1) * B),
                    "experts": int(params["w_in"].shape[0])})
    return out


def np_tree(tree):
    """A nested dict of arrays as numpy (for pickling to the ranks)."""
    return {k: np_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}
