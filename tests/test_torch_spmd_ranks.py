"""Rank functions for the spmd tests' launches (``repro_torch.launch.spmd.
launch``); this module holds no tests.

The spawned ranks import a rank function by reference, so it lives in a
module of its own that they can import (the ranks inherit the launcher's
``sys.path``, which holds this directory under pytest) and that imports no
JAX. ``grads_rank`` takes one batch's logits and gradients on a rank;
``exchange_rank`` runs each exchange primitive on the rank's split of
sim-form inputs.
"""
import torch

from repro_torch.core.shuffle import (
    replica_grad_mean,
    spmd_alltoall,
    spmd_append_replicated,
    spmd_serve_features,
    spmd_shuffle,
)
from repro_torch.launch.sharding import make_split_mesh, plan_slice, split_slice
from repro_torch.launch.spmd import spmd_step_grads


def grads_rank(device, num_replicas: int, num_splits: int, cases: list) -> list:
    """Per case, this rank's logits and the step's loss, accuracy and
    gradients (``spmd_step_grads``, no update): the spmd step held against
    the sim one. A case is a dict with ``spec``, ``model`` (a ``GNN``),
    ``parts`` (the R ``PlanBatch`` parts) and optionally ``cache_block``
    (the full (P, C, F) block), ``rep_block`` and ``with_halves``."""
    mesh = make_split_mesh(num_replicas, num_splits)
    out = []
    for case in cases:
        model = case["model"].to(device)
        cache = case.get("cache_block")
        rep = case.get("rep_block")
        logits, loss, acc, grads = spmd_step_grads(
            case["spec"], model, mesh, case["parts"][mesh.replica], device,
            cache_local=None if cache is None else split_slice(
                cache.to(device), mesh),
            rep_block=None if rep is None else rep.to(device),
            with_halves=case.get("with_halves", False),
        )
        out.append({
            "logits": logits.detach().cpu().numpy(),
            "loss": float(loss), "accuracy": float(acc),
            "grads": [g.cpu().numpy() for g in grads],
        })
    return out




#: the float inputs of each exchange primitive that ``exchange_rank``
#: differentiates (the replicated block's adjoint is a partial sum a rank)
PRIMITIVE_LEAVES = ("send", "h", "rows", "cache_block", "miss")


def exchange_rank(device, num_replicas: int, num_splits: int,
                  cases: list) -> list:
    """Each exchange primitive on this rank's split of sim-form inputs (its
    replica's set): the output and, given ``cot`` (a cotangent of the sim
    output), the adjoint of ``<output, cot>`` w.r.t. the rank's float
    inputs. A case is a dict with ``op``, ``wire`` and ``inputs``, R dicts
    of sim-form tensors (leading split axis P) by op:

      * ``alltoall``: ``send`` (P, P, ...) -> ``spmd_alltoall(send[p])``
        (P, ...), split p of ``sim_alltoall``;
      * ``shuffle``: ``h`` (P, N, F), ``send_idx``, ``send_count``;
      * ``append``: ``rows`` (P, M, F) and ``rep`` (R_rows, F), whole;
      * ``serve``: ``cache_block`` (P, C, F), ``cplan`` (a device cache
        plan), ``miss`` (P, M, F);
      * ``replica_mean``: ``grads``, this replica's gradient list, through
        ``replica_grad_mean`` over the replica group.
    """
    mesh = make_split_mesh(num_replicas, num_splits)
    group = mesh.split_group
    out = []
    for case in cases:
        op, wire = case["op"], case["wire"]
        x = case["inputs"][mesh.replica]
        if op == "replica_mean":
            res = replica_grad_mean([t.to(device) for t in x["grads"]],
                                    mesh.replica_group, num_replicas)
            out.append({"out": [t.cpu().numpy() for t in res], "grads": {}})
            continue
        mine = {}
        for k, v in x.items():
            if v is None or k == "rep":
                mine[k] = v if v is None else v.to(device)
                continue
            v = plan_slice(v, mesh)
            v = ({kk: vv.to(device) for kk, vv in v.items()}
                 if isinstance(v, dict) else v.to(device))
            if k in PRIMITIVE_LEAVES and v.is_floating_point():
                v = v.detach().clone().requires_grad_(True)
            mine[k] = v
        if op == "alltoall":
            y = spmd_alltoall(mine["send"][0], group, wire)[None]
        elif op == "shuffle":
            y = spmd_shuffle(mine["h"], mine["send_idx"], group, wire,
                             send_count=mine["send_count"])
        elif op == "append":
            y = spmd_append_replicated(mine["rows"], mine["rep"])
        elif op == "serve":
            y = spmd_serve_features(mine["cache_block"], mine["cplan"],
                                    mine["miss"], group, wire)
        else:
            raise ValueError(f"unknown exchange primitive {op!r}")
        grads = {}
        if mine.get("cot") is not None:
            (y * mine["cot"]).sum().backward()
            grads = {k: v.grad.cpu().numpy() for k, v in mine.items()
                     if k in PRIMITIVE_LEAVES and isinstance(v, torch.Tensor)
                     and v.requires_grad}
        out.append({"out": y.detach().cpu().numpy(), "grads": grads})
    return out
