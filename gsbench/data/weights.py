"""The initial weights of a GNN configuration, drawn from the seed on the
device in one call: Glorot-uniform over the last two axes of each weight,
zero biases. Named as the program's model names them
(``layers.<k>.<leaf>``), so the driver can hand them over by name."""
from __future__ import annotations

import math

import torch


def layer_dims(model: dict) -> list:
    """(input, output) width of each layer: the features in, the hidden
    width between layers, the classes out."""
    dims, d_in = [], model["feat_dim"]
    for k in range(model["num_layers"]):
        last = k == model["num_layers"] - 1
        d_out = model["num_classes"] if last else model["hidden_dim"]
        dims.append((d_in, d_out))
        d_in = d_out
    return dims


def leaf_shapes(model: dict) -> dict:
    """``{name: shape}`` of every leaf, layer by layer, in the order the
    program's model holds them."""
    shapes = {}
    for k, (d_in, d_out) in enumerate(layer_dims(model)):
        if model["kind"] == "sage":
            leaves = {"w_self": (d_in, d_out), "w_neigh": (d_in, d_out),
                      "b": (d_out,)}
        elif model["kind"] == "gat":
            heads = model["num_heads"]
            dh = d_out // heads
            leaves = {"w": (d_in, heads, dh), "a_src": (heads, dh),
                      "a_dst": (heads, dh), "b": (d_out,)}
        else:
            raise ValueError(f"unknown model kind {model['kind']!r}")
        shapes.update({f"layers.{k}.{n}": s for n, s in leaves.items()})
    return shapes


def make_weights(model: dict, seed: int, device) -> dict:
    shapes = leaf_shapes(model)
    sizes = {n: math.prod(s) for n, s in shapes.items() if len(s) > 1}
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.rand(sum(sizes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        lim = math.sqrt(6.0 / (shape[-2] + shape[-1]))
        chunk = draw[at:at + sizes[name]]
        at += sizes[name]
        out[name] = (chunk * (2 * lim) - lim).reshape(shape)
    return out


def reference_model(model: dict) -> dict:
    """The reference's view of the model: its kind and each layer's leaves."""
    leaves = [[] for _ in range(model["num_layers"])]
    for name in leaf_shapes(model):
        _, k, leaf = name.split(".")
        leaves[int(k)].append(leaf)
    return {"kind": model["kind"], "leaves": leaves}
