"""Transformer LM: init / train / prefill / decode across the six families
— the counterpart of ``repro/models/transformer/model.py``.

The JAX package stacks the uniform blocks and runs them with ``lax.scan``,
and runs a MoE model's leading dense blocks (``lead_blocks``) unscanned;
here both are ``nn.ModuleList``s run by a Python loop, the lead blocks
first. So the reference's ``unroll`` flag (a Python loop in place of the
scan, for the dry-run's cost count) has no counterpart: the port's loop is
always unrolled. Caches are a list with one dict per layer, in that order
(the JAX package stacks the scanned layers' on a leading axis and lists the
lead layers' apart).

Train mode runs each block under ``torch.utils.checkpoint`` when
``cfg.opt_remat == "full"`` (the reference's ``jax.checkpoint`` around the
lead blocks and the scanned body): a layer keeps only its input for the
backward and recomputes the rest.

Serving and training run on a (data, model) mesh too (``launch/mesh.py``): a
rank holds its slice of every weight (``launch/sharding.py``'s specs), made
so by ``init_params(mesh=...)`` or ``transformer_params_from_jax(mesh=...)``
one leaf at a time (a rank never holds the whole model), or by
``shard_params`` for a model already built; each parameter is marked with
its sharded dimension (``sharding.mark``) and the mesh is recorded on the
model.
``init_caches(mesh=...)`` makes the rank's marked slice of the caches. The
prefill, decode and train steps take the mesh from the model and run the
blocks tensor-parallel (``blocks.py``), the embedding vocab-parallel (a
masked lookup of the rank's rows and an ``all_reduce`` over ``model``) and
the head column-parallel (the logits gathered over ``model``, the loss then
replicated: no vocab-parallel cross-entropy, as in the reference). The
batch is the rank's rows; in the forward nothing crosses the data axes but
the global MoE dispatch's tokens (and the expert-local dispatch's aux). A
train step is each rank's backward (each collective's adjoint a counted
collective, ``launch/mesh.py``), then the gradients averaged over the data
axes, then the optimizer on the rank's slices; its state has the slices'
shapes (``sharding.opt_state_specs``). At a (1, 1) mesh every step is the
unsharded one, bit for bit.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.launch.mesh import all_gather, all_reduce, enter
from repro_torch.launch.sharding import (
    cache_specs,
    mark,
    model_dim,
    param_specs,
    spec_slice,
)
from repro_torch.models.transformer.blocks import (
    Block,
    block_apply,
    block_init,
    block_shapes,
    check_arch,
    check_mesh,
)
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import init_tree, leaf_dtype, rms_norm


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_lead(cfg: ArchConfig) -> int:
    return cfg.first_dense_layers if cfg.family == "moe" else 0


class TransformerLM(nn.Module):
    """The model's parameters with the JAX package's names: ``embed`` (V, d)
    or, with codebooks, (nc, V, d); ``final_norm`` (d,) f32; ``lm_head``
    (d, V) or (d, nc*V) when untied; ``lead_blocks`` (a MoE model's leading
    dense layers, else empty) and ``blocks``, one ``Block`` per layer.
    ``mesh`` is None, or the mesh whose rank's slices it holds
    (``shard_params``)."""

    def __init__(self, cfg: ArchConfig, embed, final_norm, blocks, lm_head=None,
                 lead_blocks=()):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = nn.Parameter(lm_head) if lm_head is not None else None
        self.lead_blocks = nn.ModuleList(lead_blocks)
        self.blocks = nn.ModuleList(blocks)
        self.mesh = None

    def layers(self) -> list:
        """Every block in the order they run: the lead blocks, then the rest."""
        return [*self.lead_blocks, *self.blocks]


def _top_shapes(cfg: ArchConfig) -> dict:
    d, V, nc = cfg.d_model, cfg.vocab_size, cfg.num_codebooks
    top = {"embed": (nc, V, d) if nc else (V, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        top["lm_head"] = (d, nc * V if nc else V)
    return top


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def init_params(cfg: ArchConfig, generator: torch.Generator,
                mesh=None) -> TransformerLM:
    """Random weights drawn from ``generator`` on its device, with the JAX
    package's shapes, dtypes and scales (normal * fan_in**-0.5; norms at 1;
    the SSM's ``A_log``/``dt_bias`` the reference's own). It does not
    reproduce ``jax.random``'s bits: carry the JAX package's weights over
    with ``transformer_params_from_jax`` for parity.

    With ``mesh`` the model holds the rank's slices (``_leaf_slicer``):
    each leaf is drawn whole, sliced and dropped before the next, so the
    device holds the rank's slices and one whole leaf at most, and the
    slices are those of the unsharded model's leaves, bit for bit."""
    check_arch(cfg)
    keep = None if mesh is None else _leaf_slicer(cfg, mesh)
    dtype = _dtype(cfg)
    top = init_tree(generator, _top_shapes(cfg), dtype, keep=keep)
    blocks = [block_init(generator, cfg, i, dtype, keep)
              for i in range(cfg.num_layers)]
    n_lead = _n_lead(cfg)
    model = TransformerLM(cfg, top["embed"], top["final_norm"],
                          blocks[n_lead:], top.get("lm_head"), blocks[:n_lead])
    return model if mesh is None else _on_mesh(model, mesh)


def empty_params(cfg: ArchConfig, device) -> TransformerLM:
    """A ``TransformerLM`` of ``init_params``' names, shapes and dtypes with
    uninitialised parameters: on ``device="meta"`` none has storage, so a
    full-width model of any size costs nothing, and its forward and
    backward run shapes only (what ``launch/roofline.py`` counts)."""
    check_arch(cfg)
    dtype = _dtype(cfg)

    def leaves(shapes: dict) -> dict:
        return {name: torch.empty(shape, dtype=leaf_dtype(name, shape, dtype),
                                  device=device)
                for name, shape in _flatten(shapes).items()}

    top = leaves(_top_shapes(cfg))
    blocks = [Block(_unflatten(leaves(block_shapes(cfg, i))))
              for i in range(cfg.num_layers)]
    n_lead = _n_lead(cfg)
    return TransformerLM(cfg, top["embed"], top["final_norm"], blocks[n_lead:],
                         top.get("lm_head"), blocks[:n_lead])


def _from_numpy(a) -> torch.Tensor:
    """A numpy array (bfloat16 from ``ml_dtypes`` included) as a tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def transformer_params_from_jax(np_params: dict, cfg: ArchConfig,
                                device, mesh=None) -> TransformerLM:
    """A ``TransformerLM`` holding the JAX package's parameters.

    ``np_params`` is the JAX ``init_params`` pytree as numpy arrays:
    ``embed``, ``final_norm``, ``lm_head`` when untied, ``lead_blocks`` (a
    list of unstacked blocks) for a MoE model with leading dense layers, and
    ``blocks`` with every leaf stacked on a leading layer axis (nested
    dicts: ``attn``, ``mlp``, ``moe`` with ``shared``, ``ssm``). The layer
    axis is unstacked; every name and shape is checked against the config
    (``block_shapes``; the norms, the SSM's vectors and the router float32,
    the rest in the config's dtype), and a mismatch raises ``ValueError``.
    bfloat16 crosses bit for bit. Each leaf goes to ``device`` as it is
    taken; with ``mesh`` only its rank's slice (``_leaf_slicer``, taken on
    the host).
    """
    check_arch(cfg)
    dtype = _dtype(cfg)
    n_lead = _n_lead(cfg)
    n_scan = cfg.num_layers - n_lead
    top = _top_shapes(cfg)
    names = set(top) | {"blocks"} | ({"lead_blocks"} if n_lead else set())
    if set(np_params) != names:
        raise ValueError(f"parameter names {sorted(np_params)} != {sorted(names)}")

    keep = None if mesh is None else _leaf_slicer(cfg, mesh)

    def take(name, value, shape):
        t = _from_numpy(value)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
        t = t.to(leaf_dtype(name, shape, dtype))
        return (t if keep is None else keep(name, t)).to(device)

    def block(flat: dict, layer: int, where: str, index=None) -> Block:
        want = _flatten(block_shapes(cfg, layer))
        if set(flat) != set(want):
            raise ValueError(
                f"{where} block parameters {sorted(flat)} != {sorted(want)}")
        out = {}
        for name, shape in want.items():
            value = np.asarray(flat[name])
            if index is not None:
                if value.shape[:1] != (n_scan,):
                    raise ValueError(
                        f"blocks.{name}: {value.shape[:1]} stacked layers, the "
                        f"config has {n_scan}")
                value = value[index]
            out[name] = take(f"{where}.{name}", value, shape)
        return Block(_unflatten(out))

    lead = list(np_params.get("lead_blocks", []))
    if len(lead) != n_lead:
        raise ValueError(f"{len(lead)} lead blocks, the config has {n_lead} "
                         "leading dense layers")
    lead_blocks = [block(_flatten(b), i, f"lead_blocks[{i}]")
                   for i, b in enumerate(lead)]
    stacked = _flatten(np_params["blocks"])
    blocks = [block(stacked, n_lead + i, f"blocks[{i}]", index=i)
              for i in range(n_scan)]
    model = TransformerLM(
        cfg, *(take(n, np_params[n], top[n]) for n in ("embed", "final_norm")),
        blocks,
        None if cfg.tie_embeddings
        else take("lm_head", np_params["lm_head"], top["lm_head"]),
        lead_blocks,
    )
    return model if mesh is None else _on_mesh(model, mesh)


def _leaf_slicer(cfg: ArchConfig, mesh):
    """``keep(name, leaf)`` for ``init_tree``: the rank's slice of a leaf
    by its spec (``param_specs`` reads only the leaf's last name, rank and
    shape)."""
    check_mesh(cfg, mesh)

    def keep(name, t):
        return spec_slice(t, param_specs(cfg, {name: t}, mesh)[name], mesh)

    return keep


def _on_mesh(model: TransformerLM, mesh) -> TransformerLM:
    """Mark each parameter of ``model`` (the rank's slices) with its spec
    on ``mesh`` (``sharding.mark``) and record the mesh on the model."""
    specs = param_specs(model.cfg, empty_params(model.cfg, "meta"), mesh)
    for name, param in model.named_parameters():
        mark(param, specs[name], mesh)
    model.mesh = mesh
    return model


def shard_params(model: TransformerLM, mesh) -> TransformerLM:
    """Keep the rank's slice of every parameter of a model built whole
    (``param_specs`` on ``mesh``), in place, one leaf at a time: each
    parameter's data becomes a tensor of its own, so the rest is freed.
    Marks the parameters, records the mesh on the model and returns it.
    A model that does not fit a card whole is built by ``init_params`` or
    ``transformer_params_from_jax`` with the mesh instead."""
    if model.mesh is not None:
        raise ValueError("the model is sharded already")
    keep = _leaf_slicer(model.cfg, mesh)
    for name, param in model.named_parameters():
        param.data = keep(name, param.detach())
    return _on_mesh(model, mesh)


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def _vocab_rows(table, tok, mesh):
    """The rows of the rank's vocabulary block (``table`` (V/M, d)) for
    ``tok``, zeros for the other ranks' ids."""
    V_loc = table.shape[0]
    local = tok - mesh.model_index * V_loc
    ok = (local >= 0) & (local < V_loc)
    rows = table[local.clamp(0, V_loc - 1)]
    return torch.where(ok[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                        device=rows.device))


def embed_tokens(model: TransformerLM, tokens: torch.Tensor,
                 patches: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S) int -> (B, S, d); with codebooks (B, S, nc) int -> the sum of
    the codebooks' embeddings; with ``patches`` (B, Np, d) for a VLM, the
    patch rows prefixed -> (B, Np + S, d). No sqrt(d) scale, as in the
    reference. On a mesh whose ranks hold vocabulary blocks (V/M rows), a
    rank looks up its own ids and one ``all_reduce`` over ``model`` sums
    the blocks (the codebooks' stacked, then summed in order)."""
    cfg = model.cfg
    mesh = model.mesh
    if model_dim(model.embed) is not None:
        if cfg.num_codebooks:
            rows = all_reduce(torch.stack([
                _vocab_rows(model.embed[c], tokens[..., c], mesh)
                for c in range(cfg.num_codebooks)]), mesh)
            h = rows[0]
            for c in range(1, cfg.num_codebooks):
                h = h + rows[c]
            return h
        h = all_reduce(_vocab_rows(model.embed, tokens, mesh), mesh)
        if cfg.num_patches and patches is not None:
            h = torch.cat([patches.to(h.dtype), h], dim=1)
        return h
    if cfg.num_codebooks:
        h = model.embed[0][tokens[..., 0]]
        for c in range(1, cfg.num_codebooks):
            h = h + model.embed[c][tokens[..., c]]
        return h
    h = model.embed[tokens]
    if cfg.num_patches and patches is not None:
        h = torch.cat([patches.to(h.dtype), h], dim=1)
    return h


def lm_logits(model: TransformerLM, h: torch.Tensor) -> torch.Tensor:
    """(B, S, d) -> (B, S, V), or (B, S, nc, V) with codebooks. On a mesh
    whose ranks hold column blocks of the head (of the tied embedding's
    vocabulary), ``h`` enters the product (``mesh.enter``) and each rank's
    logits are gathered over ``model`` (into replicated code: the gather's
    adjoint is the rank's slice). A tied table's two gradients add."""
    cfg = model.cfg
    nc = cfg.num_codebooks
    if model.lm_head is None:
        leaf, w = model.embed, model.embed.reshape(-1, cfg.d_model).T
    else:
        leaf = w = model.lm_head
    if model_dim(leaf) is not None:
        h = enter(h, mesh=model.mesh)
    logits = h @ w
    if model_dim(leaf) is not None:
        B, S, _ = logits.shape
        if model.lm_head is None and nc:  # columns (codebook, own vocab)
            logits = logits.reshape(B, S, nc, -1)
        logits = all_gather(logits, model.mesh, dim=-1)
    if cfg.num_codebooks and logits.dim() == 3:
        B, S, _ = logits.shape
        logits = logits.reshape(B, S, cfg.num_codebooks, cfg.vocab_size)
    return logits


# --------------------------------------------------------------------------- #
# Forward (train / prefill)
# --------------------------------------------------------------------------- #
REMAT = ("full", "none")


def check_remat(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` on an ``opt_remat`` other than ``REMAT``'s."""
    if cfg.opt_remat not in REMAT:
        raise ValueError(f"{cfg.name}: opt_remat={cfg.opt_remat!r}, not one "
                         f"of {REMAT}")


def forward(model: TransformerLM, tokens: torch.Tensor, *,
            patches: torch.Tensor | None = None, mode: str = "train",
            last_only: bool = False):
    """``tokens`` ((B, S), or (B, S, nc) with codebooks; a VLM's ``patches``
    (B, Np, d) go before them) -> (logits, caches, aux).

    logits (B, S', V) or (B, S', nc, V), or of the last position only with
    ``last_only`` (the same function: the head runs on that row only); aux
    the float32 sum of every layer's MoE load-balance loss (0 without MoE).
    ``mode="train"``: caches None, each block under per-layer remat when
    ``cfg.opt_remat == "full"``; ``mode="prefill"``: caches one dict per
    layer, as ``init_caches`` lays them out. Both compute the same logits.
    On a sharded model (``model.mesh``) the rank's tokens, its slices, its
    caches; the logits whole (module docstring)."""
    cfg = model.cfg
    if mode not in ("train", "prefill"):
        raise ValueError(f"forward runs in train or prefill mode, not {mode!r}")
    if mode == "train":
        check_remat(cfg)
    h = embed_tokens(model, tokens, patches)
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    caches = [] if mode == "prefill" else None
    if mode == "train" and cfg.opt_remat == "full":
        # the blocks draw no random numbers: no RNG state to stash
        # every rank recomputes a block's collectives in the same order
        run = functools.partial(checkpoint, functools.partial(
            block_apply, cfg=cfg, mode=mode, mesh=model.mesh),
            use_reentrant=False, preserve_rng_state=False)
    else:
        run = functools.partial(block_apply, cfg=cfg, mode=mode,
                                mesh=model.mesh)
    for blk in model.layers():
        h, c, a = run(blk, h)
        aux = aux + a
        if caches is not None:
            caches.append(c)
    if last_only:
        h = h[:, -1:]
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    return lm_logits(model, h), caches, aux


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """(model, tokens, patches=None) -> (last position's logits (B, 1, V)
    or (B, 1, nc, V), caches). ``mesh`` is the mesh the model will be
    sharded on, which the config is checked against (``check_mesh``); the
    step runs on the model's own (``model.mesh``), with the rank's tokens,
    patches and caches (module docstring)."""
    check_mesh(cfg, mesh)

    def prefill_step(model, tokens, patches=None):
        logits, caches, _ = forward(model, tokens, patches=patches,
                                    mode="prefill", last_only=True)
        return logits, caches

    return prefill_step


# --------------------------------------------------------------------------- #
# Loss / train step
# --------------------------------------------------------------------------- #
def lm_loss(model: TransformerLM, tokens: torch.Tensor,
            patches: torch.Tensor | None = None):
    """Next-token loss -> (total, {"loss", "aux"}), ``total = loss + 0.01 *
    aux``, as the reference's ``lm_loss``.

    The NLL is the mean over every target of the float32 log-softmax:
    ``F.cross_entropy`` on float32 logits, the reference's ``log_softmax``
    + ``take_along_axis`` in one call. Codebook targets are (B, S-1, nc),
    one per codebook; a VLM's text logits start after the patch rows. The
    token ids may be int32, as ``launch/input_specs.py`` makes them. On a
    sharded model ``tokens`` are the rank's rows and the loss is the mean
    over them: the rank's term of the batch's mean, which the train step
    averages over the data axes."""
    cfg = model.cfg
    logits, _, aux = forward(model, tokens, patches=patches, mode="train")
    if cfg.num_patches and patches is not None:
        logits = logits[:, patches.shape[1]:]
    logits = logits[:, :-1].float()
    loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                           tokens[:, 1:].reshape(-1).long())
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


#: what ``lm_grads`` differentiates: the total, or one of its two terms
TERMS = ("total", "loss", "aux")


def lm_grads(model: TransformerLM, tokens: torch.Tensor,
             patches: torch.Tensor | None = None, term: str = "total"):
    """(gradients of ``lm_loss``'s ``term`` over ``list(model.parameters())``,
    metrics). On a sharded model each gradient is the rank's slice of the
    batch's gradient: the rank's backward, then the mean over the data axes
    (one counted ``all_reduce`` on ``"data"`` a leaf, in place). A leaf the
    term does not reach gets zeros (only ``"aux"`` leaves any: a model
    without MoE has no aux to differentiate, and raises)."""
    if term not in TERMS:
        raise ValueError(f"term {term!r} is not one of {TERMS}")
    params = list(model.parameters())
    total, metrics = lm_loss(model, tokens, patches)
    value = total if term == "total" else metrics[term]
    if not value.requires_grad:
        raise ValueError(f"{model.cfg.name}: its {term!r} term has no "
                         "gradient")
    grads = torch.autograd.grad(value, params, allow_unused=term == "aux")
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads, strict=True)]
    mesh = model.mesh
    if mesh is not None and mesh.data_size > 1:
        with torch.no_grad():
            for g in grads:
                all_reduce(g, mesh, axis="data").div_(mesh.data_size)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ArchConfig, optimizer, mesh=None):
    """(model, opt_state, tokens, patches=None) -> (opt_state, metrics).

    The gradients of ``lm_loss``'s total over ``list(model.parameters())``
    (a fixed order; ``optimizer.init`` takes the same list) come from
    ``torch.autograd.grad`` (``lm_grads``); every parameter must get one.
    The optimizer then updates the parameters in place. ``metrics`` holds
    ``loss`` and ``aux`` as 0-d tensors on the model's device: the step
    makes no host sync. The reference returns the new params; here the
    model is them. ``mesh`` is the mesh the model is sharded on, which the
    config is checked against (``check_mesh``); on it the step takes the
    rank's rows, averages the gradients over the data axes and updates the
    rank's slices (module docstring): the loss in ``metrics`` is the rank's
    own term."""
    check_mesh(cfg, mesh)
    check_remat(cfg)

    def train_step(model, opt_state, tokens, patches=None):
        params = list(model.parameters())
        grads, metrics = lm_grads(model, tokens, patches)
        _, opt_state = optimizer.update(grads, opt_state, params)
        return opt_state, metrics

    return train_step


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def init_caches(cfg: ArchConfig, batch_size: int, context_len: int, device,
                mesh=None):
    """Zero caches for decoding against a ``context_len`` context, one dict
    per layer: ``{"k", "v"}`` (B, S_phys, KV, hd); with MLA ``{"c_kv"
    (B, S_phys, kv_lora), "k_rope" (B, S_phys, dr)}``; for SSM ``{"state"
    (B, H, N, P) float32}``; for hybrid ``{"attn": {...}, "state"}``.
    Windowed attention uses a ring buffer of ``min(context_len, window)``
    rows.

    With ``mesh``, the rank's slice of each (``cache_specs``), marked
    (``sharding.mark``: a k/v or latent cache marked on dimension 1 is
    sharded by sequence):
    ``batch_size`` is the global batch, which the data axes must divide
    (when they are more than one rank); on a model axis of M > 1 the
    context is rounded up to a multiple of M (the rows past the context
    stay masked), so that a cache that is not sharded by head is sharded by
    sequence; a ring that M does not divide raises."""
    check_arch(cfg)
    dtype = _dtype(cfg)
    B = batch_size
    M = 1 if mesh is None else mesh.model_size
    context_len = -(-context_len // M) * M
    S_phys = min(context_len, cfg.attn_window) if cfg.attn_window else context_len
    where = device if mesh is None else "meta"

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=where)

    def one_layer():
        state = (B, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_headdim)
        if cfg.family == "ssm":
            return {"state": zeros(*state, dt=torch.float32)}
        if cfg.use_mla:
            attn = {"c_kv": zeros(B, S_phys, cfg.kv_lora_rank),
                    "k_rope": zeros(B, S_phys, cfg.qk_rope_dim)}
        else:
            attn = {n: zeros(B, S_phys, cfg.num_kv_heads, cfg.head_dim)
                    for n in ("k", "v")}
        if cfg.family == "hybrid":
            return {"attn": attn, "state": zeros(*state, dt=torch.float32)}
        return attn

    caches = [one_layer() for _ in range(cfg.num_layers)]
    if mesh is None:
        return caches
    check_mesh(cfg, mesh)
    if mesh.data_size > 1 and (B % mesh.data_size or B == 1):
        raise ValueError(f"a batch of {B} does not split over "
                         f"{mesh.data_size} data ranks")

    def local(cache, specs):
        out = {}
        for name, t in cache.items():
            if isinstance(t, dict):
                out[name] = local(t, specs[name])
                continue
            spec = specs[name]
            if M > 1 and name in ("k", "v", "c_kv", "k_rope") \
                    and "model" not in spec:
                raise ValueError(f"{cfg.name}: a {name} cache of {S_phys} "
                                 f"rows does not split over {M} model ranks")
            out[name] = mark(torch.zeros(spec_slice(t, spec, mesh).shape,
                                         dtype=t.dtype, device=device),
                             spec, mesh)
        return out

    return [local(c, s) for c, s in zip(caches, cache_specs(cfg, caches, mesh),
                                        strict=True)]


def make_decode_step(cfg: ArchConfig, mesh=None):
    """(model, tokens (B, 1) or (B, 1, nc), pos, caches) -> (logits
    (B, 1, V) or (B, 1, nc, V), caches).

    One new token at position ``pos`` (an int, or a 0-d integer tensor on
    the device, which keeps the loop free of host syncs). Every cache is
    updated in place and returned. ``mesh`` as ``make_prefill_step``'s; on
    a sharded model the tokens and caches are the rank's
    (``init_caches(mesh=)``)."""
    check_mesh(cfg, mesh)

    def decode_step(model, tokens, pos, caches):
        h = embed_tokens(model, tokens)
        for blk, c in zip(model.layers(), caches, strict=True):
            h, _, _ = block_apply(blk, h, cfg, mode="decode", cache=c, pos=pos,
                                  mesh=model.mesh)
        h = rms_norm(h, model.final_norm, cfg.norm_eps)
        return lm_logits(model, h), caches

    return decode_step
