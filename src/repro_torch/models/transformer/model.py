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
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models.transformer.blocks import (
    Block,
    block_apply,
    block_init,
    block_shapes,
    check_arch,
    leaf_dtype,
)
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import _normal, rms_norm


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _n_lead(cfg: ArchConfig) -> int:
    return cfg.first_dense_layers if cfg.family == "moe" else 0


class TransformerLM(nn.Module):
    """The model's parameters with the JAX package's names: ``embed`` (V, d)
    or, with codebooks, (nc, V, d); ``final_norm`` (d,) f32; ``lm_head``
    (d, V) or (d, nc*V) when untied; ``lead_blocks`` (a MoE model's leading
    dense layers, else empty) and ``blocks``, one ``Block`` per layer."""

    def __init__(self, cfg: ArchConfig, embed, final_norm, blocks, lm_head=None,
                 lead_blocks=()):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = nn.Parameter(lm_head) if lm_head is not None else None
        self.lead_blocks = nn.ModuleList(lead_blocks)
        self.blocks = nn.ModuleList(blocks)

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
def init_params(cfg: ArchConfig, generator: torch.Generator) -> TransformerLM:
    """Random weights drawn from ``generator`` on its device, with the JAX
    package's shapes, dtypes and scales (normal * fan_in**-0.5; norms at 1;
    the SSM's ``A_log``/``dt_bias`` the reference's own). It does not
    reproduce ``jax.random``'s bits: carry the JAX package's weights over
    with ``transformer_params_from_jax`` for parity."""
    check_arch(cfg)
    dtype = _dtype(cfg)
    d = cfg.d_model
    top = _top_shapes(cfg)
    embed = _normal(top["embed"], dtype, d, generator)
    lm_head = None if cfg.tie_embeddings else _normal(top["lm_head"], dtype, d,
                                                      generator)
    blocks = [block_init(generator, cfg, i, dtype) for i in range(cfg.num_layers)]
    n_lead = _n_lead(cfg)
    final_norm = torch.ones((d,), dtype=torch.float32, device=generator.device)
    return TransformerLM(cfg, embed, final_norm, blocks[n_lead:], lm_head,
                         blocks[:n_lead])


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
                                device) -> TransformerLM:
    """A ``TransformerLM`` holding the JAX package's parameters.

    ``np_params`` is the JAX ``init_params`` pytree as numpy arrays:
    ``embed``, ``final_norm``, ``lm_head`` when untied, ``lead_blocks`` (a
    list of unstacked blocks) for a MoE model with leading dense layers, and
    ``blocks`` with every leaf stacked on a leading layer axis (nested
    dicts: ``attn``, ``mlp``, ``moe`` with ``shared``, ``ssm``). The layer
    axis is unstacked; every name and shape is checked against the config
    (``block_shapes``; the norms, the SSM's vectors and the router float32,
    the rest in the config's dtype), and a mismatch raises ``ValueError``.
    bfloat16 crosses bit for bit.
    """
    check_arch(cfg)
    dtype = _dtype(cfg)
    n_lead = _n_lead(cfg)
    n_scan = cfg.num_layers - n_lead
    top = _top_shapes(cfg)
    names = set(top) | {"blocks"} | ({"lead_blocks"} if n_lead else set())
    if set(np_params) != names:
        raise ValueError(f"parameter names {sorted(np_params)} != {sorted(names)}")

    def take(name, value, shape):
        t = _from_numpy(value)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
        return t.to(leaf_dtype(name, shape, dtype))

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
    return model.to(device)


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def embed_tokens(model: TransformerLM, tokens: torch.Tensor,
                 patches: torch.Tensor | None = None) -> torch.Tensor:
    """(B, S) int -> (B, S, d); with codebooks (B, S, nc) int -> the sum of
    the codebooks' embeddings; with ``patches`` (B, Np, d) for a VLM, the
    patch rows prefixed -> (B, Np + S, d). No sqrt(d) scale, as in the
    reference."""
    cfg = model.cfg
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
    """(B, S, d) -> (B, S, V), or (B, S, nc, V) with codebooks."""
    cfg = model.cfg
    if model.lm_head is not None:
        w = model.lm_head
    else:
        w = model.embed.reshape(-1, cfg.d_model).T
    logits = h @ w
    if cfg.num_codebooks:
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
    layer, as ``init_caches`` lays them out. Both compute the same logits."""
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
        run = functools.partial(checkpoint, functools.partial(
            block_apply, cfg=cfg, mode=mode), use_reentrant=False,
            preserve_rng_state=False)
    else:
        run = functools.partial(block_apply, cfg=cfg, mode=mode)
    for blk in model.layers():
        h, c, a = run(blk, h)
        aux = aux + a
        if caches is not None:
            caches.append(c)
    if last_only:
        h = h[:, -1:]
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    return lm_logits(model, h), caches, aux


def make_prefill_step(cfg: ArchConfig):
    """(model, tokens, patches=None) -> (last position's logits (B, 1, V)
    or (B, 1, nc, V), caches)."""
    check_arch(cfg)

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
    token ids may be int32, as ``launch/input_specs.py`` makes them."""
    cfg = model.cfg
    logits, _, aux = forward(model, tokens, patches=patches, mode="train")
    if cfg.num_patches and patches is not None:
        logits = logits[:, patches.shape[1]:]
    logits = logits[:, :-1].float()
    loss = F.cross_entropy(logits.reshape(-1, cfg.vocab_size),
                           tokens[:, 1:].reshape(-1).long())
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def make_train_step(cfg: ArchConfig, optimizer):
    """(model, opt_state, tokens, patches=None) -> (opt_state, metrics).

    The gradients of ``lm_loss``'s total over ``list(model.parameters())``
    (a fixed order; ``optimizer.init`` takes the same list) come from
    ``torch.autograd.grad``; every parameter must get one. The optimizer
    then updates the parameters in place. ``metrics`` holds ``loss`` and
    ``aux`` as 0-d tensors on the model's device: the step makes no host
    sync. The reference returns the new params; here the model is them."""
    check_arch(cfg)
    check_remat(cfg)

    def train_step(model, opt_state, tokens, patches=None):
        params = list(model.parameters())
        total, metrics = lm_loss(model, tokens, patches)
        grads = torch.autograd.grad(total, params)
        _, opt_state = optimizer.update(list(grads), opt_state, params)
        return opt_state, {k: v.detach() for k, v in metrics.items()}

    return train_step


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def init_caches(cfg: ArchConfig, batch_size: int, context_len: int, device):
    """Zero caches for decoding against a ``context_len`` context, one dict
    per layer: ``{"k", "v"}`` (B, S_phys, KV, hd); with MLA ``{"c_kv"
    (B, S_phys, kv_lora), "k_rope" (B, S_phys, dr)}``; for SSM ``{"state"
    (B, H, N, P) float32}``; for hybrid ``{"attn": {...}, "state"}``.
    Windowed attention uses a ring buffer of ``min(context_len, window)``
    rows."""
    check_arch(cfg)
    dtype = _dtype(cfg)
    B = batch_size
    S_phys = min(context_len, cfg.attn_window) if cfg.attn_window else context_len

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

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

    return [one_layer() for _ in range(cfg.num_layers)]


def make_decode_step(cfg: ArchConfig):
    """(model, tokens (B, 1) or (B, 1, nc), pos, caches) -> (logits
    (B, 1, V) or (B, 1, nc, V), caches).

    One new token at position ``pos`` (an int, or a 0-d integer tensor on
    the device, which keeps the loop free of host syncs). Every cache is
    updated in place and returned."""
    check_arch(cfg)

    def decode_step(model, tokens, pos, caches):
        h = embed_tokens(model, tokens)
        for blk, c in zip(model.layers(), caches, strict=True):
            h, _, _ = block_apply(blk, h, cfg, mode="decode", cache=c, pos=pos)
        h = rms_norm(h, model.final_norm, cfg.norm_eps)
        return lm_logits(model, h), caches

    return decode_step
