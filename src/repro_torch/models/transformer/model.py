"""Transformer LM: init / prefill / decode for the dense family — the
counterpart of ``repro/models/transformer/model.py``.

The JAX package stacks the blocks and runs them with ``lax.scan``; here they
are an ``nn.ModuleList`` run by a Python loop. Caches are a list with one
``{"k", "v"}`` dict per layer (the JAX package stacks them on a leading layer
axis). Train mode, ``lm_loss`` and the train step come with the train slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.models.transformer.blocks import (
    Block,
    block_apply,
    block_init,
    block_shapes,
    check_arch,
)
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import _normal, rms_norm


def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


class TransformerLM(nn.Module):
    """The model's parameters with the JAX package's names: ``embed`` (V, d),
    ``final_norm`` (d,) f32, ``lm_head`` (d, V) when untied, and ``blocks``,
    one ``Block`` per layer."""

    def __init__(self, cfg: ArchConfig, embed, final_norm, blocks, lm_head=None):
        super().__init__()
        self.cfg = cfg
        self.embed = nn.Parameter(embed)
        self.final_norm = nn.Parameter(final_norm)
        self.lm_head = nn.Parameter(lm_head) if lm_head is not None else None
        self.blocks = nn.ModuleList(blocks)


# --------------------------------------------------------------------------- #
# Params
# --------------------------------------------------------------------------- #
def init_params(cfg: ArchConfig, generator: torch.Generator) -> TransformerLM:
    """Random weights drawn from ``generator`` on its device, with the JAX
    package's shapes, dtypes and scales (normal * fan_in**-0.5; norms at 1).
    It does not reproduce ``jax.random``'s bits: carry the JAX package's
    weights over with ``transformer_params_from_jax`` for parity."""
    check_arch(cfg)
    dtype = _dtype(cfg)
    d, V = cfg.d_model, cfg.vocab_size
    embed = _normal((V, d), dtype, d, generator)
    lm_head = None if cfg.tie_embeddings else _normal((d, V), dtype, d, generator)
    blocks = [block_init(generator, cfg, dtype) for _ in range(cfg.num_layers)]
    final_norm = torch.ones((d,), dtype=torch.float32, device=generator.device)
    return TransformerLM(cfg, embed, final_norm, blocks, lm_head)


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


def transformer_params_from_jax(np_params: dict, cfg: ArchConfig,
                                device) -> TransformerLM:
    """A ``TransformerLM`` holding the JAX package's parameters.

    ``np_params`` is the JAX ``init_params`` pytree as numpy arrays:
    ``embed``, ``final_norm``, ``lm_head`` when untied, and ``blocks`` with
    every leaf stacked on a leading layer axis. The layer axis is unstacked;
    every name and shape is checked against the config (norms float32, the
    rest in the config's dtype), and a mismatch raises ``ValueError``.
    """
    check_arch(cfg)
    dtype = _dtype(cfg)
    d, V, L = cfg.d_model, cfg.vocab_size, cfg.num_layers
    top = {"embed": (V, d), "final_norm": (d,)}
    if not cfg.tie_embeddings:
        top["lm_head"] = (d, V)
    if set(np_params) != set(top) | {"blocks"}:
        raise ValueError(
            f"parameter names {sorted(np_params)} != {sorted(top) + ['blocks']}"
        )

    def take(name, value, shape):
        t = _from_numpy(value)
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
        return t.to(torch.float32 if len(shape) == 1 else dtype)

    stacked = _flatten(np_params["blocks"])
    want = _flatten(block_shapes(cfg))
    if set(stacked) != set(want):
        raise ValueError(f"block parameters {sorted(stacked)} != {sorted(want)}")
    blocks = []
    for i in range(L):
        flat = {}
        for name, shape in want.items():
            value = np.asarray(stacked[name])
            if value.shape[:1] != (L,):
                raise ValueError(
                    f"blocks.{name}: {value.shape[:1]} stacked layers, the "
                    f"config has {L}"
                )
            flat[name] = take(f"blocks.{name}[{i}]", value[i], shape)
        blocks.append(Block({
            "ln1": flat["ln1"], "ln2": flat["ln2"],
            "attn": {n.split(".")[1]: t for n, t in flat.items()
                     if n.startswith("attn.")},
            "mlp": {n.split(".")[1]: t for n, t in flat.items()
                    if n.startswith("mlp.")},
        }))
    model = TransformerLM(
        cfg, *(take(n, np_params[n], top[n]) for n in ("embed", "final_norm")),
        blocks,
        None if cfg.tie_embeddings
        else take("lm_head", np_params["lm_head"], top["lm_head"]),
    )
    return model.to(device)


# --------------------------------------------------------------------------- #
# Embedding / head
# --------------------------------------------------------------------------- #
def embed_tokens(model: TransformerLM, tokens: torch.Tensor) -> torch.Tensor:
    """(B, S) int -> (B, S, d); no sqrt(d) scale, as in the reference."""
    return model.embed[tokens]


def lm_logits(model: TransformerLM, h: torch.Tensor) -> torch.Tensor:
    w = model.lm_head if model.lm_head is not None else model.embed.T
    return h @ w


# --------------------------------------------------------------------------- #
# Forward (prefill)
# --------------------------------------------------------------------------- #
def forward(model: TransformerLM, tokens: torch.Tensor, *, last_only: bool = False):
    """Prefill over ``tokens (B, S)`` -> (logits, caches): logits (B, S, V),
    or (B, 1, V) of the last position with ``last_only`` (the same function:
    the head runs on that row only); caches one ``{"k", "v"}`` per layer."""
    cfg = model.cfg
    h = embed_tokens(model, tokens)
    caches = []
    for blk in model.blocks:
        h, c = block_apply(blk, h, cfg, mode="prefill")
        caches.append(c)
    if last_only:
        h = h[:, -1:]
    h = rms_norm(h, model.final_norm, cfg.norm_eps)
    return lm_logits(model, h), caches


def make_prefill_step(cfg: ArchConfig):
    """(model, tokens) -> (last position's logits (B, 1, V), caches)."""
    check_arch(cfg)

    def prefill_step(model, tokens):
        return forward(model, tokens, last_only=True)

    return prefill_step


# --------------------------------------------------------------------------- #
# Decode
# --------------------------------------------------------------------------- #
def init_caches(cfg: ArchConfig, batch_size: int, context_len: int, device):
    """Zero caches for decoding against a ``context_len`` context, one
    ``{"k", "v"}`` of (B, S_phys, KV, hd) per layer; windowed attention
    uses a ring buffer of ``min(context_len, window)`` rows."""
    check_arch(cfg)
    S_phys = min(context_len, cfg.attn_window) if cfg.attn_window else context_len
    shape = (batch_size, S_phys, cfg.num_kv_heads, cfg.head_dim)
    return [
        {n: torch.zeros(shape, dtype=_dtype(cfg), device=device) for n in ("k", "v")}
        for _ in range(cfg.num_layers)
    ]


def make_decode_step(cfg: ArchConfig):
    """(model, tokens (B, 1), pos, caches) -> (logits (B, 1, V), caches).

    One new token at position ``pos`` (an int, or a 0-d integer tensor on
    the device, which keeps the loop free of host syncs). The caches are
    updated in place and returned."""
    check_arch(cfg)

    def decode_step(model, tokens, pos, caches):
        h = embed_tokens(model, tokens)
        for blk, c in zip(model.blocks, caches, strict=True):
            h, _ = block_apply(blk, h, cfg, mode="decode", cache=c, pos=pos)
        h = rms_norm(h, model.final_norm, cfg.norm_eps)
        return lm_logits(model, h), caches

    return decode_step
