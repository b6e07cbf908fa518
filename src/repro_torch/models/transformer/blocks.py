"""Transformer blocks + parameter init — the counterpart of
``repro/models/transformer/blocks.py`` for the dense family:
[ln1 -> GQA attention] + [ln2 -> MLP], in prefill and decode mode.

A config of another family (MoE/MLA, SSM, hybrid, audio, VLM) raises
``ValueError`` naming it: those blocks come with later slices of the port.
The train mode (chunked-flash attention, no cache) comes with the train step.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import (
    _normal,
    apply_rope,
    attention_decode,
    attention_flash,
    attention_full,
    mlp_apply,
    mlp_init,
    rms_norm,
)

FLASH_THRESHOLD = 2048  # chunked-flash attention for S >= this
MODES = ("prefill", "decode")


def check_arch(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is of the dense family, the one
    the port runs."""
    other = [
        name for name, on in (
            ("MLA", cfg.use_mla), ("MoE experts", cfg.num_experts),
            ("SSM state", cfg.ssm_state), ("audio codebooks", cfg.num_codebooks),
            ("VLM patches", cfg.num_patches),
        ) if on
    ]
    if cfg.family != "dense" or other:
        raise ValueError(
            f"{cfg.name}: family {cfg.family!r}"
            + (f" with {', '.join(other)}" if other else "")
            + " is not ported yet; the port runs the dense family only"
        )
    if not cfg.num_heads or cfg.num_heads % cfg.num_kv_heads:
        raise ValueError(f"{cfg.name}: query heads must be a multiple of KV heads")


def block_shapes(cfg: ArchConfig) -> dict:
    """One dense block's parameter names and shapes, as ``block_init``
    makes them (the norms are float32, the rest in the config's dtype)."""
    d, f = cfg.d_model, cfg.d_ff
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    mlp = {"w_in": (d, f), "w_out": (f, d)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        mlp["w_gate"] = (d, f)
    return {
        "ln1": (d,),
        "attn": {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
                 "wo": (H * hd, d)},
        "ln2": (d,),
        "mlp": mlp,
    }


def _norm_init(d: int) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32)


# --------------------------------------------------------------------------- #
# Attention params + apply (GQA)
# --------------------------------------------------------------------------- #
def attn_init(generator: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    if cfg.use_mla:
        raise ValueError(f"{cfg.name}: MLA attention is not ported yet")
    d = cfg.d_model
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": _normal((d, H * hd), dtype, d, generator),
        "wk": _normal((d, KV * hd), dtype, d, generator),
        "wv": _normal((d, KV * hd), dtype, d, generator),
        "wo": _normal((H * hd, d), dtype, H * hd, generator),
    }


def _gqa_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def gqa_apply(p, x, cfg: ArchConfig, *, mode: str, cache: dict | None = None,
              pos=None):
    """Returns (out, cache).

    prefill: full causal attention over ``x (B, S, d)`` (chunked-flash from
    ``FLASH_THRESHOLD`` tokens), and the new cache ``{"k", "v"}`` (B, S, KV,
    hd) (its last ``cfg.attn_window`` rows when windowed).

    decode: one token against ``cache`` at position ``pos`` (an int or a
    0-d integer tensor on the device). The new k/v row is written **in
    place** into ``cache`` at ``slot = pos % S_phys`` (``index_copy_``), and
    the same dict is returned: JAX's ``dynamic_update_slice`` is functional,
    and copying the whole cache per layer per token is what writing in place
    avoids. ``cache_len = min(pos + 1, S_phys)`` stays a device value, so a
    decode loop that keeps ``pos`` on the device makes no host sync.
    """
    B, S, _ = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    window = cfg.attn_window
    if mode == "prefill":
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = _gqa_qkv(p, x, cfg, positions)
        if S >= FLASH_THRESHOLD:
            out = attention_flash(q, k, v, chunk=cfg.opt_flash_chunk,
                                  window=window)
        else:
            out = attention_full(q, k, v, causal=True, window=window)
        ck, cv = k, v
        if window is not None and window < S:
            ck, cv = k[:, -window:], v[:, -window:]
        out = out.reshape(B, S, H * hd)
        return (out @ p["wo"]).to(x.dtype), {"k": ck, "v": cv}
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r} {MODES}")
    if cache is None or pos is None:
        raise ValueError("decode needs a cache and a position")
    S_phys = cache["k"].shape[1]
    pos = torch.as_tensor(pos, device=x.device).reshape(())
    positions = pos.expand(B, 1)
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    slot = (pos % S_phys).reshape(1)
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    cache_len = torch.clamp(pos + 1, max=S_phys)
    out = attention_decode(q, cache["k"], cache["v"], cache_len)
    out = out.reshape(B, 1, H * hd)
    return (out @ p["wo"]).to(x.dtype), cache


# --------------------------------------------------------------------------- #
# Block init / apply
# --------------------------------------------------------------------------- #
class Block(nn.Module):
    """One dense block's parameters with the JAX package's names:
    ``ln1``, ``attn.{wq,wk,wv,wo}``, ``ln2``, ``mlp.{w_in,w_out[,w_gate]}``."""

    def __init__(self, params: dict):
        super().__init__()
        self.ln1 = nn.Parameter(params["ln1"])
        self.attn = nn.ParameterDict(params["attn"])
        self.ln2 = nn.Parameter(params["ln2"])
        self.mlp = nn.ParameterDict(params["mlp"])


def block_init(generator: torch.Generator, cfg: ArchConfig, dtype) -> Block:
    check_arch(cfg)
    d = cfg.d_model
    return Block({
        "ln1": _norm_init(d).to(generator.device),
        "attn": attn_init(generator, cfg, dtype),
        "ln2": _norm_init(d).to(generator.device),
        "mlp": mlp_init(generator, d, cfg.d_ff, cfg.mlp_type, dtype),
    })


def block_apply(p: Block, x, cfg: ArchConfig, *, mode: str,
                cache: dict | None = None, pos=None):
    """Returns (x_out, cache): the attention family's branch with a dense
    MLP, as the JAX ``block_apply`` has it for the dense family."""
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    a_out, a_cache = gqa_apply(p.attn, h, cfg, mode=mode, cache=cache, pos=pos)
    x = x + a_out
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    x = x + mlp_apply(p.mlp, h2, cfg.mlp_type)
    return x, a_cache
