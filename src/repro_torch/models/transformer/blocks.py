"""Per-family transformer blocks + parameter init — the counterpart of
``repro/models/transformer/blocks.py``.

Families:
  dense / audio / vlm -- [ln1 -> attention] + [ln2 -> mlp]
  moe                 -- [ln1 -> attention (MLA optional)] + [ln2 -> moe]
                         (the first ``first_dense_layers`` with a dense MLP)
  ssm                 -- [ln1 -> mamba2]
  hybrid (Hymba)      -- ln1 -> (attention || mamba2, mean-fused) + [ln2 -> mlp]

Each block runs in three modes:
  train   -- full sequence (chunked-flash attention from
             ``FLASH_THRESHOLD`` tokens), no cache; differentiable
  prefill -- the same arithmetic, and emits the KV/latent/SSM cache
  decode  -- one token against the cache (ring-buffered when windowed),
             written in place

Per-layer remat (``opt_remat``) wraps a whole block and lives in
``model.forward``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import (
    MASK_VALUE,
    _normal,
    apply_rope,
    attention_decode,
    attention_flash,
    attention_full,
    mlp_apply,
    mlp_init,
    rms_norm,
)
from repro_torch.models.transformer.moe import check_moe, moe_apply, moe_init
from repro_torch.models.transformer.ssm import (
    _split_proj,
    ssm_apply_decode,
    ssm_apply_train,
    ssm_init,
)

FLASH_THRESHOLD = 2048  # chunked-flash attention for S >= this
MODES = ("train", "prefill", "decode")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_arch(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` on a config the port cannot run: an unknown
    family, query heads that are not a multiple of the KV heads, or
    ``opt_moe_shard_map`` (a mesh-only dispatch)."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} {FAMILIES}")
    if cfg.family != "ssm" and (
            not cfg.num_heads or not cfg.num_kv_heads
            or cfg.num_heads % cfg.num_kv_heads):
        raise ValueError(f"{cfg.name}: query heads must be a multiple of KV heads")
    check_moe(cfg)


def _uses_moe(cfg: ArchConfig, layer_idx: int) -> bool:
    return cfg.family == "moe" and layer_idx >= cfg.first_dense_layers


def _mlp_shapes(d: int, f: int, mlp_type: str) -> dict:
    mlp = {"w_in": (d, f), "w_out": (f, d)}
    if mlp_type in ("swiglu", "geglu"):
        mlp["w_gate"] = (d, f)
    return mlp


def _attn_shapes(cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    if cfg.use_mla:
        qd = H * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        p = {
            "wkv_a": (d, cfg.kv_lora_rank + cfg.qk_rope_dim),
            "kv_norm": (cfg.kv_lora_rank,),
            "wkv_b": (cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim)),
            "wo": (H * cfg.v_head_dim, d),
        }
        if cfg.q_lora_rank:
            p.update(wq_a=(d, cfg.q_lora_rank), q_norm=(cfg.q_lora_rank,),
                     wq_b=(cfg.q_lora_rank, qd))
        else:
            p["wq"] = (d, qd)
        return p
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    return {"wq": (d, H * hd), "wk": (d, KV * hd), "wv": (d, KV * hd),
            "wo": (H * hd, d)}


def _ssm_shapes(cfg: ArchConfig) -> dict:
    d, di, H = cfg.d_model, cfg.d_inner, cfg.ssm_nheads
    return {"in_proj": (d, 2 * di + 2 * cfg.ssm_ngroups * cfg.ssm_state + H),
            "out_proj": (di, d), "A_log": (H,), "D": (H,), "dt_bias": (H,),
            "norm_scale": (di,)}


def _moe_shapes(cfg: ArchConfig) -> dict:
    d, f, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    p = {"router": (d, E), "w_in": (E, d, f), "w_out": (E, f, d)}
    if cfg.mlp_type in ("swiglu", "geglu"):
        p["w_gate"] = (E, d, f)
    if cfg.num_shared_experts:
        p["shared"] = _mlp_shapes(d, f * cfg.num_shared_experts, cfg.mlp_type)
    return p


def _dense_ff(cfg: ArchConfig) -> int:
    """The dense MLP's width: ``d_ff``, or a MoE model's leading layers'
    ``first_dense_d_ff``."""
    if cfg.family == "moe":
        return cfg.first_dense_d_ff or cfg.d_ff
    return cfg.d_ff or cfg.first_dense_d_ff


def block_shapes(cfg: ArchConfig, layer_idx: int = 0) -> dict:
    """Layer ``layer_idx``'s parameter names and shapes, nested as
    ``block_init`` makes them. The 1-D leaves and the router are float32,
    the rest in the config's dtype (``leaf_dtype``)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": (d,), "ssm": _ssm_shapes(cfg)}
    p = {"ln1": (d,), "attn": _attn_shapes(cfg)}
    if cfg.family == "hybrid":
        p["ssm"] = _ssm_shapes(cfg)
    p["ln2"] = (d,)
    if _uses_moe(cfg, layer_idx):
        p["moe"] = _moe_shapes(cfg)
    else:
        p["mlp"] = _mlp_shapes(d, _dense_ff(cfg), cfg.mlp_type)
    return p


def leaf_dtype(name: str, shape: tuple, dtype: torch.dtype) -> torch.dtype:
    """A parameter's dtype, as the JAX package's init makes it: float32 for
    the norms' scales, the SSM's per-head vectors and the MoE router."""
    return torch.float32 if len(shape) == 1 or name.split(".")[-1] == "router" \
        else dtype


def _norm_init(d: int, device) -> torch.Tensor:
    return torch.ones((d,), dtype=torch.float32, device=device)


# --------------------------------------------------------------------------- #
# Attention params + apply (GQA and MLA)
# --------------------------------------------------------------------------- #
def attn_init(generator: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    d = cfg.d_model
    dev = generator.device
    if cfg.use_mla:
        H = cfg.num_heads
        qd = H * (cfg.qk_nope_dim + cfg.qk_rope_dim)
        kv_b = H * (cfg.qk_nope_dim + cfg.v_head_dim)
        p = {
            "wkv_a": _normal((d, cfg.kv_lora_rank + cfg.qk_rope_dim), dtype, d,
                             generator),
            "kv_norm": _norm_init(cfg.kv_lora_rank, dev),
            "wkv_b": _normal((cfg.kv_lora_rank, kv_b), dtype, cfg.kv_lora_rank,
                             generator),
            "wo": _normal((H * cfg.v_head_dim, d), dtype, H * cfg.v_head_dim,
                          generator),
        }
        if cfg.q_lora_rank:
            p["wq_a"] = _normal((d, cfg.q_lora_rank), dtype, d, generator)
            p["q_norm"] = _norm_init(cfg.q_lora_rank, dev)
            p["wq_b"] = _normal((cfg.q_lora_rank, qd), dtype, cfg.q_lora_rank,
                                generator)
        else:
            p["wq"] = _normal((d, qd), dtype, d, generator)
        return p
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


def _full_attention(q, k, v, cfg):
    """Causal attention over the whole sequence (train and prefill)."""
    if q.shape[1] >= FLASH_THRESHOLD:
        return attention_flash(q, k, v, chunk=cfg.opt_flash_chunk,
                               window=cfg.attn_window)
    return attention_full(q, k, v, causal=True, window=cfg.attn_window)


def _decode_position(x, pos, S_phys):
    """(positions (B, 1), ring slot (1,), cache_len ()) of a decode step at
    ``pos``, all on the device."""
    pos = torch.as_tensor(pos, device=x.device).reshape(())
    return (pos.expand(x.shape[0], 1), (pos % S_phys).reshape(1),
            torch.clamp(pos + 1, max=S_phys))


def gqa_apply(p, x, cfg: ArchConfig, *, mode: str, cache: dict | None = None,
              pos=None):
    """Returns (out, cache).

    train / prefill: full causal attention over ``x (B, S, d)``
    (chunked-flash from ``FLASH_THRESHOLD`` tokens); prefill also returns
    the new cache ``{"k", "v"}`` (B, S, KV, hd) (its last
    ``cfg.attn_window`` rows when windowed), train None.

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
    if mode in ("train", "prefill"):
        positions = torch.arange(S, device=x.device)[None, :]
        q, k, v = _gqa_qkv(p, x, cfg, positions)
        out = (_full_attention(q, k, v, cfg).reshape(B, S, H * hd) @ p["wo"]
               ).to(x.dtype)
        if mode == "train":
            return out, None
        if window is not None and window < S:
            k, v = k[:, -window:], v[:, -window:]
        return out, {"k": k, "v": v}
    _check_decode(mode, cache, pos)
    positions, slot, cache_len = _decode_position(x, pos, cache["k"].shape[1])
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    cache["k"].index_copy_(1, slot, k)
    cache["v"].index_copy_(1, slot, v)
    out = attention_decode(q, cache["k"], cache["v"], cache_len)
    out = out.reshape(B, 1, H * hd)
    return (out @ p["wo"]).to(x.dtype), cache


def _check_decode(mode, cache, pos):
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r} {MODES}")
    if cache is None or pos is None:
        raise ValueError("decode needs a cache and a position")


def mla_apply(p, x, cfg: ArchConfig, *, mode: str, cache: dict | None = None,
              pos=None):
    """DeepSeek-V2 multi-head latent attention. Returns (out, cache); the
    cache holds the compressed latents ``{"c_kv" (B, S, kv_lora), "k_rope"
    (B, S, dr)}`` (None in train), written in place in decode as
    ``gqa_apply`` writes k/v.

    Keys and values are expanded from the latents by two products, one with
    ``wkv_b``'s key columns and one with its value columns, so that v comes
    out packed (B, T, H, dv), as the decode kernel takes it. The reference
    makes one product and slices v out of (B, T, H, dn + dv); the slice has
    a head stride of dn + dv, which the kernel refuses, and copying it would
    move 2 * B*T*H*dv elements more a layer and step than the copy of the
    value columns of ``wkv_b`` (2 * kv_lora*H*dv) that the second product
    costs.

    decode: with ``opt_mla_absorb`` off the latent cache is expanded and
    ``attention_decode`` (the decode kernel) runs; with it on, ``wkv_b`` is
    absorbed into the query and the scores are taken against the latent
    cache in einsums, in float32 as the reference's
    ``preferred_element_type`` has them (no decode-kernel launch).
    """
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank

    def q_proj(positions):
        if cfg.q_lora_rank:
            cq = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps)
            q = (cq @ p["wq_b"]).reshape(B, -1, H, dn + dr)
        else:
            q = (x @ p["wq"]).reshape(B, -1, H, dn + dr)
        q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
        return torch.cat([q[..., :dn], q_rope], dim=-1)

    def latents(positions):
        ckv = x @ p["wkv_a"]  # (B, S, lora + dr)
        c_kv = rms_norm(ckv[..., :lora], p["kv_norm"], cfg.norm_eps)
        k_rope = apply_rope(ckv[..., lora:][:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0, :]
        return c_kv, k_rope

    def kv_expand(c_kv, k_rope):
        # c_kv: (B, T, lora), k_rope: (B, T, dr) shared across heads
        T = c_kv.shape[1]
        w = p["wkv_b"].view(lora, H, dn + dv)
        k_nope = (c_kv @ w[..., :dn].reshape(lora, H * dn)).view(B, T, H, dn)
        v = (c_kv @ w[..., dn:].reshape(lora, H * dv)).view(B, T, H, dv)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, dr)], dim=-1)
        return k, v

    if mode in ("train", "prefill"):
        positions = torch.arange(S, device=x.device)[None, :]
        c_kv, k_rope = latents(positions)
        q = q_proj(positions)
        k, v = kv_expand(c_kv, k_rope)
        out = (_full_attention(q, k, v, cfg).reshape(B, S, H * dv) @ p["wo"]
               ).to(x.dtype)
        if mode == "train":
            return out, None
        window = cfg.attn_window
        if window is not None and window < S:
            c_kv, k_rope = c_kv[:, -window:], k_rope[:, -window:]
        return out, {"c_kv": c_kv, "k_rope": k_rope}

    _check_decode(mode, cache, pos)
    cc, cr = cache["c_kv"], cache["k_rope"]
    S_phys = cc.shape[1]
    positions, slot, cache_len = _decode_position(x, pos, S_phys)
    c_kv, k_rope = latents(positions)
    cc.index_copy_(1, slot, c_kv)
    cr.index_copy_(1, slot, k_rope)
    q = q_proj(positions)
    if cfg.opt_mla_absorb:
        w = p["wkv_b"].view(lora, H, dn + dv)
        w_k, w_v = w[..., :dn], w[..., dn:]
        q_lat = torch.einsum("bqhd,lhd->bqhl", q[..., :dn], w_k)  # (B,1,H,lora)
        s = (torch.einsum("bqhl,bsl->bhqs", q_lat.float(), cc.float())
             + torch.einsum("bqhr,bsr->bhqs", q[..., dn:].float(), cr.float())
             ) / math.sqrt(dn + dr)
        valid = torch.arange(S_phys, device=x.device) < cache_len
        s = torch.where(valid[None, None, None, :], s, MASK_VALUE)
        prob = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqs,bsl->bqhl", prob.to(cc.dtype), cc)
        out = torch.einsum("bqhl,lhd->bqhd", o_lat, w_v)  # (B,1,H,dv)
    else:
        k, v = kv_expand(cc, cr)  # decode-time expansion of the latent cache
        out = attention_decode(q, k, v, cache_len)
    out = out.reshape(B, 1, H * dv)
    return (out @ p["wo"]).to(x.dtype), cache


# --------------------------------------------------------------------------- #
# Block init / apply
# --------------------------------------------------------------------------- #
class Block(nn.Module):
    """One block's parameters with the JAX package's names, nested as its
    pytree: a tensor is a parameter, a dict of tensors an
    ``nn.ParameterDict``, a dict that holds a dict (``moe`` with ``shared``)
    another ``Block``. ``p["attn"]``, ``p.attn`` and ``"moe" in p`` all
    work. The families' names: ``ln1``, ``attn``, ``ln2``, ``mlp`` (dense,
    audio, vlm, a MoE model's leading layers), ``moe`` (its other layers),
    ``ssm`` (ssm: with ``ln1`` only; hybrid: beside ``attn``)."""

    def __init__(self, params: dict):
        super().__init__()
        for name, value in params.items():
            if not isinstance(value, dict):
                self.register_parameter(name, nn.Parameter(value))
            elif any(isinstance(v, dict) for v in value.values()):
                self.add_module(name, Block(value))
            else:
                self.add_module(name, nn.ParameterDict(value))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def block_init(generator: torch.Generator, cfg: ArchConfig, layer_idx: int,
               dtype) -> Block:
    """One block's params. ``layer_idx`` only matters for a MoE model's
    leading dense layers."""
    check_arch(cfg)
    d = cfg.d_model
    dev = generator.device
    if cfg.family == "ssm":
        return Block({"ln1": _norm_init(d, dev),
                      "ssm": ssm_init(generator, cfg, dtype)})
    p = {"ln1": _norm_init(d, dev), "attn": attn_init(generator, cfg, dtype)}
    if cfg.family == "hybrid":
        p["ssm"] = ssm_init(generator, cfg, dtype)
    p["ln2"] = _norm_init(d, dev)
    if _uses_moe(cfg, layer_idx):
        p["moe"] = moe_init(generator, cfg, dtype)
    else:
        p["mlp"] = mlp_init(generator, d, _dense_ff(cfg), cfg.mlp_type, dtype)
    return Block(p)


def _ssm_branch(p, h, cfg, mode, cache):
    """(out, state) of the SSD layer: decode updates ``cache["state"]`` in
    place; prefill emits the final state for the decode that follows;
    train emits none."""
    if mode == "decode":
        return ssm_apply_decode(p, h, cache["state"], cfg)
    y = ssm_apply_train(p, h, cfg)
    return y, (_ssd_final_state(p, h, cfg) if mode == "prefill" else None)


def block_apply(p: Block, x, cfg: ArchConfig, *, mode: str,
                cache: dict | None = None, pos=None):
    """Returns (x_out, cache, aux_loss): the cache as ``init_caches`` lays
    out one layer's (``{"k","v"}``, ``{"c_kv","k_rope"}``, ``{"state"}``
    or ``{"attn", "state"}``), None in train mode; aux a float32 scalar
    (nonzero on MoE layers)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r} {MODES}")
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    h = rms_norm(x, p.ln1, cfg.norm_eps)
    if cfg.family == "ssm":
        y, state = _ssm_branch(p.ssm, h, cfg, mode, cache)
        return x + y, (None if mode == "train" else {"state": state}), aux

    attn_fn = mla_apply if cfg.use_mla else gqa_apply
    if cfg.family == "hybrid":
        a_out, a_cache = attn_fn(p.attn, h, cfg, mode=mode,
                                 cache=(cache or {}).get("attn"), pos=pos)
        s_out, state = _ssm_branch(p.ssm, h, cfg, mode, cache)
        # parallel heads, mean-fused (Hymba fuses attn+SSM head outputs)
        x = x + 0.5 * (a_out + s_out)
        h2 = rms_norm(x, p.ln2, cfg.norm_eps)
        x = x + mlp_apply(p.mlp, h2, cfg.mlp_type)
        if mode == "train":
            return x, None, aux
        return x, {"attn": a_cache, "state": state}, aux

    # ---- attention families (dense / moe / audio / vlm) -------------------
    a_out, a_cache = attn_fn(p.attn, h, cfg, mode=mode, cache=cache, pos=pos)
    x = x + a_out
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    if "moe" in p:
        m_out, aux = moe_apply(p.moe, h2, cfg)
    else:
        m_out = mlp_apply(p.mlp, h2, cfg.mlp_type)
    return x + m_out, a_cache, aux


def _ssd_final_state(params, h, cfg):
    """Final SSM state after a full sequence (for the prefill -> decode
    handoff): state = sum_t exp(sum_{t'>t} dA_t') * dt_t * B_t x_t^T,
    (B, H, N, P) float32."""
    Bsz, S, _ = h.shape
    H, P, N, G = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state, cfg.ssm_ngroups
    proj = h @ params["in_proj"]
    _, xs, Bm, _, dt = _split_proj(proj, cfg)
    xs = xs.reshape(Bsz, S, H, P).float()
    Bh = Bm.reshape(Bsz, S, G, N).repeat_interleave(H // G, dim=2).float()
    A = -torch.exp(params["A_log"])
    dt = torch.nn.functional.softplus(dt.float() + params["dt_bias"])
    dA = dt * A  # (B, S, H)
    # suffix sums of dA, excluding t
    tail = torch.flip(torch.cumsum(torch.flip(dA, [1]), dim=1), [1]) - dA
    w = torch.exp(tail)  # (B, S, H)
    return torch.einsum("bshn,bshp->bhnp", Bh * w[..., None],
                        xs * dt[..., None])
