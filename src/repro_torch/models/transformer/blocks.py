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

On a (data, model) mesh (``launch/mesh.py``; prefill and decode) a rank holds
its slice of each weight (``launch/sharding.py``) and the attention families
run tensor-parallel over ``model`` (M ranks, rank j):

* column-parallel ``wq``/``wk``/``wv``/``wq_b``/``wkv_b`` and the MLP's
  ``w_in``/``w_gate``: a rank computes its own heads (its own hidden
  columns); row-parallel ``wo`` and ``w_out`` then give a partial sum that
  one ``all_reduce`` over ``model`` completes;
* k/v caches sharded by head where the KV heads divide M; otherwise (MQA,
  and MLA's latents, which have no head axis) by sequence: a decode step
  gathers the new token's query of every head over ``model`` (and, for MLA,
  ``wkv_b``'s columns), runs ``attention_decode_seq`` on the rank's rows,
  keeps the rows of ``wo`` the rank holds, and writes the new row only on
  the rank that owns its slot ``pos % S_phys``;
* a column shard that does not hold whole heads (``_heads``): the leaf is
  stored by its spec but gathered whole over ``model`` for the computation
  (a counted collective), and every rank computes every head; a row shard
  of ``wo`` then takes its block of every head's output. At full width and
  M = 2 or 4 these leaves are SmolLM-135M's ``wq`` (9 heads) and
  ``wk``/``wv`` (3 KV heads) and Granite-20B's ``wk``/``wv`` (one KV head
  of 128 columns); every other ``wq``, ``wk``, ``wv``, ``wq_b`` and
  ``wkv_b`` of the eight attention configs holds whole heads there.

``gqa_apply`` and ``mla_apply`` are one function each for one rank and
for a rank of a mesh: ``launch/sharding.py::model_dim`` says which leaves
and caches are sharded (None everywhere off a mesh and at M = 1, where
``_heads`` gives the whole weight and ``_row_parallel`` sums nothing), and
the decode branches only where the cache is sharded by sequence. Train
mode runs unsharded (``model.forward`` refuses a sharded model).

Mamba2 and Hymba have no model-axis sharding (``check_mesh``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.launch.mesh import all_gather, all_reduce
from repro_torch.launch.sharding import model_dim
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.layers import (
    MASK_VALUE,
    apply_rope,
    attention_decode,
    attention_decode_seq,
    attention_flash,
    attention_full,
    init_tree,
    merge_over_model,
    mlp_apply,
    mlp_shapes,
    rms_norm,
)
from repro_torch.models.transformer.moe import check_moe, moe_apply, moe_shapes
from repro_torch.models.transformer.ssm import (
    SSM_FIXED,
    _split_proj,
    ssm_apply_decode,
    ssm_apply_train,
    ssm_shapes,
)

FLASH_THRESHOLD = 2048  # chunked-flash attention for S >= this
MODES = ("train", "prefill", "decode")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "audio", "vlm")


def check_arch(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` on a config the port cannot build: an unknown
    family, or query heads that are not a multiple of the KV heads."""
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r} {FAMILIES}")
    if cfg.family != "ssm" and (
            not cfg.num_heads or not cfg.num_kv_heads
            or cfg.num_heads % cfg.num_kv_heads):
        raise ValueError(f"{cfg.name}: query heads must be a multiple of KV heads")


def check_mesh(cfg: ArchConfig, mesh=None) -> None:
    """``check_arch``, and raise ``ValueError`` on what a step cannot run on
    ``mesh`` (None: one rank): ``opt_moe_shard_map`` without a mesh
    (``moe.check_moe``), and a model axis above 1 for the SSM and hybrid
    families, whose ``in_proj`` packs z/x/B/C/dt columns that no column
    shard splits along heads (and Hymba's 50 SSM heads divide no even M)."""
    check_arch(cfg)
    check_moe(cfg, mesh)
    if mesh is not None and mesh.model_size > 1 and cfg.family in (
            "ssm", "hybrid"):
        raise ValueError(
            f"{cfg.name}: the {cfg.family} family has no model-axis sharding "
            f"(model axis of {mesh.model_size}); ROADMAP Queue A: model-axis "
            "sharding for Mamba2 and Hymba")


def _uses_moe(cfg: ArchConfig, layer_idx: int) -> bool:
    return cfg.family == "moe" and layer_idx >= cfg.first_dense_layers


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


def _dense_ff(cfg: ArchConfig) -> int:
    """The dense MLP's width: ``d_ff``, or a MoE model's leading layers'
    ``first_dense_d_ff``."""
    if cfg.family == "moe":
        return cfg.first_dense_d_ff or cfg.d_ff
    return cfg.d_ff or cfg.first_dense_d_ff


def block_shapes(cfg: ArchConfig, layer_idx: int = 0) -> dict:
    """Layer ``layer_idx``'s parameter names and shapes, nested as
    ``block_init`` makes them, in the order it draws them. The 1-D leaves
    and the router are float32, the rest in the config's dtype
    (``layers.leaf_dtype``)."""
    d = cfg.d_model
    if cfg.family == "ssm":
        return {"ln1": (d,), "ssm": ssm_shapes(cfg)}
    p = {"ln1": (d,), "attn": _attn_shapes(cfg)}
    if cfg.family == "hybrid":
        p["ssm"] = ssm_shapes(cfg)
    p["ln2"] = (d,)
    if _uses_moe(cfg, layer_idx):
        p["moe"] = moe_shapes(cfg)
    else:
        p["mlp"] = mlp_shapes(d, _dense_ff(cfg), cfg.mlp_type)
    return p


# --------------------------------------------------------------------------- #
# Attention helpers
# --------------------------------------------------------------------------- #
def _full_attention(q, k, v, cfg):
    """Causal attention over the whole sequence (train and prefill)."""
    if q.shape[1] >= FLASH_THRESHOLD:
        return attention_flash(q, k, v, chunk=cfg.opt_flash_chunk,
                               window=cfg.attn_window)
    return attention_full(q, k, v, causal=True, window=cfg.attn_window)


def _decode_position(x, pos, S_phys):
    """(positions (B, 1), ring slot (1,), cache_len ()) of a decode step at
    ``pos`` (an int, or an integer tensor: an int32 one, as
    ``launch/input_specs.py`` makes it, is taken as int64), all on the
    device."""
    pos = torch.as_tensor(pos, device=x.device).reshape(()).long()
    return (pos.expand(x.shape[0], 1), (pos % S_phys).reshape(1),
            torch.clamp(pos + 1, max=S_phys))


def _check_decode(mode, cache, pos):
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r} {MODES}")
    if cache is None or pos is None:
        raise ValueError("decode needs a cache and a position")


# --------------------------------------------------------------------------- #
# Heads across the model axis
# --------------------------------------------------------------------------- #
def _heads(w, n_heads: int, width: int, mesh):
    """(weight, first head, heads) for the computation of a column-parallel
    attention weight whose columns are ``n_heads`` heads of ``width``: the
    weight and every head where it is whole (``model_dim`` None: no mesh,
    one model rank, or a replicated leaf); the rank's own block of heads
    where its shard holds whole heads; else the leaf gathered whole over
    ``model`` (a counted collective), every head."""
    if model_dim(w) is None:
        return w, 0, n_heads
    if n_heads % mesh.model_size == 0:
        nh = n_heads // mesh.model_size
        return w, mesh.model_index * nh, nh
    return all_gather(w, mesh, dim=-1), 0, n_heads


def _row_parallel(out, nh: int, n_heads: int, wo, mesh):
    """``out`` (B, S, nh * width), nh of ``n_heads`` heads (every head, or
    the rank's own block), times ``wo``, in ``out``'s dtype: all of ``out``
    against a whole ``wo`` (every head is then here); the rows of a sharded
    ``wo`` against its columns of ``out`` (its own heads, or its block of
    every head), summed over ``model``."""
    if model_dim(wo) is None:
        return (out @ wo).to(out.dtype)
    if nh == n_heads:
        j, R = mesh.model_index, wo.shape[0]
        out = out[..., j * R:(j + 1) * R]
    return all_reduce((out @ wo).to(out.dtype), mesh)


def _kv_for_heads(k, v, q0: int, nq: int, groups: int):
    """Every KV head ``k``, ``v`` (B, S, KV, .) narrowed to the query heads
    [q0, q0 + nq) with ``groups`` query heads a KV head: their KV heads
    where the block lies in one group (MQA) or holds whole groups, else
    one KV row a query head."""
    lo, hi = q0 // groups, (q0 + nq - 1) // groups + 1
    if hi - lo == 1 or (q0 % groups == 0 and nq % groups == 0):
        return k[:, :, lo:hi], v[:, :, lo:hi]
    sl = slice(q0, q0 + nq)
    return (k.repeat_interleave(groups, dim=2)[:, :, sl],
            v.repeat_interleave(groups, dim=2)[:, :, sl])


def _write_owned(cache, row, slot, mesh) -> None:
    """Write ``row`` (B, 1, ...) into a cache sharded by sequence at global
    slot ``slot`` (1,), in place, on the rank that owns it: every rank
    writes its clamped local slot, the others its old content back."""
    S_loc = cache.shape[1]
    local = slot - mesh.model_index * S_loc
    owned = ((local >= 0) & (local < S_loc)).reshape(
        (1, 1) + (1,) * (row.dim() - 2))
    idx = local.clamp(0, S_loc - 1)
    cache.index_copy_(1, idx, torch.where(owned, row,
                                          cache.index_select(1, idx)))


# --------------------------------------------------------------------------- #
# Attention (GQA and MLA)
# --------------------------------------------------------------------------- #
def gqa_apply(p, x, cfg: ArchConfig, *, mode: str, cache: dict | None = None,
              pos=None, mesh=None):
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

    On a rank of ``mesh`` (module docstring): the query heads are the
    rank's block where H divides M; the KV heads and the cache too where
    KV divides M; else (MQA) the rank computes every KV head and its cache
    holds rows [j * S_loc, (j + 1) * S_loc) of the S_phys = M * S_loc.
    """
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    wq, q0, nq = _heads(p["wq"], H, hd, mesh)
    wk, _, nk = _heads(p["wk"], KV, hd, mesh)
    wv, _, _ = _heads(p["wv"], KV, hd, mesh)

    def qkv(positions):
        q = (x @ wq).reshape(B, S, nq, hd)
        k = (x @ wk).reshape(B, S, nk, hd)
        v = (x @ wv).reshape(B, S, nk, hd)
        return (apply_rope(q, positions, cfg.rope_theta),
                apply_rope(k, positions, cfg.rope_theta), v)

    if mode in ("train", "prefill"):
        q, k, v = qkv(torch.arange(S, device=x.device)[None, :])
        ka, va = (k, v) if nq == H or nk != KV else _kv_for_heads(
            k, v, q0, nq, H // KV)
        out = _full_attention(q, ka, va, cfg).reshape(B, S, nq * hd)
        out = _row_parallel(out, nq, H, p["wo"], mesh).to(x.dtype)
        if mode == "train":
            return out, None
        window = cfg.attn_window
        if window is not None and window < S:
            k, v = k[:, -window:], v[:, -window:]
        return out, {"k": k, "v": v}
    _check_decode(mode, cache, pos)
    by_seq = model_dim(cache["k"]) == 1
    S_phys = cache["k"].shape[1] * (mesh.model_size if by_seq else 1)
    positions, slot, cache_len = _decode_position(x, pos, S_phys)
    q, k, v = qkv(positions)
    if by_seq:  # every head's query against the rank's rows
        _write_owned(cache["k"], k, slot, mesh)
        _write_owned(cache["v"], v, slot, mesh)
        if nq != H:
            q, nq = all_gather(q, mesh, dim=2), H
        out = attention_decode_seq(q, cache["k"], cache["v"], cache_len, mesh)
    else:
        cache["k"].index_copy_(1, slot, k)
        cache["v"].index_copy_(1, slot, v)
        out = attention_decode(q, cache["k"], cache["v"], cache_len)
    out = _row_parallel(out.reshape(B, 1, nq * hd), nq, H, p["wo"], mesh)
    return out.to(x.dtype), cache


def mla_kv_expand(p, cfg: ArchConfig, c_kv, k_rope):
    """MLA's per-head keys (B, T, H, dn + dr) and values (B, T, H, dv) from
    the latents ``c_kv`` (B, T, kv_lora) and the shared ``k_rope`` (B, T,
    dr): the two products with ``wkv_b``'s key and value columns (H the
    heads that ``p["wkv_b"]`` holds)."""
    B, T, lora = c_kv.shape
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    H = p["wkv_b"].shape[1] // (dn + dv)
    w = p["wkv_b"].view(lora, H, dn + dv)
    k_nope = (c_kv @ w[..., :dn].reshape(lora, H * dn)).view(B, T, H, dn)
    v = (c_kv @ w[..., dn:].reshape(lora, H * dv)).view(B, T, H, dv)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, T, H, dr)], dim=-1)
    return k, v


def mla_apply(p, x, cfg: ArchConfig, *, mode: str, cache: dict | None = None,
              pos=None, mesh=None):
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

    On a rank of ``mesh`` (module docstring): the latents (``wkv_a``
    replicated) are computed whole on every rank and the cache holds rows
    [j * S_loc, (j + 1) * S_loc); prefill runs the rank's heads
    (``wq``/``wq_b`` and ``wkv_b`` alike), decode every head against the
    rank's rows (``attention_decode_seq``, or with ``opt_mla_absorb`` its
    float32 einsums' partial softmax, merged over ``model``).
    """
    B, S, _ = x.shape
    H = cfg.num_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    lora = cfg.kv_lora_rank
    wq, q0, nq = _heads(p["wq_b"] if cfg.q_lora_rank else p["wq"], H,
                        dn + dr, mesh)

    def q_proj(positions):
        h = rms_norm(x @ p["wq_a"], p["q_norm"], cfg.norm_eps) \
            if cfg.q_lora_rank else x
        q = (h @ wq).reshape(B, -1, nq, dn + dr)
        q_rope = apply_rope(q[..., dn:], positions, cfg.rope_theta)
        return torch.cat([q[..., :dn], q_rope], dim=-1)

    def latents(positions):
        ckv = x @ p["wkv_a"]  # (B, S, lora + dr)
        c_kv = rms_norm(ckv[..., :lora], p["kv_norm"], cfg.norm_eps)
        k_rope = apply_rope(ckv[..., lora:][:, :, None, :], positions,
                            cfg.rope_theta)[:, :, 0, :]
        return c_kv, k_rope

    if mode in ("train", "prefill"):
        positions = torch.arange(S, device=x.device)[None, :]
        c_kv, k_rope = latents(positions)
        q = q_proj(positions)
        wkv_b, k0, nk = _heads(p["wkv_b"], H, dn + dv, mesh)
        k, v = mla_kv_expand({"wkv_b": wkv_b}, cfg, c_kv, k_rope)
        if (k0, nk) != (q0, nq):
            k, v = k[:, :, q0:q0 + nq], v[:, :, q0:q0 + nq]
        out = _full_attention(q, k, v, cfg).reshape(B, S, nq * dv)
        out = _row_parallel(out, nq, H, p["wo"], mesh).to(x.dtype)
        if mode == "train":
            return out, None
        window = cfg.attn_window
        if window is not None and window < S:
            c_kv, k_rope = c_kv[:, -window:], k_rope[:, -window:]
        return out, {"c_kv": c_kv, "k_rope": k_rope}

    _check_decode(mode, cache, pos)
    cc, cr = cache["c_kv"], cache["k_rope"]
    by_seq = model_dim(cc) == 1
    S_loc = cc.shape[1]
    j = mesh.model_index if by_seq else 0
    positions, slot, cache_len = _decode_position(
        x, pos, S_loc * (mesh.model_size if by_seq else 1))
    c_kv, k_rope = latents(positions)
    q = q_proj(positions)
    wkv_b = p["wkv_b"]
    if by_seq:  # every head's query against the rank's rows
        _write_owned(cc, c_kv, slot, mesh)
        _write_owned(cr, k_rope, slot, mesh)
        if nq != H:
            q = all_gather(q, mesh, dim=2)
        if model_dim(wkv_b) is not None:
            wkv_b = all_gather(wkv_b, mesh, dim=-1)
    else:
        cc.index_copy_(1, slot, c_kv)
        cr.index_copy_(1, slot, k_rope)
    if cfg.opt_mla_absorb:
        w = wkv_b.view(lora, H, dn + dv)
        w_k, w_v = w[..., :dn], w[..., dn:]
        q_lat = torch.einsum("bqhd,lhd->bqhl", q[..., :dn], w_k)  # (B,1,H,lora)
        s = (torch.einsum("bqhl,bsl->bhqs", q_lat.float(), cc.float())
             + torch.einsum("bqhr,bsr->bhqs", q[..., dn:].float(), cr.float())
             ) / math.sqrt(dn + dr)
        n = (cache_len - j * S_loc).clamp(0, S_loc)  # the rank's valid rows
        valid = torch.arange(S_loc, device=x.device) < n
        s = torch.where(valid, s, MASK_VALUE)
        if by_seq:  # a partial softmax over the rank's rows, then merged
            s = s[:, :, 0]  # (B, H, S_loc)
            m = s.amax(dim=-1)
            prob = torch.where(valid, torch.exp(s - m[..., None]), 0.0)
            d = prob.sum(dim=-1)
            o_lat = torch.einsum("bhs,bsl->bhl", prob, cc.float()) \
                / d.clamp(min=1e-30)[..., None]
            o = torch.einsum("bhl,lhd->bhd", o_lat, w_v.float())
            out = merge_over_model(o, m, d, mesh, q.dtype)[:, None]
        else:
            prob = torch.softmax(s, dim=-1)
            o_lat = torch.einsum("bhqs,bsl->bqhl", prob.to(cc.dtype), cc)
            out = torch.einsum("bqhl,lhd->bqhd", o_lat, w_v)  # (B,1,H,dv)
    else:
        k, v = mla_kv_expand({"wkv_b": wkv_b}, cfg, cc, cr)  # decode-time
        out = attention_decode_seq(q, k, v, cache_len, mesh) if by_seq \
            else attention_decode(q, k, v, cache_len)
    out = _row_parallel(out.reshape(B, 1, H * dv), H, H, p["wo"], mesh)
    return out.to(x.dtype), cache


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
               dtype, keep=None) -> Block:
    """One block's params (``block_shapes``, drawn by ``layers.init_tree``;
    ``keep`` as there). ``layer_idx`` only matters for a MoE model's
    leading dense layers."""
    check_arch(cfg)
    return Block(init_tree(generator, block_shapes(cfg, layer_idx), dtype,
                           fixed=SSM_FIXED, keep=keep))


def _ssm_branch(p, h, cfg, mode, cache):
    """(out, state) of the SSD layer: decode updates ``cache["state"]`` in
    place; prefill emits the final state for the decode that follows;
    train emits none."""
    if mode == "decode":
        return ssm_apply_decode(p, h, cache["state"], cfg)
    y = ssm_apply_train(p, h, cfg)
    return y, (_ssd_final_state(p, h, cfg) if mode == "prefill" else None)


def block_apply(p: Block, x, cfg: ArchConfig, *, mode: str,
                cache: dict | None = None, pos=None, mesh=None):
    """Returns (x_out, cache, aux_loss): the cache as ``init_caches`` lays
    out one layer's (``{"k","v"}``, ``{"c_kv","k_rope"}``, ``{"state"}``
    or ``{"attn", "state"}``), None in train mode; aux a float32 scalar
    (nonzero on MoE layers). On ``mesh`` ``p``, ``x`` and ``cache`` are the
    rank's slices and the attention families run tensor-parallel (module
    docstring)."""
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
    a_out, a_cache = attn_fn(p.attn, h, cfg, mode=mode, cache=cache, pos=pos,
                             mesh=mesh)
    x = x + a_out
    h2 = rms_norm(x, p.ln2, cfg.norm_eps)
    if "moe" in p:
        m_out, aux = moe_apply(p.moe, h2, cfg, mesh)
    else:
        m_out = mlp_apply(p.mlp, h2, cfg.mlp_type)
        if model_dim(p.mlp["w_out"]) is not None:
            m_out = all_reduce(m_out, mesh)  # row-parallel w_out
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
