"""The reference's four input shapes for every architecture — the
counterpart of ``repro/launch/input_specs.py``.

On ``device="meta"`` the structs are the counterpart of
``jax.ShapeDtypeStruct``: tensors with shapes and dtypes and no storage. On
a real device they are seeded tensors drawn from an explicit
``torch.Generator``: token ids, a VLM's patch rows, and the caches'
contents (a run at a position deep in a context needs a full cache, not a
prefill of it). Decode shapes run ``make_decode_step`` (one token against a
context-length cache); ``long_500k`` on full-attention architectures
selects the documented sliding-window variant (window 8192).

``card_batch`` sizes a shape for one card: the largest batch, at most the
global one, whose weights, caches and per-step transients fit a budget.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from repro_torch.models.transformer.config import ArchConfig
from repro_torch.models.transformer.model import empty_params, init_caches

LONG_WINDOW = 8192  # documented sliding-window variant for long_500k
#: bytes of one card a run may fill (80 GB of HBM, less the allocator's
#: slack, the CUDA context and the checks a run makes beside its step)
CARD_BUDGET = 70e9


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def variant_config(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """Arch variant actually run for this shape (window for long decode)."""
    if shape.name == "long_500k":
        needs_window = (
            cfg.num_heads > 0  # has attention
            and cfg.attn_window is None  # full attention
            and cfg.family != "ssm"
        )
        if needs_window:
            return dataclasses.replace(cfg, attn_window=LONG_WINDOW)
    return cfg


def _ids(shape, vocab, device, generator):
    if generator is None:
        return torch.empty(shape, dtype=torch.int32, device=device)
    return torch.randint(0, vocab, shape, dtype=torch.int32, device=device,
                         generator=generator)


def _normal(shape, dtype, device, generator):
    t = torch.empty(shape, dtype=dtype, device=device)
    return t if generator is None else t.normal_(generator=generator)


def batch_struct(cfg: ArchConfig, B: int, S: int, device="meta",
                 generator: torch.Generator | None = None) -> dict:
    """Token batch for train/prefill: int32 ids (B, S), (B, S, nc) with
    codebooks; a VLM's ``S - num_patches`` text ids and (B, num_patches, d)
    bf16 patch rows. Seeded from ``generator`` on a real device."""
    if cfg.num_codebooks:
        return {"tokens": _ids((B, S, cfg.num_codebooks), cfg.vocab_size,
                               device, generator)}
    if cfg.num_patches:
        s_text = S - cfg.num_patches
        if s_text <= 0:
            raise ValueError(f"{S} rows leave no text after {cfg.num_patches} "
                             "patch rows")
        return {
            "tokens": _ids((B, s_text), cfg.vocab_size, device, generator),
            "patches": _normal((B, cfg.num_patches, cfg.d_model),
                               torch.bfloat16, device, generator),
        }
    return {"tokens": _ids((B, S), cfg.vocab_size, device, generator)}


def decode_batch_struct(cfg: ArchConfig, B: int, device="meta",
                        generator: torch.Generator | None = None) -> dict:
    if cfg.num_codebooks:
        return {"tokens": _ids((B, 1, cfg.num_codebooks), cfg.vocab_size,
                               device, generator)}
    return {"tokens": _ids((B, 1), cfg.vocab_size, device, generator)}


def cache_struct(cfg: ArchConfig, B: int, context_len: int, device="meta",
                 generator: torch.Generator | None = None) -> list:
    """``init_caches``' layout (one dict a layer) for ``context_len`` rows;
    on a real device every tensor standard normal from ``generator``."""
    caches = init_caches(cfg, B, context_len, device)
    if generator is not None:
        for layer in caches:
            for t in _cache_leaves(layer):
                t.normal_(generator=generator)
    return caches


def _cache_leaves(cache: dict):
    for v in cache.values():
        yield from (_cache_leaves(v) if isinstance(v, dict) else (v,))


def input_specs(cfg: ArchConfig, shape_name: str, device="meta",
                generator: torch.Generator | None = None,
                batch: int | None = None, pos: int | None = None) -> dict:
    """Everything one (arch, shape) run needs: the shape, the variant
    config, the batch, and for decode ``pos`` (a 0-d int32; ``seq_len -
    1`` unless given) and the caches. ``batch`` defaults to the shape's
    global batch."""
    shape = INPUT_SHAPES[shape_name]
    vcfg = variant_config(cfg, shape)
    B = shape.global_batch if batch is None else batch
    out = {"shape": shape, "cfg": vcfg}
    if shape.kind in ("train", "prefill"):
        out["batch"] = batch_struct(vcfg, B, shape.seq_len, device, generator)
    else:
        out["batch"] = decode_batch_struct(vcfg, B, device, generator)
        at = shape.seq_len - 1 if pos is None else pos
        out["pos"] = (torch.empty((), dtype=torch.int32, device=device)
                      if device == "meta" or str(device) == "meta"
                      else torch.tensor(at, dtype=torch.int32, device=device))
        out["caches"] = cache_struct(vcfg, B, shape.seq_len, device, generator)
    return out


# --------------------------------------------------------------------------- #
# One card's batch
# --------------------------------------------------------------------------- #
def _tensor_bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def per_sequence_bytes(cfg: ArchConfig, shape: InputShape) -> tuple[int, int]:
    """(resident, transient) bytes one sequence adds to a step of ``shape``
    on the variant config ``cfg``.

    decode: its caches (every layer), and the largest per-step temporary:
    MLA without ``opt_mla_absorb`` expands one layer's latent cache into
    per-head K (dn + dr), V (dv) and ``k_nope`` (dn) for the decode kernel;
    otherwise the logits (float32). prefill: the caches it emits, and one
    layer's largest temporaries (the MLP's or the experts' hidden rows, q
    and the repeated K and V, the fp32 flash state). train: the input of
    every layer that remat keeps, the loss's float32 logits three times
    over (logits, log-softmax, gradient) and one layer's recomputed
    activations, as prefill's."""
    item = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    S, L, d = shape.seq_len, cfg.num_layers, cfg.d_model
    H = cfg.num_heads
    nc = max(1, cfg.num_codebooks)
    if shape.kind == "decode":
        resident = _tensor_bytes(t for c in init_caches(cfg, 1, S, "meta")
                                 for t in _cache_leaves(c))
        S_phys = min(S, cfg.attn_window) if cfg.attn_window else S
        if cfg.use_mla and not cfg.opt_mla_absorb:
            dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
            transient = item * S_phys * H * (2 * dn + dr + dv)
        else:
            transient = 4 * nc * cfg.vocab_size
        return resident, transient
    kept = min(S, cfg.attn_window) if cfg.attn_window else S
    emitted = 0 if shape.kind == "train" else _tensor_bytes(
        t for c in init_caches(cfg, 1, kept, "meta") for t in _cache_leaves(c))
    ff = max(cfg.d_ff, cfg.first_dense_d_ff,
             cfg.moe_d_ff * cfg.moe_top_k * cfg.moe_capacity_factor,
             2 * cfg.d_inner if cfg.ssm_state else 0)
    qd = cfg.q_dim + 2 * H * max(cfg.head_dim, cfg.qk_nope_dim + cfg.qk_rope_dim)
    layer = item * S * (3 * ff + qd + 4 * d) + 4 * S * H * (cfg.v_head_dim
                                                            or cfg.head_dim)
    if shape.kind == "prefill":
        return emitted, layer
    logits = 3 * 4 * S * nc * cfg.vocab_size
    return item * L * S * d, layer + logits


def card_bytes(cfg: ArchConfig, shape: InputShape, batch: int) -> int:
    """``card_batch``'s estimate of a step's bytes at ``batch`` sequences:
    the weights (train: 8 bytes a parameter in bf16, weights, gradients and
    AdamW's two slots), and each sequence's resident and transient bytes
    (``per_sequence_bytes``). A run's measured peak stands beside it."""
    weights = _tensor_bytes(empty_params(cfg, "meta").parameters())
    if shape.kind == "train":
        weights *= 4
    return weights + batch * sum(per_sequence_bytes(cfg, shape))


def card_batch(cfg: ArchConfig, shape: InputShape,
               budget_bytes: float = CARD_BUDGET,
               most: int | None = None) -> tuple[int, list[str]]:
    """(batch, cuts): the largest batch, at most ``most`` (the shape's
    global batch by default), whose ``card_bytes`` fit ``budget_bytes``;
    ``cuts`` lists a cut the budget made, if any (a cut to ``most`` is the
    caller's to list). ``cfg`` is the variant config, already cut in depth.
    Raises when not even one sequence fits."""
    most = shape.global_batch if most is None else most
    weights = card_bytes(cfg, shape, 0)
    per_seq = card_bytes(cfg, shape, 1) - weights
    B = min(most, int((budget_bytes - weights) // per_seq))
    if B < 1:
        raise ValueError(
            f"{cfg.name} at {shape.name}: {weights} bytes of weights and "
            f"{per_seq} a sequence exceed {budget_bytes:.0f}")
    cuts = []
    if B < most:
        resident, transient = per_sequence_bytes(cfg, shape)
        cuts.append(
            f"batch cut from {shape.global_batch} to {B} sequences: "
            f"{weights} bytes of weights, {resident} resident and {transient} "
            f"transient bytes a sequence, within {budget_bytes:.0f} bytes")
    return B, cuts
