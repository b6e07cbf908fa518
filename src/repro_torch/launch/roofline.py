"""Roofline terms of a step on one NVIDIA H100 — the counterpart of
``repro/launch/roofline.py``, with the card's constants in place of the TPU
v5e's.

Three terms per record, in seconds:

  compute    = flops / (chips * PEAK_FLOPS)
  memory     = bytes_accessed / (chips * HBM_BW)
  collective = collectives["total"] / (chips * LINK_BW)

Where the numbers come from (the reference reads all three off XLA's
``cost_analysis`` and the compiled HLO):

* ``flops`` is counted with ``torch.utils.flop_counter.FlopCounterMode``
  over one step of the real function at the full shape (``count_flops``),
  plus, for each hand-written kernel the step launches, the kernel's own
  count from its shapes: the counter never sees a ctypes launch. The
  counter counts the products (matmuls, batched and einsum ones); XLA's
  count also holds the elementwise work, which is small beside them.
* ``bytes_accessed`` is the least traffic the step needs, from shapes
  (``step_bytes``): each input read once and each output written once. A
  measured share of it above 1.0 therefore means the count is wrong.
* ``collectives`` come from the port's own exchange counters where a path
  has them; on one card there is no exchange and the total is 0. There is
  no counterpart of ``collective_bytes_from_hlo``: the port has no HLO text
  to parse.
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

# NVIDIA H100 SXM5 80GB, per card, from NVIDIA's H100 data sheet (dense
# rates, no sparsity), at the SXM part's 700 W power limit; a card set
# below 700 W runs slower under load.
PEAK_FLOPS = 989e12  # bf16 on the tensor cores, dense
HBM_BW = 3.35e12  # bytes/s of HBM3
FP32_FLOPS = 67e12  # float32 outside the tensor cores
# 32-bit integer ops outside the tensor cores: the float32 rate counts 128
# lanes an SM at 2 ops (a fused multiply-add); Hopper's SM has 64 INT32 lanes
INT32_OPS = FP32_FLOPS / 4
LINK_BW = 450e9  # bytes/s one direction of NVLink 4 (900 GB/s both ways)

_TERMS = {"t_compute_s": "compute", "t_memory_s": "memory",
          "t_collective_s": "collective"}


def tokens_for(record: dict) -> int:
    """Tokens a step of the record's shape handles: one a sequence in
    decode, every row of every sequence otherwise, at the record's ``batch``
    (one card's) or, without one, the shape's global batch, and its
    ``rows`` a sequence where it has them (a run at another length)."""
    from repro_torch.launch.input_specs import INPUT_SHAPES

    shp = INPUT_SHAPES[record["shape"]]
    batch = record.get("batch") or shp.global_batch
    if shp.kind == "decode":
        return batch
    return batch * record.get("rows", shp.seq_len)


def roofline_terms(record: dict) -> dict:
    """The three terms (seconds) and the dominant bottleneck of a record
    with ``flops``, ``bytes_accessed`` and ``collectives["total"]`` per card,
    ``chips``, ``kind``, ``shape`` and ``active_params``; also
    ``model_flops`` (6 x active parameters x tokens for train, 2 x for
    prefill and decode) and ``useful_flops_ratio`` (``model_flops`` over
    the counted flops of every card)."""
    terms = {
        "t_compute_s": record["flops"] / PEAK_FLOPS,
        "t_memory_s": record["bytes_accessed"] / HBM_BW,
        "t_collective_s": record["collectives"]["total"] / LINK_BW,
    }
    terms["bottleneck"] = _TERMS[max(_TERMS, key=terms.get)]
    mult = 6.0 if record["kind"] == "train" else 2.0
    model_flops = mult * record.get("active_params", 0) * tokens_for(record)
    terms["model_flops"] = model_flops
    counted = record["flops"] * record["chips"]
    terms["useful_flops_ratio"] = model_flops / counted if counted else 0.0
    return terms


def roofline_share(terms: dict, seconds: float) -> float:
    """The largest term over the measured step time: the share of the
    card's least time the step reached."""
    return max(terms[t] for t in _TERMS) / seconds


def kernel_bound(nbytes: float, ops: float, rate: float = FP32_FLOPS):
    """(ms, "bytes" or "operations"): the least time of a kernel, the larger
    of its bytes over ``HBM_BW`` and its operations over ``rate``."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def mfu(model_flops: float, seconds: float) -> float:
    """Model flops utilisation: ``model_flops`` over ``seconds`` at the bf16
    peak, a share of the whole step."""
    return model_flops / (seconds * PEAK_FLOPS)


def count_flops(fn, *args, **kwargs):
    """(fn's result, the products' flops ``FlopCounterMode`` counted while
    it ran). On ``meta`` tensors nothing runs but shapes; on a card the
    counted call is a real one (a hand-written kernel's launches are not in
    the count)."""
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, counter.get_total_flops()


# --------------------------------------------------------------------------- #
# Least bytes of a step
# --------------------------------------------------------------------------- #
_EXPERT_LEAVES = ("moe.w_in", "moe.w_gate", "moe.w_out")


def weight_bytes(model, tokens: int) -> int:
    """Bytes of the weights a step over ``tokens`` tokens must read, once:
    every leaf whole, but a MoE layer's routed experts only as many as the
    tokens can reach (tokens x top-k, at most E) and an untied embedding's
    gathered rows only (one a token and codebook)."""
    cfg = model.cfg
    total = 0
    for name, p in model.named_parameters():
        n = p.numel()
        if name.endswith(_EXPERT_LEAVES):
            E = cfg.num_experts
            n = n // E * min(E, tokens * cfg.moe_top_k)
        elif name == "embed" and not cfg.tie_embeddings:
            n = min(n, tokens * max(1, cfg.num_codebooks) * cfg.d_model)
        total += n * p.element_size()
    return total


def cache_row_bytes(cfg) -> int:
    """Bytes of one cache row of one layer and sequence: k and v, or MLA's
    latent and rope key; 0 for an SSM layer."""
    item = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    if cfg.family == "ssm":
        return 0
    if cfg.use_mla:
        return item * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    return item * 2 * cfg.num_kv_heads * cfg.head_dim


def state_bytes(cfg) -> int:
    """Bytes of one layer's SSM state for one sequence (float32); 0 without
    an SSM."""
    if cfg.family not in ("ssm", "hybrid"):
        return 0
    return 4 * cfg.ssm_nheads * cfg.ssm_state * cfg.ssm_headdim


def step_bytes(model, kind: str, batch: int, rows: int,
               cache_len: int = 0) -> int:
    """The least bytes one step moves (each input read once, each output
    written once):

    * train: the weights read once, the gradients written once, and AdamW's
      reads of p, g, m, v and writes of p, m, v (each in the leaf's dtype);
    * prefill over ``rows`` rows a sequence: the weights, the caches it
      emits (the last ``attn_window`` rows when windowed) and the SSM states
      written, the logits of the last row written;
    * decode at ``cache_len`` valid rows: the weights, each layer's cache
      read up to ``cache_len`` and one row written, the SSM states read and
      written, the logits written.

    Token ids (int32) and a VLM's patch rows are read once."""
    cfg = model.cfg
    item = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    nc = max(1, cfg.num_codebooks)
    L = cfg.num_layers
    tokens = batch if kind == "decode" else batch * rows
    text = rows - cfg.num_patches if kind != "decode" else 1
    inputs = 4 * batch * text * nc
    if cfg.num_patches and kind != "decode":
        inputs += 2 * batch * cfg.num_patches * cfg.d_model
    if kind == "train":
        params = sum(p.numel() * p.element_size() for p in model.parameters())
        return inputs + 9 * params
    out = item * batch * nc * cfg.vocab_size  # the last row's logits
    weights = weight_bytes(model, tokens)
    if kind == "prefill":
        kept = min(rows, cfg.attn_window) if cfg.attn_window else rows
        caches = L * batch * (kept * cache_row_bytes(cfg) + state_bytes(cfg))
    else:
        caches = L * batch * ((cache_len + 1) * cache_row_bytes(cfg)
                              + 2 * state_bytes(cfg))
    return inputs + weights + caches + out
