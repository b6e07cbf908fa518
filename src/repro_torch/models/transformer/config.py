"""Architecture configuration — a copy of ``repro/models/transformer/config.py``.

One dataclass spans every family of the JAX package (dense / MoE(+MLA) / SSM
/ hybrid / audio / VLM), with all its fields, so the per-arch files of
``repro_torch/configs/`` are the JAX package's unchanged.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    vocab_size: int

    # ---- attention -------------------------------------------------------
    num_heads: int = 0  # 0 = attention-free (pure SSM)
    num_kv_heads: int = 0
    head_dim: int = 0
    rope_theta: float = 10000.0
    attn_window: int | None = None  # sliding-window size (serve path)

    # ---- MLP -------------------------------------------------------------
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | geglu | mlp(gelu, non-gated)

    # ---- MLA (DeepSeek-V2) -------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # ---- MoE ---------------------------------------------------------------
    num_experts: int = 0  # routed experts
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert ffn width
    first_dense_layers: int = 0  # leading dense layers (DeepSeek-V2 layer 0)
    first_dense_d_ff: int = 0  # their FFN width
    moe_capacity_factor: float = 1.25

    # ---- SSM (Mamba2 / hybrid) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128
    ssm_ngroups: int = 1

    # ---- modality frontends (stubs; see DESIGN.md) ---------------------------
    num_codebooks: int = 0  # audio (MusicGen/EnCodec)
    num_patches: int = 0  # vlm (pre-projected patch embeddings)

    # ---- numerics / embedding ------------------------------------------------
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-6

    # ---- beyond-paper performance toggles (EXPERIMENTS.md §Perf) -------------
    # All default OFF so the paper-faithful baseline is what lowers by default.
    opt_moe_shard_hints: bool = False  # expert-dim sharding constraints
    opt_mla_absorb: bool = False  # MLA decode in latent space (no kv expand)
    opt_remat: str = "full"  # full | none — per-layer activation remat
    opt_flash_chunk: int = 1024  # flash KV/Q chunk (score traffic ~ S^2/chunk)
    opt_moe_shard_map: bool = False  # expert-local shard_map dispatch (§Perf A4)

    citation: str = ""

    # ------------------------------------------------------------------ #
    @property
    def d_inner(self) -> int:  # SSM inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.d_inner // self.ssm_headdim if self.ssm_headdim else 0

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.num_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.num_heads * self.head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + blocks), for 6ND flops."""
        d = self.d_model
        n = 0
        nc = max(1, self.num_codebooks)
        n += self.vocab_size * d * nc  # embedding(s)
        if not self.tie_embeddings:
            n += self.vocab_size * d * nc  # output head(s)
        per_layer = 0
        if self.num_heads:
            if self.use_mla:
                qd = self.q_dim
                per_layer += (
                    (d * self.q_lora_rank + self.q_lora_rank * qd)
                    if self.q_lora_rank
                    else d * qd
                )
                per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
                per_layer += self.kv_lora_rank * self.num_heads * (
                    self.qk_nope_dim + self.v_head_dim
                )
                per_layer += self.num_heads * self.v_head_dim * d
            else:
                hd = self.head_dim
                per_layer += d * self.num_heads * hd  # q
                per_layer += 2 * d * self.num_kv_heads * hd  # k, v
                per_layer += self.num_heads * hd * d  # o
        if self.ssm_state:
            di = self.d_inner
            # in_proj: x, z, B, C, dt ; out_proj
            bc = 2 * self.ssm_ngroups * self.ssm_state
            per_layer += d * (2 * di + bc + self.ssm_nheads)
            per_layer += di * d
            per_layer += 3 * self.ssm_nheads  # A, D, dt_bias
        if self.num_experts:
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            per_layer += self.num_experts * mult * d * self.moe_d_ff
            per_layer += self.num_shared_experts * mult * d * self.moe_d_ff
            per_layer += d * self.num_experts  # router
        elif self.d_ff:
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            per_layer += mult * d * self.d_ff
        n += self.num_layers * per_layer
        if self.first_dense_layers and self.num_experts:
            # leading layers use a dense FFN (width first_dense_d_ff), not MoE
            mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
            moe_part = (
                (self.num_experts + self.num_shared_experts)
                * mult * d * self.moe_d_ff
                + d * self.num_experts
            )
            dense_part = mult * d * (self.first_dense_d_ff or self.moe_d_ff)
            n += self.first_dense_layers * (dense_part - moe_part)
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.num_experts:
            return self.param_count()
        full = self.param_count()
        mult = 3 if self.mlp_type in ("swiglu", "geglu") else 2
        inactive = (
            (self.num_experts - self.moe_top_k)
            * mult
            * self.d_model
            * self.moe_d_ff
        )
        moe_layers = self.num_layers - self.first_dense_layers
        return full - moe_layers * inactive

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: <=2 layers, d_model<=512, <=4 experts."""
        base = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            vocab_size=min(self.vocab_size, 1024),
        )
        if self.num_heads:
            hd = 32
            nh = max(2, min(4, self.num_heads))
            nkv = max(1, min(self.num_kv_heads, nh))
            while nh % nkv:  # GQA requires kv | heads
                nkv -= 1
            base.update(num_heads=nh, num_kv_heads=nkv, head_dim=hd)
        if self.use_mla:
            base.update(
                kv_lora_rank=64, q_lora_rank=48 if self.q_lora_rank else 0,
                qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32,
            )
        if self.d_ff:
            base.update(d_ff=min(self.d_ff, 512))
        if self.num_experts:
            base.update(
                num_experts=4,
                num_shared_experts=min(self.num_shared_experts, 1),
                moe_top_k=2,
                moe_d_ff=128,
                first_dense_layers=min(self.first_dense_layers, 1),
            )
        if self.ssm_state:
            base.update(ssm_state=min(self.ssm_state, 16), ssm_headdim=32,
                        ssm_chunk=16)
        if self.num_patches:
            base.update(num_patches=16)
        base.update(dtype="float32")
        base.update(**overrides)
        return dataclasses.replace(self, **base)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401  (populates the registry)
    return _REGISTRY[name]


def list_archs() -> list[str]:
    if not _REGISTRY:
        import repro_torch.configs  # noqa: F401
    return sorted(_REGISTRY)
