"""Hymba-1.5B [arXiv:2411.13676] — hybrid: parallel attention + mamba heads.

32L, d_model 1600, 25 heads (GQA kv=5, head_dim 64), d_ff 5504, ssm_state 16,
vocab 32001. Attention branch uses sliding windows on most layers in the
paper; our serve path exposes that via attn_window. Meta-tokens are omitted
(DESIGN.md §4).
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    mlp_type="swiglu",
    ssm_state=16,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    ssm_ngroups=1,
    attn_window=1024,  # Hymba SWA (global layers approximated as windowed)
    rope_theta=10000.0,
    citation="arXiv:2411.13676",
))
