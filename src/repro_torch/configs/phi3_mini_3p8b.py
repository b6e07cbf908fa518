"""Phi-3-mini 3.8B [arXiv:2404.14219] — dense, RoPE + SwiGLU + GQA (kv=32).

32L, d_model 3072, 32 heads, d_ff 8192, vocab 32064.
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="phi3-mini-3.8b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32064,
    mlp_type="swiglu",
    rope_theta=10000.0,
    citation="arXiv:2404.14219",
))
