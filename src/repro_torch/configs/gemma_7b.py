"""Gemma-7B [arXiv:2403.08295] — GeGLU, head_dim 256, GQA kv=16.

28L, d_model 3072, 16 heads, d_ff 24576, vocab 256000, tied embeddings.
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    mlp_type="geglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    citation="arXiv:2403.08295",
))
