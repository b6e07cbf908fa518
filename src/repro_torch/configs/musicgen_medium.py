"""MusicGen-medium [arXiv:2306.05284] — decoder-only over EnCodec tokens.

48L, d_model 1536, 24 heads (kv=24), d_ff 6144, vocab 2048 per codebook,
4 codebooks (summed embeddings, 4 output heads). The EnCodec frontend is a
stub: input_specs provides the 4-codebook token grid (DESIGN.md §4).
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    num_codebooks=4,
    mlp_type="mlp",  # MusicGen uses standard GELU FFN
    rope_theta=10000.0,
    citation="arXiv:2306.05284",
))
