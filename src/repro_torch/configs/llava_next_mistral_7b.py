"""LLaVA-NeXT (Mistral-7B backbone) [hf:llava-hf/llava-v1.6-mistral-7b-hf].

Backbone: 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 32000,
Mistral sliding window 4096 (native sub-quadratic serve path). The vision
tower + projector are a stub: input_specs provides pre-projected anyres
patch embeddings (576 patches/tile; DESIGN.md §4).
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    num_patches=576,
    mlp_type="swiglu",
    attn_window=4096,  # Mistral SWA
    rope_theta=10000.0,
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
))
