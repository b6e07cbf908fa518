"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small dense model.

30L, d_model 576, 9 heads (GQA kv=3), d_ff 1536, vocab 49152.
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    mlp_type="swiglu",
    rope_theta=10000.0,
    tie_embeddings=True,
    citation="hf:HuggingFaceTB/SmolLM-135M",
))
