"""Granite-20B (code) [arXiv:2405.04324] — llama-arch with MQA (kv=1).

52L, d_model 6144, 48 heads, d_ff 24576 (non-gated GELU MLP, 4x — the gated
variant would overshoot 20B params), vocab 49152.
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    head_dim=128,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="mlp",
    rope_theta=10000.0,
    citation="arXiv:2405.04324",
))
