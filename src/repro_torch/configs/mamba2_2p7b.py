"""Mamba2-2.7B [arXiv:2405.21060] — attention-free SSD (state-space duality).

64L, d_model 2560, ssm_state 128, expand 2 (d_inner 5120), headdim 64,
vocab 50280. Sub-quadratic: runs long_500k natively.
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_headdim=64,
    ssm_chunk=128,
    ssm_ngroups=1,
    citation="arXiv:2405.21060",
))
