"""DeepSeek-V2-Lite 16B [arXiv:2405.04434] — MLA + MoE (64 routed top-6).

27L, d_model 2048, 16 heads; MLA kv_lora 512 (no q_lora), qk_nope 128,
qk_rope 64, v 128; MoE: 64 routed top-6 + 2 shared, expert d_ff 1408;
first layer dense (d_ff 10944); vocab 102400.
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=0,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=0,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    first_dense_d_ff=10944,
    vocab_size=102400,
    mlp_type="swiglu",
    rope_theta=10000.0,
    citation="arXiv:2405.04434",
))
