"""DeepSeek-V2 236B [arXiv:2405.04434] — MLA + fine-grained MoE.

60L, d_model 5120, 128 heads; MLA kv_lora 512, q_lora 1536, qk_nope 128,
qk_rope 64, v 128; MoE: 160 routed experts top-6 + 2 shared, expert d_ff
1536; first layer dense (d_ff 12288); vocab 102400.
"""
from repro_torch.models.transformer.config import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,  # MLA: per-head latents expanded from the shared cache
    head_dim=0,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=160,
    num_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    first_dense_d_ff=12288,
    vocab_size=102400,
    mlp_type="swiglu",
    rope_theta=10000.0,
    citation="arXiv:2405.04434",
))
