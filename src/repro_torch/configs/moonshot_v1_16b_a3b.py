"""Moonlight-16B-A3B [moe] — kimi/moonlight (hf:moonshotai/Moonlight-16B-A3B).

48L, d_model 2048, 16H (GQA kv=16 ⇒ MHA), per-expert d_ff 1408, vocab 163840,
MoE 64 experts top-6 (+2 shared experts per the HF config's deepseek-style
arch; the assignment line lists the routed 64e top-6).
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=163840,
        pattern=(Block("attn", "moe"),),
        moe_experts=64,
        moe_top_k=6,
        moe_shared_experts=2,
        moe_d_ff=1408,
        rope_theta=5e4,
    ),
    smoke=ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=256,
        pattern=(Block("attn", "moe"),),
        moe_experts=8,
        moe_top_k=2,
        moe_shared_experts=2,
        moe_d_ff=64,
        rope_theta=5e4,
        scan_layers=False,
        remat="none",
    ),
)
