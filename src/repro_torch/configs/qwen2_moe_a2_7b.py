"""Qwen1.5-MoE-A2.7B [moe] — 4 shared + 60 routed top-4 (hf:Qwen/Qwen1.5-MoE-A2.7B).

24L, d_model 2048, 16H (GQA kv=16 ⇒ MHA), per-expert d_ff 1408, vocab 151936,
MoE 60 routed experts top-4 plus shared capacity equal to 4 experts (the HF
config's shared_expert_intermediate_size = 4 × 1408).
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1408,
        vocab_size=151936,
        pattern=(Block("attn", "moe"),),
        moe_experts=60,
        moe_top_k=4,
        moe_shared_experts=4,
        moe_d_ff=1408,
        rope_theta=1e6,
    ),
    smoke=ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=64,
        vocab_size=256,
        pattern=(Block("attn", "moe"),),
        moe_experts=6,
        moe_top_k=2,
        moe_shared_experts=2,
        moe_d_ff=64,
        rope_theta=1e6,
        scan_layers=False,
        remat="none",
    ),
)
