"""StarCoder2-15B [dense] — GQA + RoPE (arXiv:2402.19173).

40L, d_model 6144, 48H (GQA kv=4), d_ff 24576, vocab 49152. Non-gated GELU
MLP, LayerNorm, RoPE θ=1e5.
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=40,
        d_model=6144,
        num_heads=48,
        num_kv_heads=4,
        d_ff=24576,
        vocab_size=49152,
        pattern=(Block("attn", "dense"),),
        norm_type="layernorm",
        mlp_activation="gelu",
        rope_theta=1e5,
    ),
    smoke=ModelConfig(
        name="starcoder2-15b",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=(Block("attn", "dense"),),
        norm_type="layernorm",
        mlp_activation="gelu",
        rope_theta=1e5,
        scan_layers=False,
        remat="none",
    ),
)
