"""Nemotron-4-340B [dense] — GQA + squared-ReLU (arXiv:2402.16819).

96L, d_model 18432, 96H (GQA kv=8, head_dim 192), d_ff 73728, vocab 256000.
Non-gated squared-ReLU MLP, LayerNorm, RoPE θ=1e4. The largest assigned arch —
the FSDP/ZeRO stress test of the sharding layer.
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        num_layers=96,
        d_model=18432,
        num_heads=96,
        num_kv_heads=8,
        head_dim=192,
        d_ff=73728,
        vocab_size=256000,
        pattern=(Block("attn", "dense"),),
        norm_type="layernorm",
        mlp_activation="squared_relu",
        rope_theta=1e4,
    ),
    smoke=ModelConfig(
        name="nemotron-4-340b",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=8,
        num_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab_size=256,
        pattern=(Block("attn", "dense"),),
        norm_type="layernorm",
        mlp_activation="squared_relu",
        rope_theta=1e4,
        scan_layers=False,
        remat="none",
    ),
)
