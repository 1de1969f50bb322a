"""Jamba-v0.1-52B [hybrid] — Mamba + attention 1:7 interleave, MoE (arXiv:2403.19887).

32L, d_model 4096, 32H (GQA kv=8), d_ff 14336, vocab 65536, MoE 16 experts
top-2 on every other layer. Period of 8: attention at slot 4, Mamba elsewhere;
MoE at odd slots. Hybrid (mostly linear-time) → ``long_500k`` RUNS.
"""

from repro_torch.configs.base import Block, ModelConfig, register

_PATTERN = tuple(
    Block(
        mixer="attn" if i == 4 else "mamba",
        mlp="moe" if i % 2 == 1 else "dense",
    )
    for i in range(8)
)

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        pattern=_PATTERN,
        moe_experts=16,
        moe_top_k=2,
        moe_d_ff=14336,
        rope_type="none",  # jamba uses no positional encoding (mamba provides order)
        ssm_d_state=16,
        ssm_d_conv=4,
        ssm_expand=2,
    ),
    smoke=ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=8,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=_PATTERN,
        moe_experts=4,
        moe_top_k=2,
        moe_d_ff=128,
        rope_type="none",
        ssm_d_state=8,
        ssm_d_conv=4,
        ssm_expand=2,
        scan_layers=False,
        remat="none",
    ),
)
