"""CodeQwen1.5-7B [dense] — qwen1.5 arch (hf:Qwen/CodeQwen1.5-7B).

32L, d_model 4096, 32H (GQA kv=32 ⇒ MHA), d_ff 13440, vocab 92416. SwiGLU,
RMSNorm, RoPE θ=1e6 (qwen1.5 long-context base).
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        d_ff=13440,
        vocab_size=92416,
        pattern=(Block("attn", "dense"),),
        rope_theta=1e6,
    ),
    smoke=ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        pattern=(Block("attn", "dense"),),
        rope_theta=1e6,
        scan_layers=False,
        remat="none",
    ),
)
