"""MiniCPM-2B [dense] — WSD schedule, llama-like arch (arXiv:2404.06395).

40L, d_model 2304, 36H (GQA kv=36 ⇒ MHA), d_ff 5760, vocab 122753. Tied
embeddings (MiniCPM shares input/output embeddings). The paper-distinctive
WSD (warmup-stable-decay) learning-rate schedule is
:func:`repro_torch.optim.schedule.wsd`.
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=40,
        d_model=2304,
        num_heads=36,
        num_kv_heads=36,
        d_ff=5760,
        vocab_size=122753,
        pattern=(Block("attn", "dense"),),
        rope_theta=1e4,
        tie_embeddings=True,
    ),
    smoke=ModelConfig(
        name="minicpm-2b",
        family="dense",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=256,
        pattern=(Block("attn", "dense"),),
        rope_theta=1e4,
        tie_embeddings=True,
        scan_layers=False,
        remat="none",
    ),
)
