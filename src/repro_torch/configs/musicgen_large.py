"""MusicGen-Large [audio] — decoder-only over EnCodec tokens (arXiv:2306.05284).

48L, d_model 2048, 32H (MHA), d_ff 8192, vocab 2048 (EnCodec codebook).
Non-gated GELU MLP, LayerNorm, sinusoidal positions. The EnCodec frontend and
the 4-codebook delay-pattern interleaver are a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings; this config is the
transformer backbone.
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        d_ff=8192,
        vocab_size=2048,
        pattern=(Block("attn", "dense"),),
        norm_type="layernorm",
        mlp_activation="gelu",
        rope_type="sinusoidal",
        frontend="audio_stub",
    ),
    smoke=ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        pattern=(Block("attn", "dense"),),
        norm_type="layernorm",
        mlp_activation="gelu",
        rope_type="sinusoidal",
        frontend="audio_stub",
        scan_layers=False,
        remat="none",
    ),
)
