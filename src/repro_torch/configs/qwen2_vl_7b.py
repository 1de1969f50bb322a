"""Qwen2-VL-7B [vlm] — M-RoPE, dynamic resolution (arXiv:2409.12191).

28L, d_model 3584, 28H (GQA kv=4), d_ff 18944, vocab 152064. The vision
frontend is a STUB per the assignment: ``input_specs()`` provides precomputed
patch embeddings + 3-axis (temporal, h, w) M-RoPE position ids; this config
describes the LM backbone only. head_dim 128, M-RoPE sections (16, 24, 24).
"""

from repro_torch.configs.base import Block, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        d_ff=18944,
        vocab_size=152064,
        pattern=(Block("attn", "dense"),),
        rope_type="mrope",
        rope_theta=1e6,
        mrope_sections=(16, 24, 24),
        frontend="vision_stub",
    ),
    smoke=ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=2,
        d_ff=128,
        vocab_size=256,
        pattern=(Block("attn", "dense"),),
        rope_type="mrope",
        rope_theta=1e6,
        mrope_sections=(2, 3, 3),
        frontend="vision_stub",
        scan_layers=False,
        remat="none",
    ),
)
