"""xLSTM-1.3B [ssm] — sLSTM + mLSTM blocks (arXiv:2405.04517).

48L, d_model 2048, 4 heads, no separate FFN (d_ff = 0: the xLSTM block carries
its own up/down projections), vocab 50304. Block ratio mLSTM:sLSTM = 7:1
(the paper's xLSTM[7:1]), expressed as an 8-block period with the sLSTM block
in the last slot. Linear-time sequence mixing → ``long_500k`` RUNS.
"""

from repro_torch.configs.base import Block, ModelConfig, register

_PATTERN = tuple([Block("mlstm", "none")] * 7 + [Block("slstm", "none")])

CONFIG = register(
    ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        pattern=_PATTERN,
        rope_type="none",
        mlstm_expand=2,
        tie_embeddings=False,
    ),
    smoke=ModelConfig(
        name="xlstm-1.3b",
        family="ssm",
        num_layers=8,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=256,
        pattern=_PATTERN,
        rope_type="none",
        mlstm_expand=2,
        scan_layers=False,
        remat="none",
    ),
)
