"""Model/config schema shared by all assigned architectures.

A model is a stack of residual blocks; each block is (mixer, mlp) where
mixer ∈ {attn, mamba, mlstm, slstm} and mlp ∈ {dense, moe, none}. Heterogeneous
stacks (jamba's 1:7 attn:mamba interleave, xlstm's 7:1 mLSTM:sLSTM) are
expressed as a repeating *period* of block descriptors; the model scans over
periods so HLO size is O(period), not O(depth).

Input shapes are the assignment's four cells; ``long_500k`` only applies to
sub-quadratic families (ssm/hybrid) — see DESIGN.md §4.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Iterable

__all__ = ["Block", "ModelConfig", "ShapeSpec", "SHAPES", "register", "get_config", "list_configs",
           "CARD_LAYERS", "card_config"]


@dataclasses.dataclass(frozen=True)
class Block:
    """One residual block position within the repeating period."""

    mixer: str = "attn"     # attn | mamba | mlstm | slstm
    mlp: str = "dense"      # dense | moe | none


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    pattern: tuple[Block, ...] = (Block(),)   # repeating period
    head_dim: int = 0              # 0 -> d_model // num_heads

    # norm / activation
    norm_type: str = "rmsnorm"     # rmsnorm | layernorm
    norm_eps: float = 1e-5
    mlp_activation: str = "swiglu" # swiglu | squared_relu | gelu | geglu

    # positions
    rope_type: str = "rope"        # rope | mrope | sinusoidal | none
    rope_theta: float = 1e6
    mrope_sections: tuple[int, ...] = ()

    # MoE
    moe_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0              # per-expert hidden dim
    moe_capacity_factor: float = 1.25

    # SSM (mamba)
    ssm_d_state: int = 16
    ssm_d_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0           # 0 -> ceil(d_model/16)

    # xLSTM
    mlstm_expand: int = 2

    # io
    frontend: str = "none"         # none | vision_stub | audio_stub
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    # pad the embedding/lm-head vocab dim to a multiple (0 = off). Extra ids
    # are never emitted (logits sliced in decode) — standard sharding trick
    # for vocabs like minicpm's 122753 that divide no mesh axis.
    vocab_pad_to: int = 0

    # compilation / memory policy
    scan_layers: bool = True
    remat: str = "full"            # none | dots | full

    def __post_init__(self) -> None:
        if self.num_layers % len(self.pattern):
            raise ValueError(
                f"{self.name}: num_layers {self.num_layers} not divisible by "
                f"period {len(self.pattern)}"
            )
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"{self.name}: heads not divisible by kv heads")

    # -- derived -------------------------------------------------------------

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        if self.vocab_pad_to:
            import math as _m
            return _m.ceil(self.vocab_size / self.vocab_pad_to) * self.vocab_pad_to
        return self.vocab_size

    @property
    def n_periods(self) -> int:
        return self.num_layers // len(self.pattern)

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or math.ceil(self.d_model / 16)

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_subquadratic(self) -> bool:
        """True if prefill cost is sub-quadratic in sequence length (DESIGN §4)."""
        return self.family in ("ssm", "hybrid")

    def blocks(self) -> Iterable[tuple[int, Block]]:
        for i in range(self.num_layers):
            yield i, self.pattern[i % len(self.pattern)]

    # -- parameter counting (for roofline MODEL_FLOPS) -----------------------

    def _mixer_params(self, blk: Block) -> int:
        d, hd = self.d_model, self.head_dim_
        if blk.mixer == "attn":
            q = d * self.num_heads * hd
            kv = 2 * d * self.num_kv_heads * hd
            o = self.num_heads * hd * d
            return q + kv + o
        if blk.mixer == "mamba":
            di, ds, dtr = self.ssm_d_inner, self.ssm_d_state, self.dt_rank
            in_proj = d * 2 * di
            conv = di * self.ssm_d_conv
            x_proj = di * (dtr + 2 * ds)
            dt_proj = dtr * di
            out = di * d
            return in_proj + conv + x_proj + dt_proj + out + di * ds + 2 * di
        if blk.mixer == "mlstm":
            # up+gate projections, block-diagonal per-head q/k/v (xLSTM's
            # proj_blocksize), per-head i/f gates, down projection
            di = self.mlstm_expand * self.d_model
            return (2 * d * di + 3 * di * di // self.num_heads
                    + 2 * di * self.num_heads + di * d)
        if blk.mixer == "slstm":
            # 4 gates (z,i,f,o): input proj d×d + block-diag recurrent H·dh·4dh
            # + output projection d×d
            dh = d // self.num_heads
            return 4 * d * d + 4 * d * dh + d * d
        raise ValueError(blk.mixer)

    def _mlp_params(self, blk: Block) -> tuple[int, int]:
        """(total, active) parameter counts of the block's mlp."""
        d = self.d_model
        if blk.mlp == "none":
            return 0, 0
        if blk.mlp == "dense":
            mult = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
            return mult * d * self.d_ff, mult * d * self.d_ff
        if blk.mlp == "moe":
            mult = 3 if self.mlp_activation in ("swiglu", "geglu") else 2
            per = mult * d * self.moe_d_ff
            total = self.moe_experts * per + self.moe_shared_experts * per
            total += d * self.moe_experts  # router
            active = (self.moe_top_k + self.moe_shared_experts) * per + d * self.moe_experts
            return total, active
        raise ValueError(blk.mlp)

    def param_counts(self) -> tuple[int, int]:
        """(total, active) non-embedding backbone params + heads/embeds."""
        total = active = 0
        for _, blk in self.blocks():
            m = self._mixer_params(blk)
            t, a = self._mlp_params(blk)
            total += m + t
            active += m + a
        embed = self.vocab_size * self.d_model
        head = 0 if self.tie_embeddings else self.vocab_size * self.d_model
        total += embed + head
        active += embed + head
        return total, active


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}
_SMOKE: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig, smoke: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  — populate registry

    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; have {sorted(table)}")
    return table[name]


# Depth served on one 80 GB card where the published depth does not fit it:
# jamba-v0.1-52b's 32 layers are 103 GB in bf16; 8 layers are one period of
# its pattern and hold every block kind once.
# nemotron-4-340b's 96 layers are 682 GB. A layer is 3.45 B parameters
# (6.9 GB bf16), the embedding and the untied head 9.44 B (18.9 GB). The
# init draws each leaf in fp32 before the cast, so the (18432, 256000) head
# is an 18.9 GB transient: 4 layers are 46.5 GB of weights, 65.4 GB with
# that transient, which leaves ~14 GB for a B 4 x S 256 forward and decode
# (its 0.5 GB logits, the MLP's 1024 x 73728 hidden) on an 80 GB card;
# 5 layers would leave 7 GB.
CARD_LAYERS = {"jamba-v0.1-52b": 8, "nemotron-4-340b": 4}


def card_config(name: str) -> ModelConfig:
    """The published config at the depth one card holds (``CARD_LAYERS``)."""
    cfg = get_config(name)
    return dataclasses.replace(cfg, num_layers=CARD_LAYERS.get(name, cfg.num_layers))


# The depth and expert count at which one 80 GB card trains a config whose
# training state does not fit it. The port's AdamW keeps bf16 parameters
# and gradients and fp32 moments, 12 B a parameter. One jamba-v0.1-52b
# period at 16 experts is 13.295 B parameters (160 GB). Its non-MoE part is
# ~2.02 B: 7 Mamba mixers at ~105 M, one attention block at 42 M, 4 dense
# MLPs at 176 M, the embedding and the untied head at 537 M; an expert is
# 3 x 4096 x 14336 = 176 M, 4 MoE layers a period. At 4 experts the period
# is 2.02 + 4 x 4 x 0.176 = 4.84 B (58 GB of state); AdamW's transients add
# 3-4 GB (the largest leaf, (4, 4096, 14336), is 0.94 GB in fp32) and the
# activations of B 4 x S 256 under remat "full" under 3 GB: ~65 GB. 8
# experts would be 7.66 B, 92 GB.
CARD_TRAIN = {"jamba-v0.1-52b": dict(num_layers=8, moe_experts=4)}


def card_train_config(name: str) -> ModelConfig:
    """The published config at the depth and expert count one card trains
    (``CARD_TRAIN``; top-k and every width kept), else :func:`card_config`."""
    cut = CARD_TRAIN.get(name)
    return dataclasses.replace(get_config(name), **cut) if cut else card_config(name)


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    """The assignment's shape cells this arch runs (long_500k gating)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.is_subquadratic:
        out.append("long_500k")
    return out
