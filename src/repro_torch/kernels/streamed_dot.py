"""BSPS inner product (paper §3.1, Algorithm 1): plan and CUDA wrapper.

The two vectors live in device memory ("external memory") as streams of
C-element tokens. The JAX package's Pallas kernel runs the token stream as
one sequential grid axis on one core; a CUDA grid has no order, so on the
card the stream is the paper's p-core product: :func:`dot_plan` with
``cores = p`` deals the tokens out cyclically (token t to core t mod p, §3.1),
each core streams its share and keeps its partial sum α_s, and a closing
launch adds the p partials — Algorithm 1's final BROADCAST/SYNC. With
``cores=1`` the plan is exactly the JAX package's.

Cost (paper): T = n·max(2C, 2Ce) + p + (p-1)g + l — bandwidth-heavy iff e > 1,
which it is on the card: the kernel is bounded by device memory.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.core.plan import ScratchSpec, StreamPlan, TokenSpec
from repro_torch.core.roofline import KernelCost, counted
from repro_torch.kernels import pipeline, ref

__all__ = ["streamed_dot", "dot_plan", "cost"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dot_plan(n_tok: int, c: int, *, dtype=torch.float32, cores: int = 1) -> StreamPlan:
    """StreamPlan for α = v·u over ``n_tok`` hypersteps of C-word tokens.

    ``cores=1`` is the JAX package's plan: one "arbitrary" axis, the (1, 1)
    result written once on the final hyperstep. ``cores=p`` makes the
    p-core plan the CUDA kernel runs: grid (p, ceil(n_tok/p)) =
    ("parallel", "arbitrary"), token ``t·p + core`` at hyperstep t of core
    ``core`` (the tail zero-padded), one partial sum written up per core.
    """
    if cores == 1:
        return StreamPlan(
            name=f"dot_{n_tok}x{c}",
            grid=(n_tok,),
            inputs=(
                TokenSpec("v", (1, c), lambda t: (t, 0), dtype=dtype,
                          full_shape=(n_tok, c)),
                TokenSpec("u", (1, c), lambda t: (t, 0), dtype=dtype,
                          full_shape=(n_tok, c)),
            ),
            outputs=(
                # α is written up exactly once, on the final hyperstep
                TokenSpec("alpha", (1, 1), lambda t: (0, 0), dtype=torch.float32,
                          full_shape=(1, 1), direction="up", rate=0),
            ),
            scratch=(ScratchSpec("acc", (1, 1), torch.float32),),
            dimension_semantics=("arbitrary",),
            flops_per_hyperstep=2.0 * c,
        )
    per_core = math.ceil(n_tok / cores)
    padded = cores * per_core
    return StreamPlan(
        name=f"dot_{padded}x{c}_p{cores}",
        grid=(cores, per_core),
        inputs=(
            TokenSpec("v", (1, c), lambda s, t, p=cores: (t * p + s, 0),
                      dtype=dtype, full_shape=(padded, c)),
            TokenSpec("u", (1, c), lambda s, t, p=cores: (t * p + s, 0),
                      dtype=dtype, full_shape=(padded, c)),
        ),
        outputs=(
            # each core's α_s goes up once, when the core finishes
            TokenSpec("alpha_partial", (1, 1), lambda s, t: (s, 0),
                      dtype=torch.float32, full_shape=(cores, 1),
                      direction="up", rate=0),
        ),
        scratch=(ScratchSpec("acc", (1, 1), torch.float32),),
        dimension_semantics=("parallel", "arbitrary"),
        flops_per_hyperstep=2.0 * c,
    )


@functools.lru_cache(maxsize=256)
def _plan(n_tok: int, c: int, dtype: torch.dtype, cores: int) -> StreamPlan:
    return dot_plan(n_tok, c, dtype=dtype, cores=cores)


def cost(n: int, itemsize: int) -> KernelCost:
    """α = v·u's work for n-element vectors: 2n fp32 operations (a multiply
    and an add an element, summed in fp32), both vectors read once and the
    fp32 α written once."""
    return KernelCost(2.0 * n, float(2 * n * itemsize + 4), "fp32")


@counted("streamed_dot", lambda v, u, **_: cost(v.numel(), v.element_size()))
def streamed_dot(v: torch.Tensor, u: torch.Tensor, *,
                 token_size: int = 8 * 1024) -> torch.Tensor:
    """α = v·u for 1-D vectors streamed token-by-token. Returns a 0-d fp32.

    CUDA tensors go to the kernel (float32 or bfloat16, contiguous); CPU
    tensors to :func:`repro_torch.kernels.ref.dot_ref`.
    """
    if v.shape != u.shape or v.dim() != 1:
        raise ValueError(f"need equal 1-D shapes, got {tuple(v.shape)}, {tuple(u.shape)}")
    if v.device != u.device:
        raise ValueError(f"operands on {v.device} and {u.device}")
    if v.device.type == "cpu":
        return ref.dot_ref(v, u)
    if v.device.type != "cuda":
        raise ValueError(f"streamed_dot runs on CUDA or CPU tensors, not {v.device}")
    if v.dtype != u.dtype or v.dtype not in _DTYPES:
        raise TypeError(f"streamed_dot takes float32 or bfloat16, got {v.dtype}, {u.dtype}")
    if not (v.is_contiguous() and u.is_contiguous()):
        raise ValueError("streamed_dot needs contiguous vectors")
    n = v.shape[0]
    out = torch.empty((), dtype=torch.float32, device=v.device)
    if n == 0:
        return out.zero_()
    c = min(token_size, n)
    n_tok = math.ceil(n / c)
    cores = min(n_tok, 4 * pipeline.sm_count(v.device))
    launch = pipeline.lower(_plan(n_tok, c, v.dtype, cores), "bsps_dot", v.device)
    partials = torch.empty(cores, dtype=torch.float32, device=v.device)
    pipeline.launch(launch, v.device, v.data_ptr(), u.data_ptr(), n, c,
                    _DTYPES[v.dtype], partials.data_ptr(), out.data_ptr())
    streamed_dot.launches += 1
    return out


streamed_dot.launches = 0
