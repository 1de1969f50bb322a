"""Public entry points of the port's kernels, and their launch counts.

Model code calls these, never a kernel module or the launch site directly.
Each call on CUDA tensors launches the hand-written kernel or raises; each
call on CPU tensors runs the kernel's plain version (``ref.py``). Nothing
switches a CUDA tensor to the plain version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.kernels.streamed_dot import streamed_dot
from repro_torch.kernels.streamed_matmul import streamed_matmul

__all__ = ["matmul", "dot", "attention", "selective_scan", "launch_counts",
           "matmul_variant_counts", "reset_launch_counts", "KERNELS"]

#: the wrappers whose ``launches`` count kernel launches
KERNELS = {
    "streamed_dot": streamed_dot,
    "streamed_matmul": streamed_matmul,
    "flash_attention": flash_attention,
    "ssm_scan": ssm_scan,
}


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    return streamed_matmul(a, b, out_dtype=out_dtype)


def dot(v: torch.Tensor, u: torch.Tensor, *, token_size: int = 8 * 1024) -> torch.Tensor:
    return streamed_dot(v, u, token_size=token_size)


def attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None):
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)


def selective_scan(x, dt, b, c, a, d, *, chunk: int = 128):
    return ssm_scan(x, dt, b, c, a, d, chunk=chunk)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def matmul_variant_counts() -> dict[str, int]:
    """``streamed_matmul`` launches per kernel variant since the last reset."""
    return dict(streamed_matmul.launches_by_variant)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    streamed_matmul.launches_by_variant = dict.fromkeys(streamed_matmul.launches_by_variant, 0)
