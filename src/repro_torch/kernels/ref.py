"""Plain PyTorch versions of the port's CUDA kernels.

Each mirrors its kernel's arithmetic — fp32 accumulation, one cast at the
end — with no blocking, streaming or online renormalisation, as the JAX
package's ``kernels/ref.py`` does for its Pallas kernels. The kernel wrappers
use them for tensors that lie on the CPU (the CPU tests and the CPU path of
the port); on the card they are what ``chip_smoke.py`` holds each kernel
against. No code on the main path calls them with CUDA tensors.
"""

from __future__ import annotations

import torch

__all__ = ["matmul_ref", "dot_ref", "attention_ref"]


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def dot_ref(v: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return torch.dot(v.float(), u.float())


def attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    sm_scale: float | None = None,
) -> torch.Tensor:
    """Dense softmax attention with GQA. q: (B,Hq,Sq,D), k/v: (B,Hkv,Skv,D).

    When Sq < Skv the queries are the last Sq positions (decode semantics):
    ``q_offset = Skv - Sq``.
    """
    b, hq, sq, d = q.shape
    _, hkv, skv, _ = k.shape
    group = hq // hkv
    sm_scale = sm_scale if sm_scale is not None else d ** -0.5
    kk = k.repeat_interleave(group, dim=1).float()
    vv = v.repeat_interleave(group, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * sm_scale
    if causal:
        q_pos = torch.arange(sq, device=q.device)[:, None] + (skv - sq)
        k_pos = torch.arange(skv, device=q.device)[None, :]
        s = s.masked_fill(q_pos < k_pos, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)
