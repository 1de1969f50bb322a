"""Public entry points of the port's kernels, and their launch counts.

Model code calls these, never a kernel module or the launch site directly.
Each call on CUDA tensors launches the hand-written kernel or raises; each
call on CPU tensors runs the kernel's plain version (``ref.py``). Nothing
switches a CUDA tensor to the plain version.

:class:`Matmul` makes the matmul differentiable: its backward runs both
products through the same kernel (the input gradient with B read in the
other layout, the weight gradient with A read as its transpose), so a
train step's products all launch the hand-written kernel on the card.

Inside :func:`repro_torch.core.roofline.count` each kernel call records its
module's ``cost`` (``streamed_matmul.cost``, ``streamed_dot.cost``,
``flash_attention.cost``, ``ssm_scan.cost`` and ``bwd_cost``) on both
devices, in place of the torch ops of its plain version.
"""

from __future__ import annotations

import torch

from repro_torch.core.roofline import uncounted
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
from repro_torch.kernels.streamed_dot import streamed_dot
from repro_torch.kernels.streamed_matmul import streamed_matmul

__all__ = ["matmul", "dot", "attention", "selective_scan", "launch_counts",
           "matmul_variant_counts", "matmul_layout_counts", "reset_launch_counts", "KERNELS",
           "Matmul"]

#: the wrappers whose ``launches`` count kernel launches
KERNELS = {
    "streamed_dot": streamed_dot,
    "streamed_matmul": streamed_matmul,
    "flash_attention": flash_attention,
    "ssm_scan": ssm_scan,
    "ssm_scan_bwd": ssm_scan_bwd,
}


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None, a_layout: str = "mk",
           b_layout: str = "kn") -> torch.Tensor:
    return streamed_matmul(a, b, out_dtype=out_dtype, a_layout=a_layout, b_layout=b_layout)


def _tma_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` (2-D, on the card) with contiguous rows a multiple of 16 bytes
    apart from a 16-byte aligned base, as TMA reads an operand: ``t`` itself,
    or a view of a padded copy. The logits' gradient needs the copy (a
    vocabulary of 122,753 bf16 is 245,506 bytes a row)."""
    width = 16 // t.element_size()
    if t.stride(1) == 1 and t.stride(0) % width == 0 and t.data_ptr() % 16 == 0:
        return t
    rows, cols = t.shape
    buf = torch.empty((rows, -(-cols // width) * width), dtype=t.dtype, device=t.device)
    buf[:, :cols].copy_(t)
    return buf[:, :cols]


class Matmul(torch.autograd.Function):
    """C = A·B (``b_layout="kn"``: B (k, n)) or A·Bᵀ (``"nk"``: B stored
    (n, k)), differentiable, every product on the kernel.

    dA = dC·Bᵀ reads the stored B in the other layout, with no copy: a (k, n)
    weight is the (n, k) B of this product and an (n, k) one its (k, n) B.
    dB = Aᵀ·dC (or dCᵀ·A for ``"nk"``) reads its left operand as the (k, m)
    transpose of the stored matrix (``a_layout="km"``). Each gradient is
    written in its operand's dtype. On the card an operand whose rows TMA
    cannot read is copied to padded rows first (:func:`_tma_rows`: the
    launch's staging, not the product's work, so a roofline count leaves it
    out); on the CPU the plain version runs the same three products.
    """

    @staticmethod
    def forward(ctx, a, b, b_layout: str = "kn", out_dtype=None):
        ctx.save_for_backward(a, b)
        ctx.b_layout = b_layout
        return matmul(a, b, out_dtype=out_dtype or a.dtype, b_layout=b_layout)

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        if dc.is_cuda:
            with uncounted():
                dc, a, b = _tma_rows(dc), _tma_rows(a), _tma_rows(b)
        da = db = None
        nk = ctx.b_layout == "nk"
        if ctx.needs_input_grad[0]:
            da = matmul(dc, b, out_dtype=a.dtype, b_layout="kn" if nk else "nk")
        if ctx.needs_input_grad[1]:
            db = (matmul(dc, a, out_dtype=b.dtype, a_layout="km") if nk
                  else matmul(a, dc, out_dtype=b.dtype, a_layout="km"))
        return da, db, None, None


def dot(v: torch.Tensor, u: torch.Tensor, *, token_size: int = 8 * 1024) -> torch.Tensor:
    return streamed_dot(v, u, token_size=token_size)


def attention(q, k, v, *, causal: bool = True, sm_scale: float | None = None,
              return_lse: bool = False):
    return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale, return_lse=return_lse)


def selective_scan(x, dt, b, c, a, d, *, chunk: int = 128):
    """The scan; differentiable where a gradient is being taken (its
    backward launches ``ssm_scan_bwd``)."""
    return ssm_scan(x, dt, b, c, a, d, chunk=chunk)


def launch_counts() -> dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: fn.launches for name, fn in KERNELS.items()}


def matmul_variant_counts() -> dict[str, int]:
    """``streamed_matmul`` launches per kernel variant since the last reset."""
    return dict(streamed_matmul.launches_by_variant)


def matmul_layout_counts() -> dict[str, int]:
    """``streamed_matmul`` launches per operand layout since the last reset,
    keyed ``"<a_layout>/<b_layout>"``."""
    return {f"{a}/{b}": n for (a, b), n in streamed_matmul.launches_by_layout.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    streamed_matmul.launches_by_variant = dict.fromkeys(streamed_matmul.launches_by_variant, 0)
    streamed_matmul.launches_by_layout = dict.fromkeys(streamed_matmul.launches_by_layout, 0)
