"""Public entry points of the port's kernels, and their launch counts.

Model code calls these, never a kernel module or the launch site directly.
Each call on CUDA tensors launches the hand-written kernel or raises; each
call on CPU tensors runs the kernel's plain version (``ref.py``). Nothing
switches a CUDA tensor to the plain version.

:class:`Matmul` makes the matmul differentiable: its backward runs both
products through the same kernel (the input gradient with B read in the
other layout, the weight gradient with A read as its transpose), so a
train step's products all launch the hand-written kernel on the card.

:class:`KeptProducts` is ``remat="dots"``'s policy: in a checkpointed
region the outputs of its :class:`Matmul` calls are kept from the forward
and handed back when the backward pass recomputes the region, so each
product launches once and everything else is recomputed.

Inside :func:`repro_torch.core.roofline.count` each kernel call records its
module's ``cost`` (``streamed_matmul.cost``, ``streamed_dot.cost``,
``flash_attention.cost``, ``ssm_scan.cost`` and ``bwd_cost``) on both
devices, in place of the torch ops of its plain version.
"""

from __future__ import annotations

import threading

import torch

from repro_torch.core.roofline import uncounted
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
from repro_torch.kernels.streamed_dot import streamed_dot
from repro_torch.kernels.streamed_matmul import streamed_matmul, tma_rows

__all__ = ["matmul", "dot", "attention", "selective_scan", "launch_counts",
           "matmul_variant_counts", "matmul_layout_counts", "flash_variant_counts",
           "reset_launch_counts", "KERNELS", "Matmul", "KeptProducts"]

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


class KeptProducts:
    """One checkpointed region's :class:`Matmul` outputs, for
    ``remat="dots"`` (the JAX package's ``checkpoint_dots_with_no_batch_dims``:
    the port's matmul is its one product with no batch dims).

    :meth:`contexts` is ``torch.utils.checkpoint``'s ``context_fn``. Under
    its first context (the region's forward) each ``Matmul`` launches and
    its output is kept, detached, in call order. Under the second (the
    region's recompute in the backward pass, entered once a backward) each
    ``Matmul`` hands back the kept output of its place in that order and
    launches nothing. A recomputed call whose product differs from the kept
    one in shape, dtype or device, a call past the kept ones, or a kept
    output modified in place since raises ``RuntimeError``: no product is
    recomputed in silence.
    """

    def __init__(self):
        self.kept: list[tuple[torch.Tensor, int]] = []
        self.next = 0

    @classmethod
    def contexts(cls) -> tuple[_Region, _Region]:
        products = cls()
        return _Region(products, replay=False), _Region(products, replay=True)

    def keep(self, c: torch.Tensor) -> None:
        self.kept.append((c.detach(), c._version))

    def replay(self, a: torch.Tensor, b: torch.Tensor, b_layout: str,
               out_dtype: torch.dtype) -> torch.Tensor:
        shape = (a.shape[0], b.shape[1] if b_layout == "kn" else b.shape[0])
        i, self.next = self.next, self.next + 1
        if i >= len(self.kept):
            raise RuntimeError(f"remat='dots': the recompute's product {i} ({shape}) has no "
                               f"kept output ({len(self.kept)} kept)")
        c, version = self.kept[i]
        if tuple(c.shape) != shape or c.dtype != out_dtype or c.device != a.device:
            raise RuntimeError(f"remat='dots': the recompute's product {i} is {shape} "
                               f"{out_dtype} on {a.device}, the kept one {tuple(c.shape)} "
                               f"{c.dtype} on {c.device}")
        if c._version != version:
            raise RuntimeError(f"remat='dots': kept product {i} was modified in place")
        return c.detach()


class _Region:
    """A context under which the thread's :class:`Matmul` calls keep
    (``replay=False``) or replay their outputs; re-entered once a backward."""

    def __init__(self, products: KeptProducts, *, replay: bool):
        self.products, self.replay = products, replay

    def __enter__(self):
        if self.replay:
            self.products.next = 0
        _OPEN.regions.append(self)

    def __exit__(self, *exc) -> None:
        _OPEN.regions.pop()


class _Open(threading.local):
    def __init__(self):
        self.regions: list[_Region] = []


_OPEN = _Open()


class Matmul(torch.autograd.Function):
    """C = A·B (``b_layout="kn"``: B (k, n)) or A·Bᵀ (``"nk"``: B stored
    (n, k)), differentiable, every product on the kernel.

    dA = dC·Bᵀ reads the stored B in the other layout, with no copy: a (k, n)
    weight is the (n, k) B of this product and an (n, k) one its (k, n) B.
    dB = Aᵀ·dC (or dCᵀ·A for ``"nk"``) reads its left operand as the (k, m)
    transpose of the stored matrix (``a_layout="km"``). Each gradient is
    written in its operand's dtype. On the card an operand whose rows TMA
    cannot read is copied to padded rows first (:func:`tma_rows`: the
    launch's staging, not the product's work, so a roofline count leaves it
    out; :func:`streamed_matmul` stages the transposed operands itself, this
    backward dC and B, which a product may read in the default layout: the
    tied head's dC·E); on the CPU the plain version runs the same three
    products. Inside
    a :class:`KeptProducts` region the forward keeps or replays its output.
    """

    @staticmethod
    def forward(ctx, a, b, b_layout: str = "kn", out_dtype=None):
        ctx.save_for_backward(a, b)
        ctx.b_layout = b_layout
        out_dtype = out_dtype or a.dtype
        region = _OPEN.regions[-1] if _OPEN.regions else None
        if region is not None and region.replay:
            return region.products.replay(a, b, b_layout, out_dtype)
        c = matmul(a, b, out_dtype=out_dtype, b_layout=b_layout)
        if region is not None:
            region.products.keep(c)
        return c

    @staticmethod
    def backward(ctx, dc):
        a, b = ctx.saved_tensors
        if dc.is_cuda:      # the products below in the default layout read dC and B
            with uncounted():
                dc, b = tma_rows(dc), tma_rows(b)
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


def flash_variant_counts() -> dict[str, int]:
    """``flash_attention`` launches per kernel instance (dtype and the head
    dim it ran at, e.g. ``"bf16.d16"``) since the last reset."""
    return dict(flash_attention.launches_by_variant)


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
    flash_attention.launches_by_variant = dict.fromkeys(flash_attention.launches_by_variant, 0)
    streamed_matmul.launches_by_variant = dict.fromkeys(streamed_matmul.launches_by_variant, 0)
    streamed_matmul.launches_by_layout = dict.fromkeys(streamed_matmul.launches_by_layout, 0)
