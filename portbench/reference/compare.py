"""The comparisons that decide ``correct``, as plain arithmetic, and the
seeded tokens every traffic kind draws its inputs from."""

from __future__ import annotations

import statistics
import sys

import numpy as np
import torch

__all__ = ["tokens", "worst_leaf", "served_gap", "control_gap", "worst_span_quantile", "describe"]


def tokens(vocab: int, shape: tuple[int, ...], seed: int, index: int) -> np.ndarray:
    """Token ids drawn uniformly from the vocabulary, seeded by (seed,
    index): the same pair gives the same ids on every machine."""
    rng = np.random.default_rng(np.random.SeedSequence([seed, index]))
    return rng.integers(0, vocab, shape, dtype=np.int64).astype(np.int32)


def worst_leaf(prog: list[float], ref: list[float]) -> float:
    """The largest gap between the program's norm of a leaf and the
    reference's, each over the reference's norm of that leaf or of the
    median leaf, whichever is larger (some leaves' norms are all but 0)."""
    med = statistics.median(ref)
    return max(abs(p - r) / max(r, med, 1e-30) for p, r in zip(prog, ref))


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the reference's best at
    its position: ref_logits (..., V) fp32, served (...) token ids."""
    best = ref_logits.max(dim=-1).values
    return best - ref_logits.gather(-1, served.long()[..., None])[..., 0]


def control_gap(ref_logits: torch.Tensor, control_logits: torch.Tensor) -> torch.Tensor:
    """The gap, in the reference's logits, of the token the control puts
    first."""
    return served_gap(ref_logits, control_logits.argmax(dim=-1))


def _span_quantiles(gaps: torch.Tensor, span: int, q: float) -> torch.Tensor:
    g = gaps.float()
    return torch.cat([torch.quantile(g[:, s0:s0 + span], q, dim=1)
                      for s0 in range(0, g.shape[1], span)])


def worst_span_quantile(gaps: torch.Tensor, span: int, q: float) -> float:
    """Each row of ``gaps`` (rows, positions) cut into spans of ``span``
    positions (the last may be shorter); the largest ``q``-quantile of a
    span. A fault in more than a share 1 - q of any one span of one row (a
    slot of a batch, the late positions of a document) moves it as far as
    the fault reaches, while gaps that a sound run scatters thinly over its
    rows do not."""
    return float(_span_quantiles(gaps, span, q).max())


def describe(tag: str, gaps: torch.Tensor, span: int, q: float) -> None:
    """Print the distribution of ``gaps`` (rows, positions) to standard
    error: quantiles over all of them, and the spans' ``q``-quantiles."""
    flat = gaps.float().flatten()
    qs = torch.quantile(flat[:: max(1, flat.numel() // 8_000_000)],
                        torch.tensor([0.5, 0.9, 0.99, 0.999], device=flat.device)).tolist()
    spans = _span_quantiles(gaps, span, q)
    sq = torch.quantile(spans, torch.tensor([0.5, 0.9], device=flat.device)).tolist()
    print(f"{tag} gaps over {tuple(gaps.shape)}: p50 {qs[0]:.4g} p90 {qs[1]:.4g} "
          f"p99 {qs[2]:.4g} p99.9 {qs[3]:.4g} max {float(flat.max()):.4g}; the "
          f"{spans.numel()} spans of {span}: their {q}-quantiles' median {sq[0]:.4g}, "
          f"9th decile {sq[1]:.4g}, max {float(spans.max()):.4g}", file=sys.stderr)
