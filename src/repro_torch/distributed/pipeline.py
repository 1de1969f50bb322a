"""GPipe-style pipeline parallelism over a mesh axis (fill–drain schedule).

The JAX package's ``distributed/pipeline.py`` on ``torch.distributed``, one
process per rank. Each rank along ``axis`` owns one stage's parameters;
microbatches flow through the ring, one hyperstep per tick — the paper's
systolic pattern (the Cannon rotation with layers instead of matrix
blocks). Bubble fraction is (S−1)/(M+S−1), the standard GPipe trade-off.

JAX's ``ppermute`` around the ring is one ``batch_isend_irecv`` a tick (a
send to the next stage, a receive from the previous one) inside the axis's
subgroup, and the final ``psum`` of the last stage's outputs an
``all_reduce``. With one stage the ring is the identity, as ``ppermute``
is: nothing is sent (no send to self over ``nccl``).

This is the demonstration PP implementation (forward only).
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.optim.compress import tree_map

__all__ = ["pipeline_apply"]


def _axis_ring(mesh: Any, axis: str) -> tuple[int, int, Any, list[int]]:
    """(this rank's stage, stage count, the axis's subgroup, the subgroup's
    global ranks in stage order)."""
    dmesh = mesh.device_mesh
    if dmesh is None:
        raise ValueError("pipeline_apply needs a mesh over a rank group")
    names = mesh.axis_names
    group = dmesh.get_group(axis)
    return (int(dmesh.get_coordinate()[names.index(axis)]), int(mesh.shape[axis]), group,
            dist.get_process_group_ranks(group))


def pipeline_apply(
    fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,              # tree with a leading stage axis (S, ...)
    microbatches: torch.Tensor,     # (M, B, d) — M microbatches, the same on every rank
    *,
    mesh: Any,
    axis: str = "model",
) -> torch.Tensor:
    """Apply S pipeline stages to M microbatches; returns (M, B, d) on every
    rank of the axis. Each rank takes its stage's slice of every leaf of
    ``stage_params`` (a full tensor, or a DTensor sharded on its first dim
    over ``axis``, whose local shard is that slice)."""
    stage, s_stages, group, ranks = _axis_ring(mesh, axis)
    m = microbatches.shape[0]

    def local(t):
        return t.to_local()[0] if hasattr(t, "to_local") else t[stage]

    p_stage = tree_map(local, stage_params)
    nxt, prv = ranks[(stage + 1) % s_stages], ranks[(stage - 1) % s_stages]
    buf = torch.zeros_like(microbatches[0])
    outs = torch.zeros_like(microbatches)
    for t in range(m + s_stages - 1):
        # stage 0 ingests microbatch t during the fill phase
        if stage == 0:
            cur = microbatches[t] if t < m else torch.zeros_like(buf)
        else:
            cur = buf
        y = fn(p_stage, cur)
        # the last stage emits microbatch t−(S−1) during the drain phase
        idx = t - (s_stages - 1)
        if stage == s_stages - 1 and idx >= 0:
            outs[idx] = y
        if s_stages == 1:
            buf = y
            continue
        buf = torch.empty_like(y)
        for req in dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, buf, prv, group)]):
            req.wait()
    if s_stages > 1:
        # results live on the last stage only; share them along the ring
        if stage != s_stages - 1:
            outs.zero_()
        dist.all_reduce(outs, group=group)
    return outs
