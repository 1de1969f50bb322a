"""The selective scan's backward on the CPU: the port's plain reverse-time
walk (``ref.ssm_scan_bwd_ref``) and its autograd Function
(``SelectiveScan``) against torch autograd through the plain forward, and
against ``jax.vjp`` through the JAX package's ``chunked_selective_scan``
(what its training path differentiates) and its plain ``ssm_scan_ref``, on
the same numpy inputs from a seed.

Tolerances, each for float32 sums taken in another order: rtol 1e-4 and
atol 1e-6 on every gradient, dΔ's atol in units of its largest entry where
that exceeds 1 (dΔ's entries reach ~100: A up to -16 times the state; an
fp32 sum of such terms is exact to ~1e-7 of them, and the JAX package's
own fp32 dΔ lies up to 1.3e-5 from the float64 walk); rtol 1e-5
(atol 1e-6) between the walk and torch autograd through the same plain
forward, which take the same products in a different order. ``gradcheck``
runs in float64.

Δ is drawn as the model makes it at init, softplus(-4.6 + 0.5·N(0,1))
(about 0.01): the JAX package's ``chunked_selective_scan`` expands a
chunk's recurrence with exp(max(-cum) - cum), which overflows float32 once
a chunk decays by more than e^88 (Δ·|A|·chunk; at Δ ~ 0.05 and A = -16 a
128-position chunk does) and gives NaN gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.models.mamba import chunked_selective_scan as j_chunked
from repro_torch.kernels import ops, pipeline, ref
from repro_torch.kernels.ssm_scan import (
    LANE_CHOICES,
    SelectiveScan,
    bwd_segment,
    bwd_work_shapes,
    launch_geometry,
    ssm_bwd_plan,
    ssm_scan,
    ssm_scan_bwd,
)

NAMES = ("dx", "ddt", "db", "dc", "da", "dd")


def _inputs(seed, b, seq, di, ds, dtype=np.float32):
    """x, Δ = softplus(-4.6 + 0.5·N(0,1)) (the model's dt_bias at init), B,
    C, A = -(1..d_state) per channel (jamba's init), D, and dy."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, seq, di))
    dt = np.log1p(np.exp(-4.6 + 0.5 * rng.standard_normal((b, seq, di))))
    bb = rng.standard_normal((b, seq, ds))
    c = rng.standard_normal((b, seq, ds))
    a = -np.tile(np.arange(1, ds + 1, dtype=np.float64), (di, 1))
    d = rng.standard_normal(di)
    dy = rng.standard_normal((b, seq, di))
    return [v.astype(dtype) for v in (x, dt, bb, c, a, d, dy)]


def _torch(vals):
    return [torch.as_tensor(v) for v in vals]


def _close(got, want, rtol=1e-4, atol=1e-6):
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w)
        scale = max(1.0, float(np.abs(w).max())) if name == "ddt" else 1.0
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol, atol=atol * scale,
                                   err_msg=name)


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("seq", [1, 37, 130])
@pytest.mark.parametrize("ds", [8, 16])
def test_bwd_ref_matches_autograd_through_the_plain_scan(b, seq, ds):
    *ins, dy = _torch(_inputs(10 * b + seq + ds, b, seq, 12, ds))
    live = [t.clone().requires_grad_(True) for t in ins]
    want = torch.autograd.grad(ref.ssm_scan_ref(*live), live, dy)
    got = ref.ssm_scan_bwd_ref(*ins, dy)
    for g, t in zip(got, ins):
        assert g.dtype == t.dtype and g.shape == t.shape
    _close([g.numpy() for g in got], [w.numpy() for w in want], rtol=1e-5)


@pytest.mark.parametrize("jax_fn", ["chunked_selective_scan", "ssm_scan_ref"])
@pytest.mark.parametrize("b,seq,di,ds", [(1, 37, 12, 8), (3, 130, 20, 16), (2, 1, 8, 16)])
def test_scan_grads_match_jax_vjp(jax_fn, b, seq, di, ds):
    """All six gradients against ``jax.vjp`` of the JAX package's scan:
    ``chunked_selective_scan`` (chunk 128: L 130 takes two chunks) or the
    plain ``ssm_scan_ref``."""
    vals = _inputs(7 + seq, b, seq, di, ds)
    *ins, dy = vals
    fn = (lambda *t: j_chunked(*t)[0]) if jax_fn == "chunked_selective_scan" \
        else jref.ssm_scan_ref
    _, vjp = jax.vjp(fn, *(jnp.asarray(v) for v in ins))
    want = vjp(jnp.asarray(dy))
    tin = _torch(vals)
    live = [t.clone().requires_grad_(True) for t in tin[:6]]
    got = torch.autograd.grad(ssm_scan(*live), live, tin[6])      # through SelectiveScan
    _close([g.numpy() for g in got], want)
    _close([g.numpy() for g in ssm_scan_bwd(*tin)], want)


def test_selective_scan_function_runs_the_plain_pair_on_the_cpu():
    """On CPU tensors the Function's forward is ``ssm_scan_ref`` and its
    backward ``ssm_scan_bwd_ref``, bit for bit, and it launches nothing."""
    *ins, dy = _torch(_inputs(3, 2, 40, 16, 16))
    live = [t.clone().requires_grad_(True) for t in ins]
    before = ops.launch_counts()
    y = ops.selective_scan(*live)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SelectiveScanBackward"
    assert torch.equal(y, ref.ssm_scan_ref(*ins))
    got = torch.autograd.grad(y, live, dy)
    for g, w in zip(got, ref.ssm_scan_bwd_ref(*ins, dy)):
        assert torch.equal(g, w)
    assert ops.launch_counts() == before


def test_selective_scan_returns_only_the_gradients_asked_for():
    """An operand that takes no gradient gets none; without grad mode, or
    with no operand that requires grad, there is no graph."""
    *ins, dy = _torch(_inputs(4, 1, 9, 8, 8))
    x = ins[0].clone().requires_grad_(True)
    y = ssm_scan(x, *ins[1:])
    (gx,) = torch.autograd.grad(y, (x,), dy)
    assert torch.equal(gx, ref.ssm_scan_bwd_ref(*ins, dy)[0])
    with torch.no_grad():
        assert ssm_scan(x, *ins[1:]).grad_fn is None
    assert ssm_scan(*ins).grad_fn is None


def test_selective_scan_gradcheck_in_float64():
    *ins, _ = _torch(_inputs(5, 2, 5, 3, 4, dtype=np.float64))
    live = tuple(t.clone().requires_grad_(True) for t in ins)
    assert torch.autograd.gradcheck(lambda *t: SelectiveScan.apply(*t), live)


def test_backward_gradients_keep_each_operands_dtype():
    """bf16 streams with fp32 A and D, as the model calls the scan: dx, dΔ,
    dB, dC in bf16, dA and dD in fp32."""
    *ins, dy = _torch(_inputs(6, 1, 20, 16, 8))
    ins = [t.to(torch.bfloat16) for t in ins[:4]] + ins[4:]
    grads = ssm_scan_bwd(*ins, dy.to(torch.bfloat16))
    assert [g.dtype for g in grads] == [torch.bfloat16] * 4 + [torch.float32] * 2


@pytest.mark.parametrize("ds,lanes", [(ds, g) for ds in (8, 16) for g in LANE_CHOICES
                                       if 2 * g <= ds])     # a pair of states a lane at least
def test_bwd_plan_lowers_to_the_kernels_launch(ds, lanes):
    """The backward's launch: the forward's grid (channel tiles, rows) and
    lane groups, loop = segments, a segment of 8 positions at 8 states a
    lane (16 at fewer), the per-tile h and g as scratch, and work buffers
    whose shapes do not depend on the lane count."""
    bsz, seq, di = 3, 300, 1000
    seg = bwd_segment(lanes, ds)
    assert seg == (8 if ds // lanes >= 8 else 16)
    block_d, ck, seq_p = launch_geometry(seq, seg, lanes, 2)
    plan = ssm_bwd_plan(bsz, seq_p, di, ds, chunk=ck, block_d=block_d, dtype=torch.bfloat16)
    grid, loop = pipeline.geometry(plan)
    assert grid == (-(-di // block_d), bsz, 1) and loop == seq_p // ck
    assert plan.scratch_bytes == 2 * block_d * ds * 4
    shapes = bwd_work_shapes(bsz, seq, di, ds, loop)
    assert shapes["dbc"] == (bsz, seq, 2, 63, ds)                  # ceil(1000 / 16) groups
    assert shapes["h_ckpt"] == (bsz, loop, di, ds)
    # the plan prices the same buffers at its padded sizes
    d_pad = grid[0] * block_d
    padded = bwd_work_shapes(bsz, seq_p, d_pad, ds, loop)
    assert {t.name: t.full_shape for t in plan.outputs if t.name in padded} == padded
