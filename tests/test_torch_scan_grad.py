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
    SEGMENT,
    SelectiveScan,
    bwd_geometry,
    bwd_work_shapes,
    launch_geometry,
    lanes_for,
    ssm_bwd_plan,
    ssm_plan,
    ssm_scan,
    ssm_scan_bwd,
    ssm_scan_with_tape,
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
    backward ``ssm_scan_bwd_ref``, bit for bit; it saves the six operands
    and no checkpoint tape, and it launches nothing."""
    *ins, dy = _torch(_inputs(3, 2, 40, 16, 16))
    live = [t.clone().requires_grad_(True) for t in ins]
    before = ops.launch_counts()
    y = ops.selective_scan(*live)
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "SelectiveScanBackward"
    assert len(y.grad_fn.saved_tensors) == 6
    assert all(s is t or torch.equal(s, t) for s, t in zip(y.grad_fn.saved_tensors, live))
    assert torch.equal(y, ref.ssm_scan_ref(*ins))
    got = torch.autograd.grad(y, live, dy)
    for g, w in zip(got, ref.ssm_scan_bwd_ref(*ins, dy)):
        assert torch.equal(g, w)
    assert ops.launch_counts() == before
    y_tape, tape = ssm_scan_with_tape(*ins)
    assert tape is None and torch.equal(y_tape, y)


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


@pytest.mark.parametrize("ds", [8, 16])
@pytest.mark.parametrize("seq", [5, 300, 4000])
def test_bwd_plan_lowers_to_the_kernels_launch(ds, seq):
    """The backward's launch: its own tile (256 threads of 4 states a lane:
    64 channels at d_state 16, 128 at 8) for every batch size, grid
    (channel tiles, rows), loop = stages of 16 positions, the per-tile h and
    g as scratch, the forward's tape among its inputs and work buffers at
    :func:`bwd_work_shapes`' shapes."""
    bsz, di = 3, 1000
    lanes, block_d, seg, stage = bwd_geometry(ds)
    assert (lanes, block_d, seg, stage) == (ds // 4, 1024 // ds, 8, 16)
    seq_p = -(-seq // stage) * stage
    plan = ssm_bwd_plan(bsz, seq_p, di, ds, chunk=stage, block_d=block_d, dtype=torch.bfloat16)
    grid, loop = pipeline.geometry(plan)
    assert grid == (-(-di // block_d), bsz, 1) and loop == seq_p // stage
    assert plan.scratch_bytes == 2 * block_d * ds * 4
    shapes = bwd_work_shapes(bsz, seq, di, ds)
    assert shapes["dbc"] == (bsz, seq, 2, grid[0], ds)               # one partial a tile
    assert shapes["h_ckpt"] == (bsz, -(-seq // SEGMENT) - 1, di, ds)
    assert shapes["dA"] == (bsz, di, ds) and shapes["dD"] == (bsz, di)
    # the plan prices the same buffers at its padded sizes; the tape comes in
    d_pad = grid[0] * block_d
    padded = bwd_work_shapes(bsz, seq_p, d_pad, ds)
    specs = {t.name: t for t in (*plan.inputs, *plan.outputs)}
    assert {k: specs[k].full_shape for k in padded if k in specs} \
        == {k: v for k, v in padded.items() if k != "h_ckpt" or v[1]}
    assert ("h_ckpt" in specs) == (seq_p > SEGMENT)
    if "h_ckpt" in specs:
        assert specs["h_ckpt"].direction == "down" and specs["h_ckpt"] in plan.inputs
    with pytest.raises(ValueError, match="tile"):
        ssm_bwd_plan(bsz, seq_p, di, ds, chunk=stage, block_d=block_d // 2)


@pytest.mark.parametrize("bsz,seq,di,ds,dtype", [
    (4, 256, 8192, 16, torch.bfloat16),     # jamba's train step
    (1, 4000, 8192, 16, torch.bfloat16),    # B 1, long
    (2, 300, 1000, 8, torch.float32),       # ragged d_inner and L, d_state 8
    (3, 8, 64, 16, torch.float32),          # one segment: no checkpoint at all
])
def test_forward_and_backward_plans_agree_on_the_tape(bsz, seq, di, ds, dtype):
    """The tape has one description: the forward's launch plan with a tape
    writes it, the backward's plan reads it, both at
    :func:`bwd_work_shapes`' "h_ckpt" shape (at the plans' padded sizes);
    the forward's plan without a tape (serving) has y alone."""
    lanes = lanes_for(bsz, di, ds, 132)
    block_d, ck, seq_p = launch_geometry(seq, 128, lanes, dtype.itemsize)
    fwd = ssm_plan(bsz, seq_p, di, ds, chunk=ck, dtype=dtype, block_d=block_d, tape=True)
    plain = ssm_plan(bsz, seq_p, di, ds, chunk=ck, dtype=dtype, block_d=block_d)
    assert [t.name for t in plain.outputs] == ["y"]
    _, bwd_block, _, stage = bwd_geometry(ds)
    bseq = -(-seq // stage) * stage
    bwd = ssm_bwd_plan(bsz, bseq, di, ds, chunk=stage, block_d=bwd_block, dtype=dtype)
    written = {t.name: t for t in fwd.outputs}.get("h_ckpt")
    read = {t.name: t for t in bwd.inputs}.get("h_ckpt")
    d_fwd = pipeline.geometry(fwd)[0][0] * block_d
    d_bwd = pipeline.geometry(bwd)[0][0] * bwd_block
    want_fwd = bwd_work_shapes(bsz, seq_p, d_fwd, ds)["h_ckpt"]
    want_bwd = bwd_work_shapes(bsz, bseq, d_bwd, ds)["h_ckpt"]
    assert (written is None) == (want_fwd[1] == 0) and (read is None) == (want_bwd[1] == 0)
    if written is not None:
        assert written.full_shape == want_fwd and written.direction == "up"
        assert read.full_shape == want_bwd and read.dtype == written.dtype == torch.float32
    # at the operands' sizes, what both wrappers allocate: one shape
    assert bwd_work_shapes(bsz, seq, di, ds)["h_ckpt"] == (bsz, max(-(-seq // 8) - 1, 0), di, ds)


@pytest.mark.parametrize("seq", [1, 8, 9, 37])
def test_tape_ref_holds_the_walks_states(seq):
    """``ssm_scan_tape_ref``, what the card's forward tape is held to: the
    plain walk's state after every SEGMENT positions but the last, at
    ``bwd_work_shapes``' shape; each entry reads back the plain scan's y at
    that position (y_t = C_t·h_t + D x_t)."""
    x, dt, bb, c, a, d, _ = _torch(_inputs(9 + seq, 2, seq, 6, 8, dtype=np.float64))
    tape = ref.ssm_scan_tape_ref(x, dt, bb, a, SEGMENT)
    assert tape.shape == bwd_work_shapes(2, seq, 6, 8)["h_ckpt"] and tape.dtype == x.dtype
    y = ref.ssm_scan_ref(x, dt, bb, c, a, d)
    for k in range(tape.shape[1]):
        t = (k + 1) * SEGMENT - 1
        want = torch.einsum("bis,bs->bi", tape[:, k], c[:, t]) + d * x[:, t]
        torch.testing.assert_close(y[:, t], want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("bsz,seq,di,ds,tiles", [
    (4, 256, 8192, 16, 128),    # jamba: 16.8 MB of partials (67 MB at 16 channels a partial)
    (1, 4000, 8192, 16, 128),
    (2, 300, 1000, 16, 16),     # ragged: the last tile 40 channels
    (1, 130, 200, 8, 2),        # d_state 8: 128 channels a tile
])
def test_bwd_partials_are_one_per_tile(bsz, seq, di, ds, tiles):
    """The dB/dC partials: one per (row, position, kind, tile of the
    block's channels, state), (B, L, 2, ceil(d_inner / BD), d_state)."""
    shape = bwd_work_shapes(bsz, seq, di, ds)["dbc"]
    assert shape == (bsz, seq, 2, tiles, ds) and tiles == -(-di // bwd_geometry(ds)[1])
    if (bsz, seq, di) == (4, 256, 8192):
        assert 4 * np.prod(shape) == 16_777_216
