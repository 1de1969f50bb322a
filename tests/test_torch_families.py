"""The port's other model families against the JAX package's, on the CPU.

starcoder2-15b and nemotron-4-340b (dense: LayerNorm, GELU or squared-ReLU,
GQA), qwen2-moe-a2.7b and moonshot-v1-16b-a3b (MoE with shared experts),
musicgen-large (sinusoidal positions) and qwen2-vl-7b (M-RoPE), each in its
float32 smoke config with the JAX init's weights carried over by
``params_from_numpy``. The frontend configs (musicgen, qwen2-vl) take
``embeds``: standard normals from numpy, as the JAX package's own tests
draw them. Their counts, cache bytes and card depths are held in
``tests/test_torch_model.py`` with every other config's. Tolerances, each for float32 sums taken in another order:
forward and decode logits 1e-4; the train step
``tests/test_torch_train.py``'s (loss rtol 1e-5, gradient norm rtol 1e-4,
parameters and moments within 1e-5 + 1e-3·lr); M-RoPE 1e-6; sinusoidal
positions 1e-6 + 2^-22 × the largest position (an ulp of a frequency times
the position).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import layers as jlayers
from repro.models import model as JM
from repro.optim import schedule as jschedule
from repro.optim.adamw import AdamW as JAdamW
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_config as t_config
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM
from repro_torch.optim import schedule as tschedule
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import leaves
from repro_torch.train.steps import make_prefill_step, make_serve_step, make_train_step

FAMILIES = ["starcoder2-15b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "musicgen-large",
            "qwen2-vl-7b", "nemotron-4-340b"]
FRONTEND = {"musicgen-large", "qwen2-vl-7b"}
ATOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny models gain nothing from more, and
    several test processes sharing the cores must not oversubscribe them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module", params=FAMILIES)
def models(request):
    name = request.param
    jc = dataclasses.replace(j_config(name, smoke=True), dtype="float32")
    tc = dataclasses.replace(t_config(name, smoke=True), dtype="float32")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, TM.params_from_numpy(tc, _np(jp), device="cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _inputs(cfg, seed, b, s):
    """{"tokens": (B, S) int32} or, for a frontend config, {"embeds":
    (B, S, d) standard normals}, as numpy."""
    rng = np.random.default_rng(seed)
    if cfg.name in FRONTEND:
        return {"embeds": rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)}
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def test_forward_logits(models):
    """Logits from tokens, or from embeds with the default positions."""
    jc, tc, jp, tp = models
    batch = _inputs(jc, 1, 2, 12)
    want, jaux = JM.forward(jc, jp, **_j(batch))
    got, aux = TM.forward(tc, tp, **_t(batch), device="cpu")
    _close(got, want)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5, abs=1e-7)
    prefill = make_prefill_step(tc, device="cpu")(tp, _t(batch))
    torch.testing.assert_close(prefill, got, rtol=0, atol=0)


def test_vision_positions_take_three_axes():
    """qwen2-vl-7b from embeds at 3-axis positions that differ between the
    axes (a patch grid's temporal, height and width ids), and musicgen at
    positions that do not start at 0."""
    rng = np.random.default_rng(5)
    for name, positions in (
            ("qwen2-vl-7b", np.stack([np.zeros((2, 12)), np.tile(np.arange(12) // 4, (2, 1)),
                                      np.tile(np.arange(12) % 4, (2, 1))]).astype(np.int32)),
            ("musicgen-large", (np.arange(12)[None] + np.array([[3], [40]])).astype(np.int32))):
        jc = dataclasses.replace(j_config(name, smoke=True), dtype="float32")
        tc = dataclasses.replace(t_config(name, smoke=True), dtype="float32")
        jp = JM.init_params(jc, jax.random.PRNGKey(0))
        tp = TM.params_from_numpy(tc, _np(jp), device="cpu")
        embeds = rng.standard_normal((2, 12, jc.d_model)).astype(np.float32)
        want, _ = JM.forward(jc, jp, embeds=jnp.asarray(embeds), positions=jnp.asarray(positions))
        got, _ = TM.forward(tc, tp, embeds=torch.as_tensor(embeds),
                            positions=torch.as_tensor(positions), device="cpu")
        _close(got, want)
        default, _ = TM.forward(tc, tp, embeds=torch.as_tensor(embeds), device="cpu")
        assert not torch.allclose(default, got, atol=1e-3)


def test_forward_needs_exactly_one_input(models):
    _, tc, _, tp = models
    with pytest.raises(ValueError, match="exactly one"):
        TM.forward(tc, tp, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        TM.forward(tc, tp, torch.zeros((1, 2), dtype=torch.int32),
                   embeds=torch.zeros((1, 2, tc.d_model)), device="cpu")


def test_decode_step_scalar_len(models):
    """A 5-position prefill chunk, then single positions, at a scalar cache
    length; the serve step takes embeds too."""
    jc, tc, jp, tp = models
    batch = _inputs(jc, 2, 2, 8)
    jcache, tcache = JM.init_cache(jc, 2, 16), TM.init_cache(tc, 2, 16, device="cpu")
    step = make_serve_step(tc, device="cpu")
    for lo, hi in [(0, 5), (5, 6), (6, 7)]:
        chunk = {k: v[:, lo:hi] for k, v in batch.items()}
        jl, jcache = JM.decode_step(jc, jp, jcache, **_j(chunk))
        tl, tcache = step(tp, tcache, _t(chunk))
        _close(tl, jl)
        assert tcache["len"] == int(jcache["len"]) == hi
    for jrow, trow in zip(jcache["layers"], tcache["layers"]):
        for jblk, tblk in zip(jrow, trow):
            _close(tblk["k"], jblk["k"])
            _close(tblk["v"], jblk["v"])


def test_decode_step_per_lane_len(models, rng):
    """Packed lanes at mixed positions: a (B,) cache length (per-lane
    sinusoidal and M-RoPE positions)."""
    jc, tc, jp, tp = models
    batch = _inputs(jc, 3, 3, 1)
    lens = np.array([2, 5, 9], np.int32)
    jcache, tcache = JM.init_cache(jc, 3, 16), TM.init_cache(tc, 3, 16, device="cpu")
    fill = rng.standard_normal(tcache["layers"][0][0]["k"].shape).astype(np.float32)
    for jrow, trow in zip(jcache["layers"], tcache["layers"]):
        for jblk, tblk in zip(jrow, trow):
            for key in ("k", "v"):
                jblk[key] = jnp.asarray(fill)
                tblk[key].copy_(torch.as_tensor(fill))
    jcache["len"], tcache["len"] = jnp.asarray(lens), torch.as_tensor(lens)
    jl, jcache = JM.decode_step(jc, jp, jcache, **_j(batch))
    tl, tcache = TM.decode_step(tc, tp, tcache, **_t(batch), device="cpu")
    _close(tl, jl)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    _close(tcache["layers"][1][0]["v"], jcache["layers"][1][0]["v"])


def test_train_step_matches_reference(models):
    """One AdamW step (WSD in warmup) from the JAX init and a warm AdamW
    state (step 7, v = 1e-2) against ``jax.jit(make_train_step)``; the
    frontend configs train from embeds. From zero moments the first step
    moves each parameter by lr·g/(|g| + 1e-8): a gradient of fp32 noise's
    size (~1e-8) moves by a fraction of lr that the noise sets, which the
    warm state's v makes a small multiple of g. The port updates in place,
    so it steps a copy."""
    jc, tc, jp, tp = models
    tp = jax.tree_util.tree_map(torch.clone, tp)
    batch = _inputs(jc, 4, 2, 12)
    labels = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    labels[0, -2:] = -1
    batch["labels"] = labels
    sched = dict(peak_lr=1e-3, warmup=4, total=100)
    jopt, topt = JAdamW(jschedule.wsd(**sched)), TAdamW(tschedule.wsd(**sched))
    jstate = jopt.init(jp)
    jstate = dict(jstate, v=jax.tree_util.tree_map(lambda x: x + 1e-2, jstate["v"]),
                  step=jnp.asarray(7, jnp.int32))
    tstate = TM.opt_state_from_numpy(tc, _np(jstate), device="cpu")
    jp2, jstate2, jm = jax.jit(j_make_train_step(jc, jopt))(jp, jstate, _j(batch))
    tp2, tstate2, tm = make_train_step(tc, topt, device="cpu")(tp, tstate, _t(batch))
    lr = float(jm["lr"])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["moe_aux"]) == pytest.approx(float(jm["moe_aux"]), rel=1e-5, abs=1e-7)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    atol = 1e-5 + 1e-3 * lr
    for tree_j, tree_t in ((jp2, tp2), (jstate2["m"], tstate2["m"]),
                           (jstate2["v"], tstate2["v"])):
        jl, tl = jax.tree_util.tree_leaves(tree_j), leaves(tree_t)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            _close(t, j, atol)


def test_mrope_with_equal_axes_is_rope(rng):
    """M-RoPE with the three axes equal is RoPE (text), and both match the
    JAX package's ``apply_rope``; sections must sum to head_dim / 2."""
    cfg = dataclasses.replace(t_config("qwen2-vl-7b", smoke=True), dtype="float32")
    jcfg = dataclasses.replace(j_config("qwen2-vl-7b", smoke=True), dtype="float32")
    x = rng.standard_normal((2, 8, 4, cfg.head_dim_)).astype(np.float32)
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (2, 8))
    pos3 = np.broadcast_to(pos[None], (3, 2, 8))
    m = tlayers.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(pos3))
    r = tlayers.apply_rope(dataclasses.replace(cfg, rope_type="rope"), torch.as_tensor(x),
                           torch.as_tensor(pos))
    torch.testing.assert_close(m, r, rtol=0, atol=1e-6)
    _close(m, jlayers.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos3)), 1e-6)
    grid = np.stack([pos, pos // 2, pos % 3]).astype(np.int32)
    _close(tlayers.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(grid)),
           jlayers.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(grid)), 1e-6)
    with pytest.raises(ValueError, match="sum to head_dim"):
        tlayers.apply_rope(dataclasses.replace(cfg, mrope_sections=(2, 2, 2)),
                           torch.as_tensor(x), torch.as_tensor(pos3))
    with pytest.raises(ValueError, match=r"\(3, B, S\)"):
        tlayers.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(pos))


@pytest.mark.parametrize("d_model", [64, 2048])
def test_sinusoidal_positions_match_reference(d_model):
    pos = np.array([[0, 1, 2, 3], [7, 100, 4095, 32767]], np.int32)
    want = jlayers.sinusoidal_positions(d_model, jnp.asarray(pos))
    got = tlayers.sinusoidal_positions(d_model, torch.as_tensor(pos))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 4, d_model)
    # the two libraries' fp32 exp of a frequency (≤ 1) differ by up to an
    # ulp, 2^-23 relative, which each angle multiplies by its position: the
    # sin and cos of angles that differ by up to 2^-23·pos
    _close(got, want, 1e-6 + 2.0**-22 * float(pos.max()))
