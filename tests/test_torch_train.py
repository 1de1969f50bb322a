"""The port's training path against the JAX package's, on the CPU.

The 2-layer float32 smoke cuts of minicpm-2b (tied head), codeqwen1.5-7b
(untied head, GQA) and jamba-v0.1-52b (Mamba + MoE, attention + dense;
the loss also at its 8-layer smoke depth), the JAX
init's weights carried over with ``params_from_numpy``, the same numpy
tokens on both sides. Tolerances, each for float32 sums taken in another
order (the port's CPU path runs the kernels' plain versions):

* ``loss_fn``'s value: rtol 1e-5;
* every gradient leaf (``compress_bf16=False``): rtol 1e-4, atol 1e-6;
  jamba's atol 1e-6 in units of the leaf's largest entry where that
  exceeds 1 (its Mamba layers: the port's reverse-time walk against
  ``jax.grad`` through ``chunked_selective_scan``'s closed-form chunk
  sums, which round otherwise: one entry of the (256, 64) embedding
  gradient, whose entries reach 5.0, lies 1.6e-6 past rtol);
* one ``make_train_step`` (AdamW, with and without ``compress_bf16``):
  parameters and moments within 1e-5 + 1e-3·lr (absolute);
* ``remat="full"`` and ``"dots"`` against ``"none"``: rtol 1e-6, atol 1e-7
  (the same float32 ops in the same order: bit-equal in practice);
* schedules: rtol 1e-6 (float32 on both sides);
* the flash Function's and the matmul Function's gradients: rtol 1e-4,
  atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import Block as JBlock
from repro.configs import get_config as j_config
from repro.models import model as JM
from repro.models.flash import flash_attention_vjp
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule
from repro.optim.adamw import AdamW as JAdamW
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import Block as TBlock
from repro_torch.configs import get_config as t_config
from repro_torch.kernels import ops
from repro_torch.models import model as TM
from repro_torch.models.flash import FlashAttention
from repro_torch.optim import compress as tcompress
from repro_torch.optim import schedule as tschedule
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import global_norm, leaves
from repro_torch.train.steps import abstract_opt_state, make_train_step

ARCHS = ["minicpm-2b", "codeqwen1.5-7b"]
# jamba's smoke widths at 2 layers, each block kind once (Mamba + MoE,
# attention + dense), take the gradient and train-step tests, not the rest:
# its loss carries the MoE aux term. Its 8-layer smoke cut holds the loss
# (test_hybrid_loss_and_aux_match_reference); its gradients drift from the
# reference's by fp32 noise over 8 layers (2e-6 to 8e-6 relative L2 on an
# embedding row, some small entries past rtol 1e-4), as the other configs'
# tests take 2-layer cuts
TRAIN_ARCHS = [*ARCHS, "jamba-v0.1-52b"]
JAMBA_CUT = dict(num_layers=2, pattern=(("mamba", "moe"), ("attn", "dense")))


def _np(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _pair(name, pattern=None, **overrides):
    """The JAX and port configs of ``name``'s smoke cut in float32 (with
    ``pattern`` as (mixer, mlp) pairs, if given), the JAX init's weights and
    their port copy."""
    jo, to = dict(overrides), dict(overrides)
    if pattern is not None:
        jo["pattern"] = tuple(JBlock(*b) for b in pattern)
        to["pattern"] = tuple(TBlock(*b) for b in pattern)
    jc = dataclasses.replace(j_config(name, smoke=True), dtype="float32", **jo)
    tc = dataclasses.replace(t_config(name, smoke=True), dtype="float32", **to)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, TM.params_from_numpy(tc, _np(jp), device="cpu")


def _batch(cfg, seed=0, b=2, s=12):
    """Tokens and next-token labels, the last two labels of row 0 padding."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, -2:] = -1
    return toks[:, :-1], labels


def _leaf_pairs(jtree, ttree):
    """(jax leaf, port leaf) pairs in one order (sorted dict keys on both)."""
    jl = jax.tree_util.tree_leaves(jtree)
    tl = leaves(ttree)
    assert len(jl) == len(tl)
    return list(zip(jl, tl))


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param, **(JAMBA_CUT if request.param == "jamba-v0.1-52b" else {}))


def test_loss_matches_reference(models):
    jc, tc, jp, tp = models
    toks, labels = _batch(jc)
    jl, jm = JM.loss_fn(jc, jp, jnp.asarray(toks), jnp.asarray(labels))
    tl, tm = TM.loss_fn(tc, tp, torch.as_tensor(toks), torch.as_tensor(labels), device="cpu")
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)
    assert float(tm["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)
    assert float(tm["moe_aux"]) == float(jm["moe_aux"]) == 0.0


@pytest.mark.parametrize("models", TRAIN_ARCHS, indirect=True)
def test_grads_match_reference(models):
    """Every gradient leaf against ``jax.grad`` of the reference's loss,
    jamba's through the reference's ``chunked_selective_scan``, the scan
    its training path differentiates."""
    jc, tc, jp, tp = models
    toks, labels = _batch(jc, seed=1)
    scaled = jc.name.startswith("jamba")
    jg = jax.grad(lambda p: JM.loss_fn(jc, p, jnp.asarray(toks), jnp.asarray(labels))[0])(jp)
    live = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, _ = TM.loss_fn(tc, live, torch.as_tensor(toks), torch.as_tensor(labels),
                         device="cpu")
    tg = torch.autograd.grad(loss, leaves(live))
    for (j, _), t in zip(_leaf_pairs(jg, live), tg):
        j = np.asarray(j)
        scale = max(1.0, float(np.abs(j).max())) if scaled else 1.0
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-6 * scale)


def _remat_loss_and_grads(tc, tp, toks, labels, remat):
    cfg = dataclasses.replace(tc, remat=remat)
    live = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, _ = TM.loss_fn(cfg, live, torch.as_tensor(toks), torch.as_tensor(labels),
                         device="cpu")
    return loss.detach(), torch.autograd.grad(loss, leaves(live))


@pytest.mark.parametrize("models", TRAIN_ARCHS, indirect=True)
def test_remat_full_gives_the_same_grads(models):
    """``remat="full"`` recomputes each period in the backward pass
    (``torch.utils.checkpoint``) and ``"dots"`` too, with its matmuls'
    outputs kept from the forward: the loss and every gradient leaf of
    ``"none"`` (the same float32 ops in the same order, so bit-equal here;
    held at rtol 1e-6, atol 1e-7)."""
    _, tc, _, tp = models
    toks, labels = _batch(tc, seed=2)
    runs = {remat: _remat_loss_and_grads(tc, tp, toks, labels, remat)
            for remat in ("none", "full", "dots")}
    for remat in ("full", "dots"):
        torch.testing.assert_close(runs[remat][0], runs["none"][0], rtol=1e-6, atol=1e-7)
        for a, b in zip(runs[remat][1], runs["none"][1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("models", TRAIN_ARCHS, indirect=True)
def test_remat_dots_grads_match_reference(models):
    """``remat="dots"`` against the reference's loss and ``jax.grad`` under
    its ``"dots"`` (``checkpoint_dots_with_no_batch_dims``), at
    :func:`test_grads_match_reference`'s tolerances."""
    jc, tc, jp, tp = models
    jc = dataclasses.replace(jc, remat="dots")
    toks, labels = _batch(jc, seed=1)
    scaled = jc.name.startswith("jamba")
    jl, jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jc, p, jnp.asarray(toks), jnp.asarray(labels))[0])(jp)
    loss, tg = _remat_loss_and_grads(tc, tp, toks, labels, "dots")
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    for (j, _), t in zip(_leaf_pairs(jg, tp), tg):
        j = np.asarray(j)
        scale = max(1.0, float(np.abs(j).max())) if scaled else 1.0
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-4, atol=1e-6 * scale)


def test_remat_dots_makes_each_product_once(models, monkeypatch):
    """The products that reach ``ops.matmul`` in one loss and backward:
    ``"dots"`` makes the forward's once, as ``"none"`` does; ``"full"``
    makes the periods' forward products a second time in the backward pass
    (every product but the LM head, which sits outside the periods)."""
    _, tc, _, tp = models
    toks, labels = _batch(tc, seed=4)
    calls = []
    matmul = ops.matmul

    def counted(*args, **kwargs):
        calls.append(1)
        return matmul(*args, **kwargs)

    monkeypatch.setattr(ops, "matmul", counted)
    made = {}
    for remat in ("none", "full", "dots"):
        calls.clear()
        _remat_loss_and_grads(tc, tp, toks, labels, remat)
        made[remat] = len(calls)
    calls.clear()
    with torch.no_grad():
        TM.loss_fn(tc, tp, torch.as_tensor(toks), torch.as_tensor(labels), device="cpu")
    forward = len(calls)
    assert made["none"] == made["dots"] == 3 * forward
    assert made["full"] == 4 * forward - 1


def test_unknown_remat_raises(models):
    _, tc, _, tp = models
    toks, labels = _batch(tc, seed=2)
    with pytest.raises(ValueError, match="remat"):
        _remat_loss_and_grads(tc, tp, toks, labels, "offload")


@pytest.mark.parametrize("compress_bf16", [True, False])
@pytest.mark.parametrize("models", TRAIN_ARCHS, indirect=True)
def test_train_step_matches_reference(models, compress_bf16):
    """One AdamW step (WSD schedule in warmup) from the JAX init: the port's
    parameters and moments against ``jax.jit(make_train_step)``'s. The port
    updates in place, so it steps a copy of the module's parameters."""
    jc, tc, jp, tp = models
    tp = jax.tree_util.tree_map(torch.clone, tp)
    toks, labels = _batch(jc, seed=3)
    sched = dict(peak_lr=1e-3, warmup=4, total=100)
    jopt, topt = JAdamW(jschedule.wsd(**sched)), TAdamW(tschedule.wsd(**sched))
    jstate = jopt.init(jp)
    tstate = TM.opt_state_from_numpy(tc, _np(jstate), device="cpu")
    jstep = jax.jit(j_make_train_step(jc, jopt, compress_bf16=compress_bf16))
    tstep = make_train_step(tc, topt, compress_bf16=compress_bf16, device="cpu")
    jbatch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    jp2, jstate2, jm = jstep(jp, jstate, jbatch)
    tp2, tstate2, tm = tstep(tp, tstate, {"tokens": torch.as_tensor(toks),
                                          "labels": torch.as_tensor(labels)})
    assert tp2 is tp and tstate2["m"] is tstate["m"]             # updated in place
    lr = float(jm["lr"])
    assert float(tm["lr"]) == pytest.approx(lr, rel=1e-6)
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    assert int(tstate2["step"]) == int(jstate2["step"]) == 1
    atol = 1e-5 + 1e-3 * lr
    for tree_j, tree_t in ((jp2, tp2), (jstate2["m"], tstate2["m"]),
                           (jstate2["v"], tstate2["v"])):
        for j, t in _leaf_pairs(tree_j, tree_t):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)


def test_abstract_opt_state_and_state_carry_over(models):
    jc, tc, jp, tp = models
    opt = TAdamW(tschedule.constant(1e-3))
    meta = abstract_opt_state(opt, tp)
    for tree in (meta["m"], meta["v"]):
        for (j, _), t in zip(_leaf_pairs(jp, tp), leaves(tree)):
            assert t.device.type == "meta" and t.dtype == torch.float32
            assert tuple(t.shape) == tuple(j.shape)
    assert meta["step"].dtype == torch.int32 and meta["step"].device.type == "meta"
    jstate = JAdamW(jschedule.constant(1e-3)).init(jp)
    jstate = dict(jstate, m=jax.tree_util.tree_map(lambda x: x + 0.5, jstate["m"]),
                  step=jnp.asarray(7, jnp.int32))
    tstate = TM.opt_state_from_numpy(tc, _np(jstate), device="cpu")
    assert int(tstate["step"]) == 7
    for j, t in _leaf_pairs(jstate["m"], tstate["m"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("name,kw", [
    ("linear_warmup_cosine", dict(peak_lr=3e-4, warmup=5, total=40)),
    ("linear_warmup_cosine", dict(peak_lr=1e-3, warmup=0, total=17, floor=0.2)),
    ("wsd", dict(peak_lr=3e-4, warmup=5, total=40)),
    ("wsd", dict(peak_lr=1e-2, warmup=3, total=31, decay_frac=0.25, floor=0.05)),
    ("constant", dict(lr=2e-4)),
])
def test_schedules_match_reference(name, kw):
    jf, tf = getattr(jschedule, name)(**kw), getattr(tschedule, name)(**kw)
    total = kw.get("total", 20)
    for step in range(total + 2):
        want = float(jf(jnp.asarray(step, jnp.int32)))
        for arg in (step, torch.tensor(step, dtype=torch.int32)):
            got = tf(arg)
            assert got.dtype == torch.float32 and got.dim() == 0
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), (step, arg)


def test_global_norm_and_bf16_grads_match_reference(rng):
    tree = {"b": [rng.standard_normal((3, 5)).astype(np.float32)],
            "a": {"w": rng.standard_normal((7,)).astype(np.float32)}}
    jt = jax.tree_util.tree_map(jnp.asarray, tree)
    tt = jax.tree_util.tree_map(torch.as_tensor, tree)
    from repro.optim.adamw import global_norm as j_global_norm
    assert float(global_norm(tt)) == pytest.approx(float(j_global_norm(jt)), rel=1e-6)
    jb, tb = jcompress.bf16_grads(jt), tcompress.bf16_grads(tt)
    for j, t in _leaf_pairs(jb, tb):
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.float().numpy(), np.asarray(j, np.float32))
    mixed = {"x": torch.ones(2, dtype=torch.bfloat16), "y": torch.ones(2, dtype=torch.int32)}
    assert tcompress.bf16_grads(mixed)["y"].dtype == torch.int32


@pytest.mark.parametrize("ratio", [0.01, 0.2])
def test_topk_compressor_matches_reference(rng, ratio):
    shapes = {"w": (40, 25), "b": [(300,), (7, 3)]}
    grads = {"w": rng.standard_normal(shapes["w"]).astype(np.float32),
             "b": [rng.standard_normal(s).astype(np.float32) for s in shapes["b"]]}
    jc, tc = jcompress.TopKCompressor(ratio), tcompress.TopKCompressor(ratio)
    jt = jax.tree_util.tree_map(jnp.asarray, grads)
    tt = jax.tree_util.tree_map(torch.as_tensor, grads)
    jerr, terr = jc.init(jt), tc.init(tt)
    for _ in range(3):               # error feedback carries over the steps
        jsparse, jerr = jc.compress(jt, jerr)
        tsparse, terr = tc.compress(tt, terr)
        for tree_j, tree_t in ((jsparse, tsparse), (jerr, terr)):
            for j, t in _leaf_pairs(tree_j, tree_t):
                np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    assert tc.words_exchanged(1000) == jc.words_exchanged(1000)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("sq,skv,block", [(40, 40, 1024), (40, 40, 16), (24, 56, 16)])
def test_flash_function_grads_match_reference(rng, causal, hq, hkv, sq, skv, block):
    """(dq, dk, dv) of the port's FlashAttention against ``jax.vjp`` of the
    reference's ``flash_attention_vjp``: one tile and several (ragged), the
    queries at the end of the keys when Sq < Skv."""
    b, d = 2, 16
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    do = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    q_offset = skv - sq
    out, vjp = jax.vjp(lambda q_, k_, v_: flash_attention_vjp(
        q_, k_, v_, causal, q_offset, block, block), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    tq, tk, tv = (torch.as_tensor(x).requires_grad_(True) for x in (q, k, v))
    got_out = FlashAttention.apply(tq, tk, tv, causal, None, block, block)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=1e-4,
                               atol=1e-5)
    got = torch.autograd.grad(got_out, (tq, tk, tv), torch.as_tensor(do))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_flash_lse_plain_version(rng):
    """``return_lse`` on the CPU: the plain version's log-sum-exp of the
    scaled, causally masked scores."""
    q = torch.as_tensor(rng.standard_normal((1, 2, 5, 8)).astype(np.float32))
    k = torch.as_tensor(rng.standard_normal((1, 2, 7, 8)).astype(np.float32))
    out, lse = ops.attention(q, k, k, causal=True, return_lse=True)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 8 ** -0.5
    keep = torch.arange(5)[:, None] + 2 >= torch.arange(7)[None, :]
    want = torch.logsumexp(s.masked_fill(~keep, float("-inf")), -1)
    assert lse.shape == (1, 2, 5) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, want)
    torch.testing.assert_close(out, ops.attention(q, k, k, causal=True))


@pytest.mark.parametrize("b_layout", ["kn", "nk"])
def test_matmul_function_grads_match_einsum(rng, b_layout):
    """The matmul Function's (dA, dB) against ``jax.vjp`` of the einsum, for
    B stored (k, n) and (n, k): the backward's products in the other
    layouts on the plain version."""
    m, k, n = 6, 10, 7
    a = rng.standard_normal((m, k)).astype(np.float32)
    bm = rng.standard_normal((k, n) if b_layout == "kn" else (n, k)).astype(np.float32)
    dc = rng.standard_normal((m, n)).astype(np.float32)
    spec = "mk,kn->mn" if b_layout == "kn" else "mk,nk->mn"
    out, vjp = jax.vjp(lambda x, y: jnp.einsum(spec, x, y), jnp.asarray(a), jnp.asarray(bm))
    want = vjp(jnp.asarray(dc))
    ta, tb = (torch.as_tensor(x).requires_grad_(True) for x in (a, bm))
    got_out = ops.Matmul.apply(ta, tb, b_layout, torch.float32)
    np.testing.assert_allclose(got_out.detach().numpy(), np.asarray(out), rtol=1e-5,
                               atol=1e-6)
    got = torch.autograd.grad(got_out, (ta, tb), torch.as_tensor(dc))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-5)


def test_hybrid_loss_and_aux_match_reference():
    """jamba's smoke cut: the loss with its MoE load-balancing term."""
    jc, tc, jp, tp = _pair("jamba-v0.1-52b")
    toks, labels = _batch(jc, seed=4, s=10)
    jl, jm = JM.loss_fn(jc, jp, jnp.asarray(toks), jnp.asarray(labels), aux_weight=0.1)
    tl, tm = TM.loss_fn(tc, tp, torch.as_tensor(toks), torch.as_tensor(labels),
                        aux_weight=0.1, device="cpu")
    assert float(jm["moe_aux"]) > 0
    assert float(tm["moe_aux"]) == pytest.approx(float(jm["moe_aux"]), rel=1e-5)
    assert float(tm["ce"]) == pytest.approx(float(jm["ce"]), rel=1e-5)
    assert float(tl) == pytest.approx(float(jl), rel=1e-5)


def test_training_descends_on_learnable_data():
    """End-to-end: a tiny model overfits a fixed repeating sequence (a copy
    of the JAX package's test, on the port)."""
    cfg = dataclasses.replace(t_config("minicpm-2b", smoke=True), num_layers=2,
                              dtype="float32")
    opt = TAdamW(schedule=tschedule.constant(3e-3), weight_decay=0.0)
    params = TM.init_params(cfg, 0, device="cpu")
    state = opt.init(params)
    step = make_train_step(cfg, opt, device="cpu")
    toks = torch.arange(16, dtype=torch.int32)[None].repeat(4, 2)      # periodic
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    first = last = None
    for i in range(30):
        params, state, m = step(params, state, batch)
        if i == 0:
            first = float(m["loss"])
        last = float(m["loss"])
    assert last < first * 0.5, (first, last)
