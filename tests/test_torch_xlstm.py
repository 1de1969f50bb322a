"""The port's xLSTM (mLSTM and sLSTM mixers, xlstm-1.3b's stack) against the
JAX package's, on the CPU.

The xlstm-1.3b smoke config (8 layers: one period of 7 mLSTM and 1 sLSTM
blocks) in float32, the JAX init's weights carried over with
``params_from_numpy`` in both stack layouts, the same numpy inputs on both
sides. Tolerances, each for float32 sums taken in another order:

* one mLSTM or sLSTM layer, forward and decode: 1e-5 of the largest
  |output| (the mLSTM's outputs reach ~11 here; its exponentials and
  normaliser differ from XLA's by an ulp or two);
* the chunked mLSTM against the per-step oracle: 2e-4, the JAX package's
  own (``tests/test_models.py``);
* the stack's forward and decode logits: 2e-3, the JAX package's own for
  this stack (``tests/test_models.py``, decode against forward). The stack
  amplifies a rounding difference with depth, in both packages
  (``test_forward_and_decode_part_with_depth_in_both_packages``): the
  mLSTM normaliser max(|q·n|, exp(-m)) divides by values near exp(-3);
* the train step: the loss at rtol 1e-5 and the gradient norm at 1e-4
  (``tests/test_torch_train.py``'s); each gradient leaf within 2e-3 of its
  largest entry, the logits' bound (the same amplified fp32 noise); one
  AdamW step from a warm state (step 7, v = 1e-2): parameters within
  ``test_torch_train.py``'s 1e-5 + 1e-3·lr, each moment leaf within the
  gradients' 2e-3 of its largest entry, ``compress_bf16`` off. From zero
  moments AdamW's first step moves each parameter by ±lr, the sign of its
  gradient, and that noise flips the sign of the near-zero ones; a bf16
  cast of the gradients turns it into a whole bf16 ulp where a value sits
  at a rounding boundary.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.core.bsp import BSPAccelerator as JPack
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import xlstm as jxl
from repro.optim import schedule as jschedule
from repro.optim.adamw import AdamW as JAdamW
from repro.train.steps import make_train_step as j_make_train_step
from repro_torch.configs import get_config as t_config
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import model as TM
from repro_torch.models import xlstm as txl
from repro_torch.optim import schedule as tschedule
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.optim.adamw import leaves
from repro_torch.train.steps import make_train_step

NAME = "xlstm-1.3b"
# a fixed pack (the JAX engine tests' own): no calibration in tests
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")


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


def _pair(**overrides):
    jc = dataclasses.replace(j_config(NAME, smoke=True), dtype="float32", **overrides)
    tc = dataclasses.replace(t_config(NAME, smoke=True), dtype="float32", **overrides)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, TM.params_from_numpy(tc, _np(jp), device="cpu")


@pytest.fixture(scope="module")
def models():
    return _pair()


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def _rel_close(got, want, tol=1e-5):
    """Within ``tol`` of the largest |want|."""
    want = np.asarray(want, np.float32)
    _close(got, want, tol * np.abs(want).max())


def _mixer(models, j):
    """The configs and period position j's mixer params (JAX, port):
    j = 0 an mLSTM block, j = 7 the sLSTM block."""
    jc, tc, jp, tp = models
    return jc, tc, jp["stack"][0][j]["mixer"], tp["stack"][0][j]["mixer"]


def _tokens(cfg, seed, shape):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.mark.parametrize("chunk", [128, 16])
def test_mlstm_forward_matches_reference(models, rng, chunk):
    """One chunk (S ≤ chunk), and S = 50 in chunks of 16 (a padded tail)."""
    jc, tc, jpm, tpm = _mixer(models, 0)
    x = rng.standard_normal((2, 50, jc.d_model)).astype(np.float32)
    want = jxl.mlstm_forward(jc, jpm, jnp.asarray(x), chunk=chunk)
    _rel_close(txl.mlstm_forward(tc, tpm, torch.as_tensor(x), chunk=chunk), want)


def test_mlstm_step_ref_matches_reference(models, rng):
    jc, tc, jpm, tpm = _mixer(models, 0)
    x = rng.standard_normal((2, 20, jc.d_model)).astype(np.float32)
    want = jxl.mlstm_step_ref(jc, jpm, jnp.asarray(x))
    _rel_close(txl.mlstm_step_ref(tc, tpm, torch.as_tensor(x)), want)


def test_mlstm_chunked_matches_per_step(models, rng):
    """The port's chunked form against its own per-step oracle, S = 50 in
    chunks of 16 (the reference's test)."""
    _, tc, _, tpm = _mixer(models, 0)
    x = torch.as_tensor(rng.standard_normal((2, 50, tc.d_model)).astype(np.float32))
    _close(txl.mlstm_forward(tc, tpm, x, chunk=16), txl.mlstm_step_ref(tc, tpm, x).numpy(),
           2e-4)


def test_slstm_forward_matches_reference(models, rng):
    jc, tc, jpm, tpm = _mixer(models, 7)
    x = rng.standard_normal((2, 20, jc.d_model)).astype(np.float32)
    _rel_close(txl.slstm_forward(tc, tpm, torch.as_tensor(x)),
               jxl.slstm_forward(jc, jpm, jnp.asarray(x)))


@pytest.mark.parametrize("j", [0, 7], ids=["mlstm", "slstm"])
def test_xlstm_decode_matches_reference(models, rng, j):
    """Ten single-token steps of one layer: outputs and every state leaf."""
    jc, tc, jpm, tpm = _mixer(models, j)
    jinit, tinit, jdec, tdec = ((jxl.init_mlstm_cache, txl.init_mlstm_cache, jxl.mlstm_decode,
                                 txl.mlstm_decode) if j == 0 else
                                (jxl.init_slstm_cache, txl.init_slstm_cache, jxl.slstm_decode,
                                 txl.slstm_decode))
    jcache, tcache = jinit(jc, 2), tinit(tc, 2, "cpu")
    x = rng.standard_normal((2, 10, jc.d_model)).astype(np.float32)
    for t in range(10):
        jy, jcache = jdec(jc, jpm, jnp.asarray(x[:, t:t + 1]), jcache)
        ty, tcache = tdec(tc, tpm, torch.as_tensor(x[:, t:t + 1]), tcache)
        _rel_close(ty, jy)
    assert sorted(tcache) == sorted(jcache)
    for key in jcache:
        assert tcache[key].dtype == torch.float32
        _rel_close(tcache[key], jcache[key])


@pytest.mark.parametrize("scan_layers", [False, True])
def test_forward_logits(rng, scan_layers):
    """The stack's logits from both of the JAX package's stack layouts (the
    period-stacked one holds the 8-block period once)."""
    jc, tc, jp, tp = _pair(scan_layers=scan_layers)
    toks = _tokens(jc, 1, (2, 24))
    want, jaux = JM.forward(jc, jp, jnp.asarray(toks))
    got, aux = TM.forward(tc, tp, torch.as_tensor(toks), device="cpu")
    _close(got, want, 2e-3)
    assert float(aux) == float(jaux) == 0.0


def test_decode_matches_reference_and_forward(models):
    """Token-at-a-time decode: each step's logits against the reference's
    decode_step, and all of them against the teacher-forced forward."""
    jc, tc, jp, tp = models
    toks = _tokens(jc, 2, (2, 10))
    full, _ = TM.forward(tc, tp, torch.as_tensor(toks), device="cpu")
    jcache, tcache = JM.init_cache(jc, 2, 10), TM.init_cache(tc, 2, 10, device="cpu")
    outs = []
    for t in range(10):
        jl, jcache = JM.decode_step(jc, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.as_tensor(toks[:, t:t + 1]),
                                    device="cpu")
        _close(tl, jl, 2e-3)
        outs.append(tl)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="recurrent mixers"):
        TM.decode_step(tc, tp, tcache, torch.as_tensor(toks[:, :2]), device="cpu")


def test_forward_and_decode_part_with_depth_in_both_packages():
    """The chunked forward and the token-at-a-time decode round differently,
    and the random-weight stack amplifies that difference with depth, in
    the JAX package as in the port: at 8 layers both agree within 2e-3, at
    48 layers each package's two forms are more than 10x further apart.
    So the card's check holds a 2-layer cut (``chip_smoke.py``)."""
    gaps = {}
    for layers in (8, 48):
        jc, tc, jp, tp = _pair(num_layers=layers, scan_layers=True)
        toks = _tokens(jc, 6, (2, 16))
        jfull = np.asarray(JM.forward(jc, jp, jnp.asarray(toks))[0][:, -1])
        tfull = TM.forward(tc, tp, torch.as_tensor(toks), device="cpu")[0][:, -1].numpy()
        jcache, tcache = JM.init_cache(jc, 2, 16), TM.init_cache(tc, 2, 16, device="cpu")
        jstep = jax.jit(lambda p, c, t, jc=jc: JM.decode_step(jc, p, c, t))
        for t in range(16):
            jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, t:t + 1]))
            tl, tcache = TM.decode_step(tc, tp, tcache, torch.as_tensor(toks[:, t:t + 1]),
                                        device="cpu")
        gaps[layers] = (np.abs(jfull - np.asarray(jl[:, -1])).max(),
                        np.abs(tfull - tl[:, -1].numpy()).max())
    assert max(gaps[8]) < 2e-3
    assert all(deep > 10 * shallow for deep, shallow in zip(gaps[48], gaps[8])), gaps


@pytest.mark.parametrize("compiled", [True, False])
def test_greedy_generate_matches_reference(models, compiled):
    """The prompt prefilled token-at-a-time (block 1), then greedy decode:
    the JAX package's token ids."""
    jc, tc, jp, tp = models
    prompt = _tokens(jc, 3, (2, 7))
    assert tserve.prefill_block_size(tc, 2, 7, TPack(**PACK)) == 1
    want, _ = jserve.generate(jc, jp, jnp.asarray(prompt), steps=5, machine=JPack(**PACK),
                              compiled=compiled)
    got, _ = tserve.generate(tc, tp, prompt, steps=5, machine=TPack(**PACK),
                             compiled=compiled, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _batch(cfg, seed):
    toks = _tokens(cfg, seed, (2, 13))
    labels = toks[:, 1:].copy()
    labels[0, -2:] = -1
    return toks[:, :-1], labels


def test_loss_and_grads_match_reference(models):
    jc, tc, jp, tp = models
    toks, labels = _batch(jc, 4)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.loss_fn(jc, p, jnp.asarray(toks), jnp.asarray(labels)), has_aux=True)(jp)
    live = jax.tree_util.tree_map(lambda t: t.detach().requires_grad_(True), tp)
    loss, tm = TM.loss_fn(tc, live, torch.as_tensor(toks), torch.as_tensor(labels),
                          device="cpu")
    tg = torch.autograd.grad(loss, leaves(live))
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)
    assert float(tm["moe_aux"]) == float(jm["moe_aux"]) == 0.0
    jleaves = jax.tree_util.tree_leaves(jg)
    assert len(jleaves) == len(tg)
    for j, t in zip(jleaves, tg):
        _rel_close(t, j, 2e-3)


@pytest.mark.parametrize("remat", ["none", "full"])
def test_train_step_matches_reference(remat):
    """One AdamW step (WSD in warmup, fp32 gradients) from a warm state against
    ``jax.jit(make_train_step)``; under ``remat="full"`` the 8-block period
    is recomputed in the backward pass on both sides."""
    jc, tc, jp, tp = _pair(remat=remat)
    toks, labels = _batch(jc, 5)
    sched = dict(peak_lr=1e-3, warmup=4, total=100)
    jopt, topt = JAdamW(jschedule.wsd(**sched)), TAdamW(tschedule.wsd(**sched))
    jstate = jopt.init(jp)
    jstate = dict(jstate, v=jax.tree_util.tree_map(lambda x: x + 1e-2, jstate["v"]),
                  step=jnp.asarray(7, jnp.int32))
    tstate = TM.opt_state_from_numpy(tc, _np(jstate), device="cpu")
    jp2, jstate2, jm = jax.jit(j_make_train_step(jc, jopt, compress_bf16=False))(
        jp, jstate, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    tp2, tstate2, tm = make_train_step(tc, topt, compress_bf16=False, device="cpu")(
        tp, tstate, {"tokens": torch.as_tensor(toks), "labels": torch.as_tensor(labels)})
    lr = float(jm["lr"])
    assert float(tm["loss"]) == pytest.approx(float(jm["loss"]), rel=1e-5)
    assert float(tm["grad_norm"]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    for tree_j, tree_t, close in (
            (jp2, tp2, lambda t, j: _close(t, j, 1e-5 + 1e-3 * lr)),
            # m is 0.1 x the clipped gradient: the gradients' tolerance
            (jstate2["m"], tstate2["m"], lambda t, j: _rel_close(t, j, 2e-3)),
            (jstate2["v"], tstate2["v"], lambda t, j: _rel_close(t, j, 2e-3))):
        jl, tl = jax.tree_util.tree_leaves(tree_j), leaves(tree_t)
        assert len(jl) == len(tl)
        for j, t in zip(jl, tl):
            close(t, j)


def test_engine_refuses_the_recurrent_stack(models):
    _, tc, _, tp = models
    with pytest.raises(ValueError, match="attention-only"):
        ServeEngine(tc, tp, machine=TPack(**PACK), device="cpu")
