"""The port's dense decoder against the JAX package's, on the CPU.

minicpm-2b (tied head) and codeqwen1.5-7b (untied head, through the matmul
wrapper) smoke configs in float32; the JAX init's weights carried over with
``params_from_numpy``. Forward and decode logits agree within 1e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.models import model as JM
from repro_torch.configs import get_config as t_config
from repro_torch.models import model as TM

ATOL = 1e-4
ARCHS = ["minicpm-2b", "codeqwen1.5-7b"]


def _numpy_tree(params):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)


def _pair(name, **overrides):
    jc = dataclasses.replace(j_config(name, smoke=True), dtype="float32", **overrides)
    tc = dataclasses.replace(t_config(name, smoke=True), dtype="float32", **overrides)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, jp, TM.params_from_numpy(tc, _numpy_tree(jp), device="cpu")


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    return _pair(request.param)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32),
                               rtol=0, atol=atol)


def test_configs_are_copies():
    for name in ARCHS:
        for smoke in (False, True):
            assert (dataclasses.asdict(t_config(name, smoke=smoke))
                    == dataclasses.asdict(j_config(name, smoke=smoke)))


@pytest.mark.parametrize("name", ARCHS)
def test_count_params_from_the_config(name):
    for smoke in (False, True):
        assert TM.count_params(t_config(name, smoke=smoke)) == \
            JM.count_params(j_config(name, smoke=smoke))


def test_forward_logits(models, rng):
    jc, tc, jp, tp = models
    toks = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    want, _ = JM.forward(jc, jp, jnp.asarray(toks))
    _close(TM.forward(tc, tp, torch.as_tensor(toks), device="cpu"), want)


def test_decode_step_scalar_len(models, rng):
    """A 5-token prefill chunk, then single tokens, at a scalar cache length."""
    jc, tc, jp, tp = models
    toks = rng.integers(0, jc.vocab_size, (2, 8)).astype(np.int32)
    jcache, tcache = JM.init_cache(jc, 2, 16), TM.init_cache(tc, 2, 16, device="cpu")
    for lo, hi in [(0, 5), (5, 6), (6, 7)]:
        jl, jcache = JM.decode_step(jc, jp, jcache, jnp.asarray(toks[:, lo:hi]))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.as_tensor(toks[:, lo:hi]),
                                    device="cpu")
        _close(tl, jl)
        assert tcache["len"] == int(jcache["len"]) == hi
    for jrow, trow in zip(jcache["layers"], tcache["layers"]):
        for jblk, tblk in zip(jrow, trow):
            _close(tblk["k"], jblk["k"])
            _close(tblk["v"], jblk["v"])


def test_decode_step_per_lane_len(models, rng):
    """Packed lanes at mixed positions: a (B,) cache length."""
    jc, tc, jp, tp = models
    toks = rng.integers(0, jc.vocab_size, (3, 1)).astype(np.int32)
    lens = np.array([2, 5, 9], np.int32)
    jcache, tcache = JM.init_cache(jc, 3, 16), TM.init_cache(tc, 3, 16, device="cpu")
    fill = rng.standard_normal(tcache["layers"][0][0]["k"].shape).astype(np.float32)
    for jrow, trow in zip(jcache["layers"], tcache["layers"]):
        for jblk, tblk in zip(jrow, trow):
            for key in ("k", "v"):
                jblk[key] = jnp.asarray(fill)
                tblk[key].copy_(torch.as_tensor(fill))
    jcache["len"], tcache["len"] = jnp.asarray(lens), torch.as_tensor(lens)
    jl, jcache = JM.decode_step(jc, jp, jcache, jnp.asarray(toks))
    tl, tcache = TM.decode_step(tc, tp, tcache, torch.as_tensor(toks), device="cpu")
    _close(tl, jl)
    np.testing.assert_array_equal(tcache["len"].numpy(), np.asarray(jcache["len"]))
    _close(tcache["layers"][1][0]["v"], jcache["layers"][1][0]["v"])


def test_scan_layers_params_carry_over(rng):
    """Period-stacked JAX params (scan_layers=True) unstack into the port's
    per-layer layout."""
    jc, tc, jp, tp = _pair("minicpm-2b", scan_layers=True)
    assert np.asarray(jp["stack"][0]["mixer"]["wq"]).ndim == 3
    toks = rng.integers(0, jc.vocab_size, (2, 6)).astype(np.int32)
    want, _ = JM.forward(jc, jp, jnp.asarray(toks))
    _close(TM.forward(tc, tp, torch.as_tensor(toks), device="cpu"), want)


def test_bf16_weights_carry_over_exactly():
    jc = j_config("minicpm-2b", smoke=True)
    tc = t_config("minicpm-2b", smoke=True)
    jp = JM.init_params(jc, jax.random.PRNGKey(3))
    tp = TM.params_from_numpy(tc, _numpy_tree(jp), device="cpu")
    got = tp["stack"][1][0]["mlp"]["w_down"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(jp["stack"][1][0]["mlp"]["w_down"], np.float32))


def test_bf16_forward_runs_on_the_cpu(rng):
    """The config's own dtype through the plain versions: finite, close to
    float32 (bf16 rounding over two layers)."""
    tc = t_config("minicpm-2b", smoke=True)
    tp = TM.init_params(tc, 0, device="cpu")
    toks = torch.as_tensor(rng.integers(0, tc.vocab_size, (1, 8)))
    got = TM.forward(tc, tp, toks, device="cpu")
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    t32 = dataclasses.replace(tc, dtype="float32")
    p32 = jax.tree_util.tree_map(lambda t: t.float(), tp)
    want = TM.forward(t32, p32, toks, device="cpu")
    assert (got.float() - want).abs().max() <= 0.05 * want.abs().max()


def test_init_params_is_seeded():
    tc = t_config("codeqwen1.5-7b", smoke=True)
    a, b = TM.init_params(tc, 7, device="cpu"), TM.init_params(tc, 7, device="cpu")
    assert torch.equal(a["embed"]["head"], b["embed"]["head"])
    assert not torch.equal(a["embed"]["head"],
                           TM.init_params(tc, 8, device="cpu")["embed"]["head"])


def test_parameters_must_live_on_the_named_device():
    tc = t_config("minicpm-2b", smoke=True)
    tp = TM.init_params(tc, 0, device="cpu")
    with pytest.raises(ValueError):
        TM.forward(tc, tp, torch.zeros((1, 2), dtype=torch.int64), device="meta")


@pytest.mark.parametrize("valid", [37, "per_lane"])
@pytest.mark.parametrize("causal,sq,q_offset", [(False, 1, 0), (True, 4, 60)])
def test_blockwise_attention_matches_reference(rng, valid, causal, sq, q_offset):
    from repro.models.attention import blockwise_attention as j_blockwise
    from repro_torch.models.attention import blockwise_attention as t_blockwise

    b, hq, hkv, skv, d = 2, 4, 2, 70, 16
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    lens = np.array([37, 64], np.int32) if valid == "per_lane" else valid
    want = j_blockwise(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                       q_offset=q_offset, kv_valid_len=jnp.asarray(lens), block_kv=16)
    got = t_blockwise(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                      causal=causal, q_offset=q_offset, block_kv=16,
                      kv_valid_len=torch.as_tensor(lens) if valid == "per_lane" else lens)
    _close(got, want, 2e-5)
