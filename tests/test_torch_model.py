"""The port's decoders against the JAX package's, on the CPU.

minicpm-2b (tied head) and codeqwen1.5-7b (untied head, through the matmul
wrapper) smoke configs, and jamba-v0.1-52b's hybrid of Mamba, MoE and
attention, in float32; the JAX init's weights carried over with
``params_from_numpy``. Forward and decode logits agree within 1e-4; the
Mamba and MoE layers alone within 1e-5 (fp32 sums in another order).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import list_configs as j_list_configs
from repro.models import model as JM
from repro_torch.configs import card_config
from repro_torch.configs import get_config as t_config
from repro_torch.configs import list_configs as t_list_configs
from repro_torch.models import model as TM

ATOL = 1e-4
ARCHS = ["minicpm-2b", "codeqwen1.5-7b"]
JAMBA = "jamba-v0.1-52b"
#: the configs of tests/test_torch_xlstm.py and tests/test_torch_families.py
OTHERS = ["xlstm-1.3b", "starcoder2-15b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b",
          "musicgen-large", "qwen2-vl-7b", "nemotron-4-340b"]


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
    assert set(ARCHS + [JAMBA] + OTHERS) == set(t_list_configs()) == set(j_list_configs())
    for name in t_list_configs():
        for smoke in (False, True):
            assert (dataclasses.asdict(t_config(name, smoke=smoke))
                    == dataclasses.asdict(j_config(name, smoke=smoke)))


@pytest.mark.parametrize("name", ARCHS + [JAMBA] + OTHERS)
def test_card_config_fits_one_card(name):
    """The published widths at a depth whose bf16 weights fit one 80 GB card:
    the full depth where it fits, else whole periods of the pattern."""
    full, card = j_config(name), card_config(name)
    assert dataclasses.asdict(card) == dataclasses.asdict(
        dataclasses.replace(full, num_layers=card.num_layers))
    assert card.num_layers % len(card.pattern) == 0
    assert 2 * TM.count_params(card) < 80e9
    if card.num_layers < full.num_layers:
        assert 2 * TM.count_params(t_config(name)) > 80e9


@pytest.mark.parametrize("name", ARCHS + OTHERS)
def test_count_params_from_the_config(name):
    """The count from the config equals the JAX package's ``count_params``
    on every smoke config and on every full one whose leaves it can count:
    it multiplies each shape in int32, which nemotron-4-340b's (256000,
    18432) embedding and head overflow. The full count is also the JAX
    tree's leaf count taken in Python integers (``abstract_params``)."""
    for smoke in (False, True):
        jc, tc = j_config(name, smoke=smoke), t_config(name, smoke=smoke)
        shapes = [x.shape for x in jax.tree_util.tree_leaves(JM.abstract_params(jc))]
        assert TM.count_params(tc) == sum(math.prod(s) for s in shapes)
        if smoke or max(math.prod(s) for s in shapes) < 2**31:
            assert TM.count_params(tc) == JM.count_params(jc)
    if name == "nemotron-4-340b":
        assert TM.count_params(t_config(name)) == 341_029_195_776


def test_forward_logits(models, rng):
    jc, tc, jp, tp = models
    toks = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    want, jaux = JM.forward(jc, jp, jnp.asarray(toks))
    got, aux = TM.forward(tc, tp, torch.as_tensor(toks), device="cpu")
    _close(got, want)
    assert aux.dtype == torch.float32 and float(aux) == float(jaux) == 0.0


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
    _close(TM.forward(tc, tp, torch.as_tensor(toks), device="cpu")[0], want)


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
    got = TM.forward(tc, tp, toks, device="cpu")[0]
    assert got.dtype == torch.bfloat16 and torch.isfinite(got.float()).all()
    t32 = dataclasses.replace(tc, dtype="float32")
    p32 = jax.tree_util.tree_map(lambda t: t.float(), tp)
    want = TM.forward(t32, p32, toks, device="cpu")[0]
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


@pytest.mark.parametrize("chunk", [8192, 16])
@pytest.mark.parametrize("valid", [37, "per_lane"])
@pytest.mark.parametrize("sq,q_offset", [(1, 0), (4, 60)])
def test_dense_cache_attention_matches_reference(rng, monkeypatch, chunk, valid, sq,
                                                 q_offset):
    """The decode cache read, in one chunk of positions or in several (the
    last one partial), against the JAX package's."""
    from repro.models.attention import dense_cache_attention as j_dense
    from repro_torch.models import attention as tattn

    monkeypatch.setattr(tattn, "DECODE_CHUNK", chunk)
    b, hq, hkv, skv, d = 2, 4, 2, 70, 16
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, skv, d)).astype(np.float32)
    lens = np.array([37, 64], np.int32) if valid == "per_lane" else valid
    want = j_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   kv_valid_len=jnp.asarray(lens), q_offset=q_offset)
    got = tattn.dense_cache_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v), q_offset=q_offset,
        kv_valid_len=torch.as_tensor(lens) if valid == "per_lane" else lens)
    _close(got, want, 2e-5)


# -- the hybrid stack: Mamba, MoE, attention -------------------------------------------


def _tensors(tree):
    return jax.tree_util.tree_map(lambda a: torch.as_tensor(np.asarray(a, np.float32)), tree)


@pytest.fixture(scope="module")
def jamba():
    return _pair(JAMBA)


def test_count_params_hybrid():
    """The hybrid count from the config equals the JAX parameter tree's leaf
    count. For the full config that count is taken over ``abstract_params``
    with Python integers: ``JM.count_params`` multiplies each shape in int32,
    and the period-stacked expert weights (4 × 16 × 4096 × 14336) overflow
    it."""
    full = j_config(JAMBA)
    leaves = jax.tree_util.tree_leaves(JM.abstract_params(full))
    assert TM.count_params(t_config(JAMBA)) == sum(math.prod(x.shape) for x in leaves)
    assert TM.count_params(t_config(JAMBA)) == 51_570_315_264
    assert TM.count_params(t_config(JAMBA, smoke=True)) == \
        JM.count_params(j_config(JAMBA, smoke=True))


@pytest.mark.parametrize("name", ARCHS + [JAMBA] + OTHERS)
@pytest.mark.parametrize("smoke", [False, True])
def test_cache_bytes_match_the_reference_cache(name, smoke):
    """The serve plans' cache scratch: the bytes of the JAX ``init_cache``
    tree (K/V per attention layer; conv window and fp32 state per Mamba
    layer; fp32 states per xLSTM layer; the int32 length)."""
    jc, tc = j_config(name, smoke=smoke), t_config(name, smoke=smoke)
    shapes = jax.eval_shape(lambda: JM.init_cache(jc, 3, 40))
    want = sum(math.prod(x.shape) * jnp.dtype(x.dtype).itemsize
               for x in jax.tree_util.tree_leaves(shapes))
    assert TM.cache_bytes(tc, 3, 40) == want


def test_bf16_hybrid_params_keep_the_jax_dtypes():
    """params_from_numpy gives each leaf the JAX init's dtype: the MoE
    router stays float32 in a bfloat16 model."""
    jc, tc = j_config(JAMBA, smoke=True), t_config(JAMBA, smoke=True)
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tp = TM.params_from_numpy(tc, _numpy_tree(jp), device="cpu")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    tl = jax.tree_util.tree_leaves_with_path(tp)
    assert len(jl) == len(tl)
    dtypes = {jnp.dtype("float32"): torch.float32, jnp.dtype("bfloat16"): torch.bfloat16}
    for (jpath, j), (_, t) in zip(jl, tl):
        assert t.dtype == dtypes[j.dtype], jax.tree_util.keystr(jpath)
        assert tuple(t.shape) == j.shape
    assert tp["stack"][0][1]["mlp"]["router"].dtype == torch.float32
    assert TM.init_params(tc, 0, device="cpu")["stack"][0][1]["mlp"]["router"].dtype \
        == torch.float32


def _mixer(models, j):
    """The configs and period position j's mixer params (JAX, port)."""
    jc, tc, jp, tp = models
    return jc, tc, jp["stack"][0][j]["mixer"], tp["stack"][0][j]["mixer"]


@pytest.mark.parametrize("impl", ["auto", "kernel", "chunked", "oracle"])
def test_mamba_forward_matches_reference(jamba, rng, impl):
    from repro.models import mamba as jmb
    from repro_torch.models import mamba as tmb

    jc, tc, jpm, tpm = _mixer(jamba, 0)
    x = rng.standard_normal((2, 12, jc.d_model)).astype(np.float32)
    want = jmb.mamba_forward(jc, jpm, jnp.asarray(x), impl=impl)
    _close(tmb.mamba_forward(tc, tpm, torch.as_tensor(x), impl=impl), want, 1e-5)


def test_mamba_decode_matches_reference(jamba, rng):
    from repro.models import mamba as jmb
    from repro_torch.models import mamba as tmb

    jc, tc, jpm, tpm = _mixer(jamba, 0)
    x = rng.standard_normal((2, 10, jc.d_model)).astype(np.float32)
    jcache = jmb.init_mamba_cache(jc, 2, jnp.float32)
    tcache = tmb.init_mamba_cache(tc, 2, torch.float32, "cpu")
    assert tcache["h"].dtype == torch.float32
    for t in range(10):
        jy, jcache = jmb.mamba_decode(jc, jpm, jnp.asarray(x[:, t:t + 1]), jcache)
        ty, tcache = tmb.mamba_decode(tc, tpm, torch.as_tensor(x[:, t:t + 1]), tcache)
        _close(ty, jy, 1e-5)
    _close(tcache["h"], jcache["h"], 1e-5)
    _close(tcache["conv"], jcache["conv"], 1e-5)
    # ten decode steps are the full-sequence mixer's last ten positions
    _close(ty[:, 0], jmb.mamba_forward(jc, jpm, jnp.asarray(x), impl="oracle")[:, -1], 1e-5)


@pytest.mark.parametrize("seq,chunk", [(64, 16), (100, 32)])
def test_chunked_selective_scan_matches_reference(rng, seq, chunk):
    from repro.models.mamba import chunked_selective_scan as j_chunked
    from repro_torch.models.mamba import chunked_selective_scan as t_chunked

    b, di, ds = 2, 8, 4
    x = rng.standard_normal((b, seq, di)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, seq, di))).astype(np.float32) * 0.2
    bb, c = (rng.standard_normal((b, seq, ds)).astype(np.float32) for _ in range(2))
    a = (-np.abs(rng.standard_normal((di, ds))) - 0.1).astype(np.float32)
    d = rng.standard_normal((di,)).astype(np.float32)
    h0 = rng.standard_normal((b, di, ds)).astype(np.float32)
    args = (x, dt, bb, c, a, d)
    jy, jh = j_chunked(*map(jnp.asarray, args), chunk=chunk, h0=jnp.asarray(h0))
    ty, th = t_chunked(*map(torch.as_tensor, args), chunk=chunk, h0=torch.as_tensor(h0))
    _close(ty, jy, 1e-5)
    _close(th, jh, 1e-5)


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_forward_matches_reference(rng, cf):
    """Sort-based dispatch with the reference's drops: at capacity factor
    1.25 some (token, expert) pairs overflow and are dropped, at 8.0 none."""
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    jc, tc, jp, tp = _pair(JAMBA, moe_capacity_factor=cf)
    jpm, tpm = jp["stack"][0][1]["mlp"], tp["stack"][0][1]["mlp"]
    # a shared component skews the routing, so the favourite experts overflow
    x = rng.standard_normal((2, 12, jc.d_model)).astype(np.float32)
    x += 2.0 * rng.standard_normal(jc.d_model).astype(np.float32)
    jy, jaux = jmoe.moe_forward(jc, jpm, jnp.asarray(x))
    ty, taux = tmoe.moe_forward(tc, tpm, torch.as_tensor(x))
    _close(ty, jy, 1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    dense, _ = jmoe.moe_forward_dense(jc, jpm, jnp.asarray(x))
    dropped = np.abs(np.asarray(jy) - np.asarray(dense)).max() > 1e-3
    assert dropped == (cf == 1.25)


@pytest.mark.parametrize("shared", [0, 1])
def test_moe_forward_dense_matches_reference(rng, shared):
    from repro.models import moe as jmoe
    from repro_torch.models import moe as tmoe

    jc, tc, jp, tp = _pair(JAMBA, moe_shared_experts=shared)
    jpm, tpm = jp["stack"][0][1]["mlp"], tp["stack"][0][1]["mlp"]
    x = rng.standard_normal((1, 9, jc.d_model)).astype(np.float32)
    jy, jaux = jmoe.moe_forward_dense(jc, jpm, jnp.asarray(x))
    ty, taux = tmoe.moe_forward_dense(tc, tpm, torch.as_tensor(x))
    _close(ty, jy, 1e-5)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-6)
    jy, _ = jmoe.moe_forward(jc, jpm, jnp.asarray(x))
    _close(tmoe.moe_forward(tc, tpm, torch.as_tensor(x))[0], jy, 1e-5)


def test_route_hook_records_and_replays(rng):
    """``moe.route_hook``: a hook that returns the router's own ids changes
    no bit; one that returns other ids routes every token to them, at their
    probabilities, in the dispatch and in the dense oracle alike."""
    from repro_torch.models import moe as tmoe

    _, tc, _, tp = _pair(JAMBA, moe_capacity_factor=8.0)
    tpm = tp["stack"][0][1]["mlp"]
    x = torch.as_tensor(rng.standard_normal((2, 12, tc.d_model)).astype(np.float32))
    want, want_aux = tmoe.moe_forward(tc, tpm, x)
    seen = []
    with tmoe.route_hook(lambda probs, top_e: seen.append(top_e) or top_e):
        got, aux = tmoe.moe_forward(tc, tpm, x)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    assert len(seen) == 1 and tuple(seen[0].shape) == (24, tc.moe_top_k)
    other = (seen[0] + 1) % tc.moe_experts
    with tmoe.route_hook(lambda probs, top_e: other):
        moved, _ = tmoe.moe_forward(tc, tpm, x)
        oracle, _ = tmoe.moe_forward_dense(tc, tpm, x)
    _close(moved, oracle.detach().numpy(), 1e-5)
    assert (moved - want).abs().max() > 1e-3
    assert tmoe._route_hook is None


def test_hybrid_forward_logits(jamba, rng):
    jc, tc, jp, tp = jamba
    toks = rng.integers(0, jc.vocab_size, (2, 12)).astype(np.int32)
    want, jaux = JM.forward(jc, jp, jnp.asarray(toks))
    got, aux = TM.forward(tc, tp, torch.as_tensor(toks), device="cpu")
    _close(got, want)
    # the MoE layers' load-balancing losses, summed over the stack in fp32
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)


def test_hybrid_decode_steps(jamba, rng):
    """Ten single-token steps through the Mamba, MoE and attention caches."""
    jc, tc, jp, tp = jamba
    toks = rng.integers(0, jc.vocab_size, (2, 10)).astype(np.int32)
    jcache, tcache = JM.init_cache(jc, 2, 10), TM.init_cache(tc, 2, 10, device="cpu")
    for t in range(10):
        jl, jcache = JM.decode_step(jc, jp, jcache, jnp.asarray(toks[:, t:t + 1]))
        tl, tcache = TM.decode_step(tc, tp, tcache, torch.as_tensor(toks[:, t:t + 1]),
                                    device="cpu")
        _close(tl, jl)
    assert tcache["len"] == int(jcache["len"]) == 10
    for j in range(len(jc.pattern)):
        jblk, tblk = jcache["layers"][0][j], tcache["layers"][0][j]
        assert sorted(jblk) == sorted(tblk)
        for key in jblk:
            _close(tblk[key], jblk[key])


def test_multi_token_decode_needs_an_attention_only_stack(jamba):
    jc, tc, jp, tp = jamba
    toks = np.zeros((1, 2), np.int32)
    with pytest.raises(ValueError, match="recurrent"):
        JM.decode_step(jc, jp, JM.init_cache(jc, 1, 4), jnp.asarray(toks))
    with pytest.raises(ValueError, match="recurrent"):
        TM.decode_step(tc, tp, TM.init_cache(tc, 1, 4, device="cpu"),
                       torch.as_tensor(toks), device="cpu")
