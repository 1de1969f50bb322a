"""The port's serve path against the JAX package's, on the CPU.

Greedy ``generate`` gives the JAX package's token ids in both execution
modes, with the same explicit machine pack handed to both so that the
autotuned prefill block agrees; chunked prefill equals token-at-a-time; the
predicted-vs-measured rows price the same plans. jamba-v0.1-52b's hybrid
stack serves token-at-a-time, as the reference does.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.core.bsp import BSPAccelerator as JPack
from repro.launch import serve as jserve
from repro.models import model as JM
from repro_torch.configs import get_config as t_config
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.launch import serve as tserve
from repro_torch.launch.registry import Registry
from repro_torch.models import model as TM

# a fixed pack (the JAX engine tests' own): no calibration in tests
PACK = dict(p=1, g=0.0, l=1e5, r=1e9, e=0.25, L=(1 << 25) // 4, E=(1 << 34) // 4,
            word_bytes=4, name="test-host")


@pytest.fixture(scope="module")
def models():
    jc = dataclasses.replace(j_config("minicpm-2b", smoke=True), dtype="float32")
    tc = dataclasses.replace(t_config("minicpm-2b", smoke=True), dtype="float32")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jc, tc, jp, TM.params_from_numpy(tc, tree, device="cpu")


@pytest.mark.parametrize("compiled", [True, False])
def test_greedy_generate_matches_reference(models, compiled):
    jc, tc, jp, tp = models
    prompt = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 9)).astype(np.int32)
    want, jstats = jserve.generate(jc, jp, jnp.asarray(prompt), steps=6,
                                   machine=JPack(**PACK), compiled=compiled)
    got, tstats = tserve.generate(tc, tp, prompt, steps=6, machine=TPack(**PACK),
                                  compiled=compiled, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tstats.compiled == compiled
    assert len(tstats.decode_seconds) == (1 if compiled else 6)
    # same plan, same pack, same barrier count: the same prediction
    assert tstats.plan_row["predicted_seconds"] == pytest.approx(
        jstats.plan_row["predicted_seconds"], rel=1e-12)
    assert (tstats.plan_row["bandwidth_heavy_predicted"]
            == jstats.plan_row["bandwidth_heavy_predicted"])


@pytest.mark.parametrize("compiled", [True, False])
def test_predicted_vs_measured_words_agree(models, compiled):
    _, tc, _, tp = models
    prompt = torch.zeros((2, 4), dtype=torch.int32)
    _, stats = tserve.generate(tc, tp, prompt, steps=5, machine=TPack(**PACK),
                               compiled=compiled, device="cpu")
    row = stats.plan_row
    assert row["fetch_words_planned"] == row["fetch_words_measured"]
    assert row["measured_seconds"] > 0
    assert sum(r.writeback_words for r in stats.records) == 5 * 2


def test_compiled_runner_is_reused(models):
    _, tc, _, tp = models
    prompt = torch.ones((1, 3), dtype=torch.int32)
    a, _ = tserve.generate(tc, tp, prompt, steps=4, machine=TPack(**PACK), device="cpu")
    builds = tserve.decode_runners.builds
    b, _ = tserve.generate(tc, tp, prompt, steps=4, machine=TPack(**PACK), device="cpu")
    assert tserve.decode_runners.builds == builds
    assert torch.equal(a, b)


def test_chunked_prefill_equals_token_at_a_time(models):
    _, tc, _, tp = models
    prompt = torch.as_tensor(
        np.random.default_rng(2).integers(0, tc.vocab_size, (2, 11)).astype(np.int32))
    outs = []
    for block in (1, 4, 11):
        cache = TM.init_cache(tc, 2, 16, device="cpu")
        logits, cache = tserve.make_prefill(tc, block, device="cpu")(tp, cache, prompt)
        assert cache["len"] == 11 and logits.shape[1] == 1
        outs.append((logits, cache))
    for logits, cache in outs[1:]:
        torch.testing.assert_close(logits, outs[0][0], rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(cache["layers"][1][0]["k"],
                                   outs[0][1]["layers"][1][0]["k"], rtol=1e-5, atol=1e-5)


def test_chunked_prefill_matches_reference(models):
    jc, tc, jp, tp = models
    prompt = np.random.default_rng(3).integers(0, jc.vocab_size, (2, 10)).astype(np.int32)
    want, _ = jserve.make_prefill(jc, 4)(jp, JM.init_cache(jc, 2, 12), jnp.asarray(prompt))
    got, _ = tserve.make_prefill(tc, 4, device="cpu")(
        tp, TM.init_cache(tc, 2, 12, device="cpu"), torch.as_tensor(prompt))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


@pytest.mark.parametrize("batch,prompt_len", [(1, 1), (2, 9), (4, 64), (8, 200)])
@pytest.mark.parametrize("l", [1e3, 1e5, 1e8])
def test_prefill_block_size_matches_reference(batch, prompt_len, l):
    jc, tc = j_config("minicpm-2b", smoke=True), t_config("minicpm-2b", smoke=True)
    kw = dict(PACK, l=l)
    assert (tserve.prefill_block_size(tc, batch, prompt_len, TPack(**kw))
            == jserve.prefill_block_size(jc, batch, prompt_len, JPack(**kw)))


def test_prefill_step_matches_reference_forward(models):
    from repro.train.steps import make_prefill_step as j_step
    from repro_torch.train.steps import make_prefill_step as t_step

    jc, tc, jp, tp = models
    toks = np.random.default_rng(4).integers(0, jc.vocab_size, (2, 7)).astype(np.int32)
    want = j_step(jc)(jp, {"tokens": jnp.asarray(toks)})
    got = t_step(tc, device="cpu")(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_sampling_is_seeded(models):
    _, tc, _, tp = models
    prompt = torch.zeros((2, 3), dtype=torch.int32)
    run = lambda seed: tserve.generate(tc, tp, prompt, steps=5, temperature=1.0, seed=seed,
                                       machine=TPack(**PACK), device="cpu")[0]
    assert torch.equal(run(5), run(5))


def test_registry_pins_entries_under_concurrency():
    reg = Registry(capacity=2)
    built = []

    def worker(key):
        with reg.acquire(key, lambda: built.append(key) or key) as entry:
            with entry.lock:
                assert entry.value == key

    threads = [threading.Thread(target=worker, args=(k % 3,)) for k in range(12)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert len(reg) <= 2 and reg.builds == len(built) >= 3


# -- the hybrid stack ------------------------------------------------------------------


@pytest.fixture(scope="module")
def jamba():
    name = "jamba-v0.1-52b"
    jc = dataclasses.replace(j_config(name, smoke=True), dtype="float32")
    tc = dataclasses.replace(t_config(name, smoke=True), dtype="float32")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jc, tc, jp, TM.params_from_numpy(tc, tree, device="cpu")


@pytest.mark.parametrize("compiled", [True, False])
def test_hybrid_greedy_generate_matches_reference(jamba, compiled):
    jc, tc, jp, tp = jamba
    prompt = np.random.default_rng(5).integers(0, jc.vocab_size, (2, 7)).astype(np.int32)
    want, jstats = jserve.generate(jc, jp, jnp.asarray(prompt), steps=6,
                                   machine=JPack(**PACK), compiled=compiled)
    got, tstats = tserve.generate(tc, tp, prompt, steps=6, machine=TPack(**PACK),
                                  compiled=compiled, device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the serve plan's cache scratch is the hybrid cache: the same price
    assert tstats.plan_row["predicted_seconds"] == pytest.approx(
        jstats.plan_row["predicted_seconds"], rel=1e-12)


def test_recurrent_stacks_prefill_token_at_a_time(jamba):
    jc, tc, jp, tp = jamba
    for l in (1e3, 1e8):
        kw = dict(PACK, l=l)
        assert tserve.prefill_block_size(tc, 2, 64, TPack(**kw)) == 1
        assert jserve.prefill_block_size(jc, 2, 64, JPack(**kw)) == 1
    with pytest.raises(ValueError, match="recurrent"):
        jserve.make_prefill(jc, 2)
    with pytest.raises(ValueError, match="recurrent"):
        tserve.make_prefill(tc, 2, device="cpu")
    prompt = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 5)).astype(np.int32)
    want, _ = jserve.make_prefill(jc, 1)(jp, JM.init_cache(jc, 2, 8), jnp.asarray(prompt))
    got, cache = tserve.make_prefill(tc, 1, device="cpu")(
        tp, TM.init_cache(tc, 2, 8, device="cpu"), torch.as_tensor(prompt))
    assert cache["len"] == 5
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)


def test_hybrid_prefill_step_matches_reference_forward(jamba):
    from repro.train.steps import make_prefill_step as j_step
    from repro_torch.train.steps import make_prefill_step as t_step

    jc, tc, jp, tp = jamba
    toks = np.random.default_rng(7).integers(0, jc.vocab_size, (2, 9)).astype(np.int32)
    want = j_step(jc)(jp, {"tokens": jnp.asarray(toks)})
    got = t_step(tc, device="cpu")(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-4)
