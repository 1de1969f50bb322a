"""The port's serve paths on the other model families against the JAX
package's, on the CPU.

The six attention-only configs of ``tests/test_torch_families.py`` in their
float32 smoke cuts (the JAX init's weights carried over): greedy
``generate`` gives the JAX package's token ids (the prompt prefilled in
one chunk), and the continuous-batching engine's packed lanes give the JAX
engine's tokens and their own batch-1 ``generate`` tokens, at per-lane
positions (musicgen's sinusoidal embedding and qwen2-vl's M-RoPE taken per
lane).
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
from repro.launch.engine import ServeEngine as JEngine
from repro.models import model as JM
from repro_torch.configs import get_config as t_config
from repro_torch.core.bsp import BSPAccelerator as TPack
from repro_torch.launch import serve as tserve
from repro_torch.launch.engine import ServeEngine
from repro_torch.models import model as TM

FAMILIES = ["starcoder2-15b", "qwen2-moe-a2.7b", "moonshot-v1-16b-a3b", "musicgen-large",
            "qwen2-vl-7b", "nemotron-4-340b"]
# the JAX engine tests' fixed pack: no calibration in tests
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


@pytest.fixture(scope="module", params=FAMILIES)
def models(request):
    name = request.param
    jc = dataclasses.replace(j_config(name, smoke=True), dtype="float32")
    tc = dataclasses.replace(t_config(name, smoke=True), dtype="float32")
    jp = JM.init_params(jc, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), jp)
    return jc, tc, jp, TM.params_from_numpy(tc, tree, device="cpu")


def test_greedy_generate_matches_reference(models):
    jc, tc, jp, tp = models
    prompt = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 9)).astype(np.int32)
    assert tserve.prefill_block_size(tc, 2, 9, TPack(**PACK)) > 1
    want, _ = jserve.generate(jc, jp, jnp.asarray(prompt), steps=6, machine=JPack(**PACK))
    got, _ = tserve.generate(tc, tp, prompt, steps=6, machine=TPack(**PACK), device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_engine_matches_the_reference_engine_and_generate(models):
    """Three requests of mixed prompt lengths over four lanes: each lane
    gives the JAX engine's tokens and its batch-1 ``generate`` tokens."""
    jc, tc, jp, tp = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jc.vocab_size, size=s).astype(np.int32) for s in (5, 9, 13)]
    jeng = JEngine(jc, jp, max_lanes=4, pool_seq=48, segment_len=4, machine=JPack(**PACK),
                   calibstore=False)
    eng = ServeEngine(tc, tp, max_lanes=4, pool_seq=48, segment_len=4, machine=TPack(**PACK),
                      calibstore=False, device="cpu")
    for e in (jeng, eng):
        for p in prompts:
            e.submit(p, 6)
    want, got = jeng.run_until_drained(), eng.run_until_drained()
    assert sorted(got) == sorted(want)
    for rid, p in enumerate(prompts):
        np.testing.assert_array_equal(got[rid], want[rid], err_msg=f"rid {rid}")
        alone, _ = tserve.generate(tc, tp, p[None], steps=6, machine=TPack(**PACK),
                                   max_len=48, device="cpu")
        np.testing.assert_array_equal(got[rid], alone[0].numpy(), err_msg=f"rid {rid}")
